"""Game-piece detector inference engine (ModelInference equivalent).

The port of ros_vision_tpu/models/infer.py. Mirrors the reference's
ModelInference + GamePieceDetector pipeline (ModelInference.h:31-186;
game_piece_detection_node.cu:347-380 preprocess; yolo_detection.h
postprocess): resize + BGR->RGB + /255 preprocessing, the YOLOv11 forward
(bf16 on the card by default) and fixed-shape on-device NMS. Weights load
from the JAX package's .npz format (flattened "/" keys), so both packages
read the same file, or from a torch state-dict checkpoint.

detect_packed() is the cv2-free call of a robot's cameras: their frames
staged in pinned memory and copied without blocking, preprocess_device,
the forward and the NMS on the device, the kept boxes scaled back to the
frames' pixels there, and one packed (B, K, 7) f32 result that the host
reads once: unpack_detections, after fetch() has started its copy to
pinned memory behind an event (PendingDetections). The call makes no host
read and no upload between the copy in and the result read (a card test,
benchmark/tests/test_gamepiece.py, runs it under
torch.cuda.set_sync_debug_mode("error")); it records a `gamepiece` call in
utils/tracing.RECORDER with its spans.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ros_vision_tpu_torch.device import require_cuda
from ros_vision_tpu_torch.models import yolo
from ros_vision_tpu_torch.ops import nms
from ros_vision_tpu_torch.utils.tracing import Call, Span


@dataclasses.dataclass
class GamePieceDetection:
    x: float      # center x, original-image pixels
    y: float
    w: float
    h: float
    conf: float
    cls: int
    class_name: str


def pack_detections(out: dict, sx: float, sy: float) -> torch.Tensor:
    """parse_and_nms's outputs -> one (B, K, 7) f32 tensor, a row a slot:
    x, y, w, h (the box scaled by the Python floats sx, sy: no upload),
    confidence, class, and 1.0 where the slot holds a kept detection."""
    b = out["boxes"]
    f32 = torch.float32
    return torch.stack([b[..., 0] * sx, b[..., 1] * sy, b[..., 2] * sx,
                        b[..., 3] * sy, out["scores"],
                        out["classes"].to(f32), out["valid"].to(f32)], -1)


class PendingDetections:
    """A packed result on its way to the host: the pinned host tensor a
    non-blocking copy writes and the event recorded after the copy."""

    def __init__(self, host: torch.Tensor, event):
        self.host = host
        self.event = event

    def wait(self) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()
        return self.host


def fetch(packed: torch.Tensor) -> PendingDetections:
    """Start the copy of a packed result to the host: pinned memory and an
    event behind it on a CUDA device, the tensor itself on the CPU."""
    if packed.device.type != "cuda":
        return PendingDetections(packed, None)
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(packed.device))
    return PendingDetections(host, event)


def unpack_detections(packed, class_names=()) -> list:
    """A packed result (tensor or PendingDetections) -> one list of
    GamePieceDetection per row, in slot order (confidence descending)."""
    if isinstance(packed, PendingDetections):
        packed = packed.wait()
    rows = []
    for row in packed.cpu().numpy():
        dets = []
        for x, y, w, h, conf, c, valid in row.tolist():
            if valid > 0.5:
                c = int(c)
                dets.append(GamePieceDetection(
                    x, y, w, h, conf, c, class_names[c]
                    if c < len(class_names) else "unknown"))
        rows.append(dets)
    return rows


class ModelInference:
    """YOLO inference with the reference's tensor semantics.

    infer() is the analogue of ModelInference::infer (H2D copy, enqueueV3,
    D2H, sync — ModelInference.h:113-140): the model input to `device`, the
    forward and NMS there, the fixed-shape outputs left on the device.
    `self.model` holds the f32 weights (what save_params writes); the
    forward runs a copy whose convolutions compute in `dtype`, as the JAX
    engine casts its f32 params at apply. `device` None is the first CUDA
    card (raising without one); the CPU only when asked for.
    """

    def __init__(self, num_classes: int = 1, scale: str = "n",
                 img_size: int = 640, class_names=None,
                 params_path: str | None = None, dtype=torch.bfloat16,
                 max_detections: int = 100, device=None):
        self.img_size = img_size
        self.num_classes = num_classes
        self.class_names = list(class_names or [])
        self.dtype = dtype
        self.device = require_cuda() if device is None \
            else torch.device(device)
        self.max_detections = max_detections
        model = yolo.YOLOv11(num_classes=num_classes, scale=scale).eval()
        yolo.init_weights(model, torch.Generator().manual_seed(0))
        self.model = model.to(self.device)
        self._refresh()
        if params_path:
            self.load_params(params_path)

    def _refresh(self):
        """Rebuild the compute-dtype copy after the f32 weights changed."""
        self._net = self.model if self.dtype == torch.float32 else \
            copy.deepcopy(self.model).set_compute_dtype(self.dtype)

    # semantic dims from model config (ModelInference.h:148-156)
    @property
    def input_shape(self):
        return (1, self.img_size, self.img_size, 3)

    @property
    def output_shape(self):
        a = sum((self.img_size // s) ** 2 for s in yolo.STRIDES)
        return (1, 4 + self.num_classes, a)

    def save_checkpoint(self, path: str):
        """torch state-dict checkpoint (the torch-ecosystem persistence
        path; .npz remains the portable format)."""
        torch.save(self.model.state_dict(), path)

    def load_checkpoint(self, path: str):
        self.model.load_state_dict(torch.load(path, map_location=self.device,
                                              weights_only=True))
        self._refresh()

    def load_params(self, path: str):
        """The JAX package's .npz weights (flattened "/" keys)."""
        with np.load(path) as flat:
            yolo.from_flax(self.model, dict(flat))
        self._refresh()

    def save_params(self, path: str):
        np.savez(path, **yolo.to_flax(self.model))

    def preprocess(self, bgr: np.ndarray) -> np.ndarray:
        """BGR HWC uint8 -> RGB float [0,1] resized to model input
        (preprocess_image, game_piece_detection_node.cu:347-380), NHWC,
        on the host with cv2."""
        import cv2
        img = cv2.resize(bgr, (self.img_size, self.img_size))
        img = img[..., ::-1].astype(np.float32) / 255.0
        return img[None]

    def preprocess_device(self, bgr_batch) -> torch.Tensor:
        """Device-side preprocessing: BGR->RGB, /255 and an antialiased
        bilinear resize (jax.image.resize's, which antialiases when it
        downsamples) on `device`. bgr_batch (B, H, W, 3) or (H, W, 3)
        uint8 -> (B, S, S, 3) f32."""
        x = torch.as_tensor(bgr_batch).to(self.device)
        if x.ndim == 3:
            x = x[None]
        x = x.flip(-1).to(torch.float32) / 255.0
        x = F.interpolate(x.permute(0, 3, 1, 2),
                          size=(self.img_size, self.img_size),
                          mode="bilinear", align_corners=False,
                          antialias=True)
        return x.permute(0, 2, 3, 1)

    @torch.inference_mode()
    def forward(self, image_input) -> torch.Tensor:
        """Raw (B, 4+nc, A) f32 model output for a (B, S, S, 3) input."""
        x = torch.as_tensor(image_input).to(self.device)
        return self._net(x.permute(0, 3, 1, 2).to(self.dtype))

    @torch.inference_mode()
    def infer(self, image_input) -> dict:
        """Fixed-shape NMS outputs (boxes, scores, classes, valid) on the
        device for a preprocessed (B, S, S, 3) input."""
        return nms.parse_and_nms(self.forward(image_input),
                                 self.max_detections)

    def detections(self, out: dict, orig_wh, row: int = 0) -> list:
        """Row `row` of infer()'s outputs as GamePieceDetections scaled back
        to an original frame of orig_wh = (w, h) pixels."""
        out = {k: v[row].cpu().numpy() for k, v in out.items()}
        sx = orig_wh[0] / self.img_size
        sy = orig_wh[1] / self.img_size
        dets = []
        for i in np.nonzero(out["valid"])[0]:
            b = out["boxes"][i]
            c = int(out["classes"][i])
            name = self.class_names[c] if c < len(self.class_names) \
                else "unknown"
            dets.append(GamePieceDetection(
                float(b[0] * sx), float(b[1] * sy), float(b[2] * sx),
                float(b[3] * sy), float(out["scores"][i]), c, name))
        return dets

    def stage(self, bgr_batch) -> torch.Tensor:
        """(B, H, W, 3) uint8 frames on the device: host frames staged in
        pinned memory, then copied without blocking, as VisionNode.upload
        stages them. numpy copies them into the pinned buffer on the
        calling thread (a torch copy of a frame batch's megabytes wakes
        every intra-op thread at each call). A tensor already on the
        device, or already pinned, is taken as it is."""
        if isinstance(bgr_batch, torch.Tensor) and (
                bgr_batch.device == self.device or bgr_batch.is_pinned()):
            return bgr_batch.to(self.device, non_blocking=True)
        frames = np.asarray(bgr_batch)
        if self.device.type != "cuda":
            return torch.from_numpy(np.ascontiguousarray(frames))
        host = torch.empty(frames.shape, dtype=torch.uint8, pin_memory=True)
        np.copyto(host.numpy(), frames)
        return host.to(self.device, non_blocking=True)

    @torch.inference_mode()
    def detect_packed(self, bgr_batch, with_raw: bool = False):
        """One call on (B, H, W, 3) uint8 BGR frames: stage,
        preprocess_device, forward, parse_and_nms and the boxes scaled to
        the frames' pixels, all on the device -> the packed (B, K, 7) f32
        result (and the raw (B, 4 + nc, A) head output with `with_raw`)."""
        with Call(None, "gamepiece"):
            x = self.stage(bgr_batch)
            h, w = x.shape[1:3]
            with Span("gamepiece.preprocess"):
                x = self.preprocess_device(x)
            with Span("gamepiece.forward"):
                raw = self.forward(x)
            with Span("gamepiece.nms"):
                packed = pack_detections(
                    nms.parse_and_nms(raw, self.max_detections),
                    w / self.img_size, h / self.img_size)
        return (packed, raw) if with_raw else packed

    def detect(self, bgr: np.ndarray,
               conf_threshold: float = nms.CONF_THRESHOLD) -> list:
        """Full path: preprocess -> infer -> NMS -> scale back
        (detection_test flow). The NMS applies nms.CONF_THRESHOLD whatever
        `conf_threshold` says, as the JAX engine's does."""
        h, w = bgr.shape[:2]
        return self.detections(self.infer(self.preprocess(bgr)), (w, h))

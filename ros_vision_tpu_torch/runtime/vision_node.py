"""TorchVisionNode: the vision node with CUDA-side frame staging.

Subclass of ros_vision_tpu/runtime/vision_node.py VisionNode (which is
jax-free; only its upload/submit used jax.device_put and
copy_to_host_async). Here:
  - upload: the frame batch is staged in pinned host memory and sent with
    a non_blocking H2D copy, so the transfer overlaps host work;
  - submit: detection is enqueued and the packed (B, NQ, 36) output is
    copied D2H into pinned memory with a torch.cuda.Event recorded after
    the copy; the returned PendingOutput is waited on only by
    TorchDetector.unpack.
Pinned buffers come from PyTorch's caching host allocator, which does not
hand a block out again until the copies recorded on it have finished.
On a CPU detector the same calls run synchronously with no pinning.
"""
from __future__ import annotations

import numpy as np
import torch

from ros_vision_tpu.runtime.vision_node import VisionNode
from ros_vision_tpu_torch.apriltag.detector import PendingOutput


class TorchVisionNode(VisionNode):
    """VisionNode over a TorchDetector, on the detector's device."""

    def __init__(self, detector, channels: list, **kw):
        super().__init__(detector, channels, **kw)
        self.device = detector.device

    def upload(self, frames: np.ndarray) -> torch.Tensor:
        """Enqueue the H2D copy of a (B, H, W) uint8 batch; returns the
        device tensor."""
        host = torch.from_numpy(np.ascontiguousarray(frames))
        if self.device.type != "cuda":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def _intrinsics_for_submit(self):
        """Intrinsics rows staged on the device once, re-staged when
        self.intrinsics is reassigned."""
        if self.intrinsics is None:
            return None
        if self._intr_dev is None or self._intr_src is not self.intrinsics:
            self._intr_dev = torch.as_tensor(
                np.asarray(self.intrinsics, np.float32), device=self.device)
            self._intr_src = self.intrinsics
        return self._intr_dev

    def submit(self, frames) -> PendingOutput:
        """Enqueue detection of a batch (host array or the tensor from
        upload()) and the D2H copy of its packed result; returns a
        PendingOutput for process_batch(pending=...)."""
        out = self.detector.detect_raw_packed(
            frames, self._intrinsics_for_submit())
        if self.device.type != "cuda":
            return PendingOutput(out, None)
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return PendingOutput(host, event)

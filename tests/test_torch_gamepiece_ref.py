"""The port's game-piece path (ros_vision_tpu_torch/models/infer.py,
ops/nms.py, runtime/game_piece_node.py) against the plain float32
reference (benchmark/reference/yolo11.py, the benchmark's judge's), on the
CPU, with no JAX.

Weights: the reference's seeded Ultralytics state dict, saved as a .pt
and converted by tools/convert_yolo_weights, as a team's checkpoint is.
Frames: two 256x160 BGR frames of orange discs on grey, resized to the
model's 128 px on each side by its own code (the port's antialiased
bilinear interpolate, the reference's triangle-filter matrices).

Tolerances on the raw (B, 5, A) head output, boxes in input pixels:
f32 within 2e-3 px and 1e-5 (those of tests/test_torch_yolo.py against
the flax model; measured here 1.2e-4 px and 1.2e-7); bf16, the card's
precision, within 0.5 px and 5e-3 (bfloat16's 8-bit mantissa over ~25
convolutions, as tests/test_torch_yolo.py bounds the port's bf16 against
flax's; measured here 0.076 px and 9.1e-4), which the control (the
reference with its convolutions' inputs and weights in float8_e4m3fn, one
precision below) fails: measured 7.9 px and 0.013.
"""
import numpy as np
import pytest
import torch

from benchmark.reference import yolo11 as ref
from ros_vision_tpu_torch.models.infer import ModelInference
from ros_vision_tpu_torch.ops import nms
from ros_vision_tpu_torch.runtime.game_piece_node import GamePieceNode
from ros_vision_tpu_torch.tools import convert_yolo_weights
from tests.torch_yolo_ref import YOLO11Torch

torch.set_num_threads(1)

SIZE = 128
SEED = 2147483911
F32_TOL = (2e-3, 1e-5)
BF16_TOL = (0.5, 5e-3)


def frames(b: int = 2, h: int = 160, w: int = 256, seed: int = 3):
    """(b, h, w, 3) uint8 BGR: orange discs on grey, noise 0.75."""
    rng = np.random.default_rng(seed)
    out = np.full((b, h, w, 3), 150.0)
    yy, xx = np.mgrid[:h, :w]
    for i in range(b):
        for _ in range(i + 1):
            cx, cy, r = rng.uniform(20, w - 20), rng.uniform(20, h - 20), \
                rng.uniform(5, 18)
            out[i][(xx - cx) ** 2 + (yy - cy) ** 2 < r * r] = (20, 110, 240)
    out += rng.normal(0, 0.75, out.shape)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The seeded state dict and the .npz the converter makes of it."""
    tmp = tmp_path_factory.mktemp("gamepiece")
    sd = ref.seeded_state_dict(SEED)
    torch.save(sd, tmp / "seeded.pt")
    convert_yolo_weights.convert(str(tmp / "seeded.pt"),
                                 str(tmp / "seeded.npz"), 1, "n")
    return sd, str(tmp / "seeded.npz")


def engine(npz, dtype=torch.float32):
    return ModelInference(num_classes=1, scale="n", img_size=SIZE,
                          class_names=["ball"], params_path=npz,
                          dtype=dtype, device="cpu")


def port_raw(eng, f):
    return eng.forward(eng.preprocess_device(f))


def gaps(got, want):
    return (float((got[:, :4] - want[:, :4]).abs().max()),
            float((got[:, 4:] - want[:, 4:]).abs().max()))


def test_preprocess_matches_the_reference():
    f = frames()
    got = engine(None).preprocess_device(f).permute(0, 3, 1, 2)
    assert float((got - ref.preprocess(f, SIZE)).abs().max()) <= 1e-6


def test_f32_forward_matches_the_reference(weights):
    sd, npz = weights
    f = frames()
    want = ref.detect_raw(ref.model_from(sd), f, SIZE)
    got = port_raw(engine(npz), f)
    assert got.shape == want.shape == (2, 5, 336)
    box, score = gaps(got, want)
    assert box <= F32_TOL[0] and score <= F32_TOL[1], (box, score)


def test_bf16_forward_within_its_tolerance_and_the_control_is_not(weights):
    sd, npz = weights
    f = frames()
    model = ref.model_from(sd)
    want = ref.detect_raw(model, f, SIZE)
    box, score = gaps(port_raw(engine(npz, torch.bfloat16), f), want)
    assert box <= BF16_TOL[0] and score <= BF16_TOL[1], (box, score)
    with ref.control(model):
        ctrl = ref.detect_raw(model, f, SIZE)
    box, score = gaps(ctrl, want)
    assert box > BF16_TOL[0] or score > BF16_TOL[1], (box, score)
    # the control leaves the model as it was
    assert torch.equal(ref.detect_raw(model, f, SIZE), want)


def raw_rows(kind: str, b: int = 3, nc: int = 2, p: int = 300,
             seed: int = 0) -> torch.Tensor:
    """(b, 4 + nc, p) raw outputs: boxes clustered so that many overlap,
    scores per `kind`."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(20, 100, (b, 6, 2))
    pick = rng.integers(0, 6, (b, p))
    xy = np.take_along_axis(centres, pick[..., None], 1) + \
        rng.normal(0, 4, (b, p, 2))
    wh = rng.uniform(8, 30, (b, p, 2))
    scores = rng.uniform(0, 1, (b, nc, p))
    if kind == "ties":
        scores = np.round(scores * 8) / 8           # many equal scores
    elif kind == "none_valid":
        scores[0] *= 0.2499                          # row 0: none >= 0.25
    raw = np.concatenate([np.concatenate([xy, wh], -1).transpose(0, 2, 1),
                          scores], 1)
    return torch.from_numpy(raw.astype(np.float32))


@pytest.mark.parametrize("kind,nc,p,k", [
    ("uniform", 2, 300, 100), ("ties", 2, 300, 100), ("uniform", 1, 300, 100),
    ("ties", 1, 300, 50), ("none_valid", 2, 300, 100), ("uniform", 2, 100, 100),
    ("ties", 3, 64, 64)])
def test_nms_slot_for_slot(kind, nc, p, k):
    raw = raw_rows(kind, nc=nc, p=p)
    got = nms.parse_and_nms(raw, k)
    want = ref.nms(raw, k)
    for r, w in enumerate(want):
        assert torch.equal(got["boxes"][r], w["boxes"])
        assert torch.equal(got["scores"][r], w["scores"])
        assert torch.equal(got["classes"][r].long(), w["classes"])
        assert torch.equal(got["valid"][r], w["kept"])
    if kind == "none_valid":
        assert not got["valid"][0].any()
    assert got["valid"].any()


def test_process_frames_unpacks_to_the_rows_of_detect(weights):
    _, npz = weights
    eng = engine(npz)
    node = GamePieceNode(engine=eng)
    f = frames(3)
    packed, raw = node.process_frames(f, with_raw=True)
    assert packed.shape == (3, 100, 7) and packed.dtype == torch.float32
    assert node.frames_processed == 3
    x = eng.preprocess_device(f)
    assert torch.equal(raw, eng.forward(x))
    out = eng.infer(x)
    h, w = f.shape[1:3]
    for pending in (packed, node.fetch(packed)):
        rows = node.unpack(pending)
        assert len(rows) == 3
        for r, got in enumerate(rows):
            want = eng.detections(out, (w, h), r)
            assert got == want and got
    published = []
    node.detection_publisher = published.append
    node.publish(rows, stamp=2.0, frame_ids=["a", "b", "c"])
    assert [m.frame_id for m in published] == ["a", "b", "c"]
    assert [m.detections for m in published] == rows


def test_the_reference_model_reads_as_the_converters_reference():
    """The benchmark's reference model and the module tree the converter
    tests hold the converters to (tests/torch_yolo_ref.py) give the same
    raw output on the same state dict."""
    sd = ref.seeded_state_dict(SEED)
    other = YOLO11Torch(nc=1, scale="n").eval()
    other.load_state_dict(sd)
    x = ref.preprocess(frames(), SIZE)
    with torch.no_grad(), ref.no_tf32():
        torch.testing.assert_close(other(x), ref.model_from(sd)(x),
                                   rtol=0, atol=0)


def test_seeded_weights_vary_and_keep_the_dfl_projection():
    sd = ref.seeded_state_dict(SEED)
    other = ref.seeded_state_dict(SEED + 1)
    assert torch.equal(sd["model.23.dfl.conv.weight"].flatten(),
                       torch.arange(16, dtype=torch.float32))
    assert not torch.equal(sd["model.0.bn.running_var"],
                           other["model.0.bn.running_var"])
    bias = sd["model.23.cv3.0.2.bias"]
    assert float(bias.abs().max()) <= 1.0 and float(bias.abs().max()) > 0

"""The port's detector leaves the process's TF32 settings alone, and its
float contractions no longer depend on them.

TorchDetector once switched TF32 off for the whole process in its
constructor. The decode sharpening (ops/decode.laplacian3) and the 3x3 and
4-point products of decode and pose (ops/decode.bmm3 / bmv3) are now
elementwise f32, which no TF32 flag rounds; these tests hold them against
the convolution and einsums they replace, within f32 rounding (the sums
run in another order), on the CPU."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ros_vision_tpu_torch.apriltag.detector import TorchDetector
from ros_vision_tpu_torch.apriltag.families import get_family
from ros_vision_tpu_torch.ops import decode as dec
from ros_vision_tpu_torch.ops import pose
from tests.torch_port_helpers import bench_frames


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


@pytest.mark.parametrize("setting", [(False, True, "highest"),
                                     (True, False, "high"),
                                     (True, True, "medium")])
def test_detector_leaves_tf32_settings(setting):
    before = _flags()
    try:
        torch.backends.cuda.matmul.allow_tf32 = setting[0]
        torch.backends.cudnn.allow_tf32 = setting[1]
        torch.set_float32_matmul_precision(setting[2])
        want = _flags()
        det = TorchDetector(device="cpu", width=320, height=160, fx=300.0,
                            fy=300.0, cx=160.0, cy=80.0)
        assert _flags() == want
        det.detect(np.zeros((160, 320), np.uint8))
        assert _flags() == want
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.backends.cudnn.allow_tf32 = before[1]
        torch.set_float32_matmul_precision(before[2])


def test_laplacian3_matches_conv2d():
    g = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 5, 10, 10)).astype(np.float32))
    kern = torch.tensor([[0, -1, 0], [-1, 4, -1], [0, -1, 0]],
                        dtype=torch.float32)
    want = F.conv2d(g.reshape(15, 1, 10, 10), kern[None, None],
                    padding=1).reshape(g.shape)
    torch.testing.assert_close(dec.laplacian3(g), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("a_shape,b_shape", [((4, 7, 3, 3), (4, 7, 3, 3)),
                                             ((4, 7, 3, 3), (3, 3)),
                                             ((6, 3, 4), (4, 3)),
                                             ((2, 5, 1, 3, 3), (4, 3, 3))])
def test_bmm3_matches_matmul(a_shape, b_shape):
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.normal(size=a_shape).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=b_shape).astype(np.float32))
    torch.testing.assert_close(dec.bmm3(a, b), torch.matmul(a, b),
                               rtol=1e-5, atol=1e-5)
    v = b[..., 0]
    torch.testing.assert_close(dec.bmv3(a, v),
                               torch.einsum("...ij,...j->...i", a, v),
                               rtol=1e-5, atol=1e-5)


def _einsum_bmm3(a, b):
    return torch.einsum("...ij,...jk->...ik", a, b)


def _einsum_bmv3(a, v):
    return torch.einsum("...ij,...j->...i", a, v)


def _conv_laplacian3(grid):
    kern = torch.tensor([[0, -1, 0], [-1, 4, -1], [0, -1, 0]],
                        dtype=torch.float32)
    t = grid.shape[-1]
    return F.conv2d(grid.reshape(-1, 1, t, t), kern[None, None],
                    padding=1).reshape(grid.shape)


def test_decode_and_pose_match_the_einsum_forms(monkeypatch):
    """decode_quads and estimate_poses on the bench quads of a 640x400
    frame, against the same stages with the einsums and the convolution
    they replaced patched back in."""
    frames, placed = bench_frames(640, 400, seeds=(0,), angles=(10, 20, -35,
                                                               50))
    gray = torch.from_numpy(frames)
    corners = torch.from_numpy(np.stack(
        [p.corners for p in placed]).astype(np.float32))[None]
    valid = torch.ones(corners.shape[:2], dtype=torch.bool)
    fam = get_family()
    cm = torch.from_numpy(dec.make_code_matrix(fam))
    intr = [torch.tensor([v]) for v in (450.0, 450.0, 320.0, 200.0)]

    def run():
        d = dec.decode_quads(gray, corners, valid, fam, cm)
        return d, pose.estimate_poses(d["H"], 0.1651, *intr)

    got_d, got_p = run()
    monkeypatch.setattr(dec, "bmm3", _einsum_bmm3)
    monkeypatch.setattr(dec, "bmv3", _einsum_bmv3)
    monkeypatch.setattr(dec, "laplacian3", _conv_laplacian3)
    monkeypatch.setattr(pose, "bmm3", _einsum_bmm3)
    monkeypatch.setattr(pose, "bmv3", _einsum_bmv3)
    want_d, want_p = run()
    for k in ("ok", "tag_id", "hamming", "rotation"):
        torch.testing.assert_close(got_d[k], want_d[k], rtol=0, atol=0)
    assert sorted(got_d["tag_id"][0].tolist()) == [0, 42, 100, 311]
    torch.testing.assert_close(got_d["margin"], want_d["margin"],
                               rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got_d["H"], want_d["H"], rtol=1e-5,
                               atol=1e-4)
    for g, w in zip(got_p, want_p):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)

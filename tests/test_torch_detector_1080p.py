"""The port at 1920x1080: the front-end route (ops/frontend_kernel.py
frontend_route) against the JAX detector's TPU rule, the flood-branch front
half (flood CCL ranks + K3 boundary compaction at W=960, where the stage-A
cap clamps to 80 rows) bit-exact against the JAX CPU path
(ccl.label_components + quadfit.boundary_points), and TorchDetector
against TPUDetector end to end.

The JAX detector cannot run its flood branch on the CPU (it calls the
Pallas kernels without interpret), so on the CPU it takes
ccl.label_components; both compute one contract, and tests/test_torch_ccl.py
pins the flood itself against the Pallas kernels in interpret mode.

The scene is the bench layout at 1.5x with noise sigma 0.75. At sigma 1 the
flat background thresholds into speckle that fills the 131,072-point cap
and the segment cap, and the JAX detector finds none of the four tags at
this size (sigma <= 0.75 finds all four on every seed tried). Bench tag 0
is turned by 10 degrees, as in tests/test_torch_detector.py. Tolerances:
ids and hamming exact, corners < 0.1 px and pose_t < 1 mm against the JAX
detector (f32 rounding in XLA vs PyTorch), corners < 1 px against the
rendered truth."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from ros_vision_tpu.apriltag.detector import DetectorConfig as JaxConfig
from ros_vision_tpu.apriltag.detector import TPUDetector
from ros_vision_tpu.ops import ccl as jccl
from ros_vision_tpu.ops import quadfit as jqf
from ros_vision_tpu.ops import threshold as jthr
from ros_vision_tpu_torch.apriltag.detector import (TorchDetector,
                                                    config_from_jax)
from ros_vision_tpu_torch.ops import ccl as tccl
from ros_vision_tpu_torch.ops import frontend_kernel as fk
from ros_vision_tpu_torch.ops import mathf
from ros_vision_tpu_torch.ops import quadfit as tqf
from tests.torch_port_helpers import bench_frames, n, t

W, H = 1920, 1080
NOISE = 0.75
ANGLES = (10, 20, -35, 50)
INTR = dict(fx=900.0, fy=900.0, cx=960.0, cy=540.0)


@pytest.fixture(scope="module")
def scene():
    return bench_frames(W, H, seeds=(0,), noise_sigma=NOISE, angles=ANGLES)


def _jax_route(dh: int, dw: int) -> str:
    """ros_vision_tpu/apriltag/detector.py:256-258 (fused frontend) and
    :396-398 (flood CCL) on the TPU."""
    if dw % 128 == 0 and dh % 8 == 0 and dh * dw <= (1 << 18):
        return "fused"
    return "flood" if dw * dh < (1 << 19) else "large"


@pytest.mark.parametrize("size,route", [
    ((640, 400), "flood"),        # dw = 320 is not lane-aligned
    ((1280, 800), "fused"),
    ((1920, 1080), "flood"),      # 960x540 = 518,400 px
    ((1920, 1200), "large"),      # 960x600 = 576,000 px >= 2^19
])
def test_frontend_route(size, route):
    w, h = size
    assert fk.frontend_route(h // 2, w // 2) == _jax_route(h // 2, w // 2)
    assert fk.frontend_route(h // 2, w // 2) == route


def test_mathf_is_f64_rounded_to_f32():
    """The detector's atan2/cos/sin are the f64 values rounded to f32, so
    the CPU and the card agree bit for bit (their f32 versions differ in
    the last place on ~30% of inputs, which moved 1080p corners by 0.1 px
    between the two). Checked against numpy's f64 libm, exactly."""
    rng = np.random.default_rng(0)
    y = (rng.standard_normal(100_000) * 50).astype(np.float32)
    x = (rng.standard_normal(100_000) * 50).astype(np.float32)
    a = rng.uniform(-4, 4, 100_000).astype(np.float32)
    got = mathf.atan2(t(y), t(x))
    assert got.dtype == t(y).dtype
    np.testing.assert_array_equal(
        n(got), np.arctan2(y.astype(np.float64),
                           x.astype(np.float64)).astype(np.float32))
    np.testing.assert_array_equal(
        n(mathf.cos(t(a))), np.cos(a.astype(np.float64)).astype(np.float32))
    np.testing.assert_array_equal(
        n(mathf.sin(t(a))), np.sin(a.astype(np.float64)).astype(np.float32))


def test_frontend_1080p_matches_jax(scene):
    gray, _ = scene
    th = np.asarray(jthr.adaptive_threshold(
        jthr.decimate2(jnp.asarray(gray)))[0])
    assert th.shape == (1, H // 2, W // 2)
    _, _, jr = jccl.label_components(jnp.asarray(th))
    # under 2048 big blobs, so the JAX rank packing does not wrap
    assert 0 < int(n(jr).max()) < tccl.MAX_BLOBS
    _, _, tr = tccl.label_components_flood(t(th))
    np.testing.assert_array_equal(n(jr), n(tr))
    k = 131072                                       # auto max_points
    jcfg = jqf.QuadFitConfig(max_points=k)
    cfg = tqf.QuadFitConfig(max_points=k)
    assert cfg.max_boundary_pixels == jcfg.max_boundary_pixels
    assert tqf.boundary_block_rows(cfg.max_boundary_pixels, W // 2) == 80
    jpts, jc = jqf.boundary_points(jnp.asarray(th), jr, jcfg)
    pts, counts = fk.frontend(t(th), k, cfg.max_boundary_pixels)
    np.testing.assert_array_equal(n(jc), n(counts))
    for key in ("key", "pack2"):
        np.testing.assert_array_equal(n(jpts[key]), n(pts[key]))


def test_detector_1080p_matches_jax(scene, monkeypatch):
    gray, placed = scene
    jcfg = JaxConfig(width=W, height=H, estimate_pose=True, **INTR)
    jdet = TPUDetector(jcfg)
    tdet = TorchDetector(config_from_jax(dataclasses.asdict(jcfg)),
                         device="cpu")
    assert tdet.config.max_points == jdet.config.max_points == 131072
    assert tdet._active_points == jdet._active_points
    flood_calls = []
    real_flood = tccl.label_components_flood

    def flood(threshim, *a, **kw):
        flood_calls.append(tuple(threshim.shape))
        return real_flood(threshim, *a, **kw)

    monkeypatch.setattr(tccl, "label_components_flood", flood)
    monkeypatch.setattr(fk, "rank_image", None)      # K2 must not run
    jrow, = jdet.detect(gray)
    trow, = tdet.detect(gray)
    assert flood_calls == [(1, H // 2, W // 2)]
    assert [d.tag_id for d in jrow] == [0, 42, 100, 311]
    assert [d.tag_id for d in trow] == [d.tag_id for d in jrow]
    assert [d.hamming for d in trow] == [d.hamming for d in jrow]
    truth = {p.tag_id: p.corners for p in placed}
    for a, b in zip(jrow, trow):
        assert np.abs(a.corners - b.corners).max() < 0.1
        assert np.abs(a.pose_t - b.pose_t).max() < 1e-3
        ref = truth[b.tag_id]
        d = np.linalg.norm(b.corners[:, None] - ref[None], axis=-1)
        assert d.min(axis=1).max() < 1.0

"""The port's debayer + undistort/rectify (ros_vision_tpu_torch/ops/rectify.py)
and its geometry copy against the JAX package's, on the CPU.

Tolerances: the map, uint8 remaps and every debayer output but the luma are
equal; the BT.601 luma and float remaps differ only where XLA contracts
a*b + c into an FMA and torch rounds each op: at most 1 grey level in at
most 0.1% of the pixels (measured: 1 pixel of 12,288 on one pattern), and
float remaps within 1e-4 (measured 3.1e-5).
"""
import numpy as np
import pytest
import jax.numpy as jnp

from ros_vision_tpu.apriltag import geometry as jgeo
from ros_vision_tpu.ops import rectify as jrect
from ros_vision_tpu_torch.apriltag import geometry as tgeo
from ros_vision_tpu_torch.ops import rectify as trect
from tests.torch_port_helpers import n, t

FX = FY = 300.0
CX, CY = 160.0, 80.0
DIST = np.array([-0.25, 0.08, 0.001, -0.001, 0.0])
PATTERNS = ["RGGB", "BGGR", "GRBG", "GBRG"]
MAX_SHARE = 1e-3          # share of pixels allowed to differ by 1


def assert_grey_close(got: np.ndarray, want: np.ndarray):
    assert got.dtype == want.dtype and got.shape == want.shape
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= MAX_SHARE, (d > 0).mean()


def test_geometry_copy_matches():
    rng = np.random.default_rng(0)
    pts = rng.uniform([0, 0], [320, 160], (200, 2))
    dist = np.asarray(DIST, np.float64)
    d_j = jgeo.distort_points(pts, FX, FY, CX, CY, dist)
    np.testing.assert_array_equal(tgeo.distort_points(pts, FX, FY, CX, CY,
                                                      dist), d_j)
    np.testing.assert_array_equal(
        tgeo.undistort_points(d_j, FX, FY, CX, CY, dist),
        jgeo.undistort_points(d_j, FX, FY, CX, CY, dist))
    corners = np.array([[120., 50.], [200., 52.], [198., 120.], [118., 118.]])
    for a, b in zip(tgeo.estimate_tag_pose(corners, 0.16, FX, FY, CX, CY),
                    jgeo.estimate_tag_pose(corners, 0.16, FX, FY, CX, CY)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size", [(320, 160), (1280, 800)])
def test_undistort_map_matches(size):
    w, h = size
    s = w / 320
    args = (w, h, FX * s, FY * s, CX * s, CY * s, DIST)
    np.testing.assert_array_equal(trect.build_undistort_map(*args),
                                  jrect.build_undistort_map(*args))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_remap_bilinear_matches(dtype):
    smap = jrect.build_undistort_map(320, 160, FX, FY, CX, CY, DIST)
    # a map that reaches past every edge, to exercise the clamps
    wide = smap * 1.3 - np.float32([48, 24])
    img = np.random.default_rng(1).integers(0, 256, (3, 160, 320)) \
        .astype(dtype)
    for m in (smap, wide):
        want = n(jrect.remap_bilinear(jnp.asarray(img), jnp.asarray(m)))
        got = n(trect.remap_bilinear(t(img), t(m)))
        if dtype == np.uint8:
            assert_grey_close(got, want)
        else:
            assert got.dtype == want.dtype
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _mosaic(rgb: np.ndarray, pattern: str) -> np.ndarray:
    """(B, H, W, 3) uint8 -> (B, H, W) mosaic under `pattern`."""
    _, h, w, _ = rgb.shape
    ry, rx = jrect._BAYER_OFFSETS[pattern]
    ys, xs = np.mgrid[0:h, 0:w]
    r_m = (ys % 2 == ry) & (xs % 2 == rx)
    b_m = (ys % 2 == 1 - ry) & (xs % 2 == 1 - rx)
    return np.where(r_m, rgb[..., 0], np.where(b_m, rgb[..., 2],
                                               rgb[..., 1]))


def _debayer_cases(seed: int):
    rng = np.random.default_rng(seed)
    flat = np.full((1, 64, 64, 3), 150, np.uint8)
    colour = np.broadcast_to(np.uint8([200, 60, 120]), (1, 64, 64, 3))
    return {"random": rng.integers(0, 256, (2, 66, 98), dtype=np.uint8),
            "flat": flat, "colour": colour}


@pytest.mark.parametrize("to_gray", [True, False])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_debayer_matches(pattern, to_gray):
    for name, x in _debayer_cases(PATTERNS.index(pattern)).items():
        mosaic = x if x.ndim == 3 else _mosaic(x, pattern)
        want = n(jrect.debayer(jnp.asarray(mosaic), pattern, to_gray=to_gray))
        got = n(trect.debayer(t(mosaic), pattern, to_gray=to_gray))
        assert_grey_close(got, want)
        if name == "flat":
            assert np.abs(got.astype(int) - 150).max() <= 1
        if name == "colour" and not to_gray:
            inner = got[0, 8:-8, 8:-8].astype(int)
            assert np.abs(inner - [200, 60, 120]).max() <= 1


def test_debayer_rejects_unknown_pattern():
    with pytest.raises(ValueError):
        trect.debayer(t(np.zeros((1, 4, 4), np.uint8)), "RGBG")


@pytest.mark.parametrize("bayer", [None, "GRBG"])
def test_rectifier_on_the_warped_tag(bayer):
    """The scene of tests/test_rectify.py test_rectified_detection: a tag
    rendered through the lens model, rectified by both packages (here also
    behind a debayer of its mosaic); the port's detector then finds it at
    the ideal pinhole corners."""
    from ros_vision_tpu_torch.apriltag.detector import TorchDetector
    from ros_vision_tpu_torch.apriltag.render import (render_scene,
                                                      simple_square_corners)
    ideal = simple_square_corners(160, 80, 40, angle_deg=10)
    warped = tgeo.distort_points(ideal, FX, FY, CX, CY, DIST)
    img, _ = render_scene([9], [warped], 320, 160)
    frames = img[None]
    if bayer:
        frames = _mosaic(np.repeat(frames[..., None], 3, -1), bayer)
    rec = trect.Rectifier(320, 160, FX, FY, CX, CY, DIST,
                          bayer_pattern=bayer, device="cpu")
    assert rec.device.type == "cpu" and rec.map.device.type == "cpu"
    got = n(rec(t(frames)))
    want = n(jrect.Rectifier(320, 160, FX, FY, CX, CY, DIST,
                             bayer_pattern=bayer)(jnp.asarray(frames)))
    assert_grey_close(got, want)
    det = TorchDetector(device="cpu", width=320, height=160, max_points=4096,
                        max_segments=64, max_quads=8, fx=FX, fy=FY, cx=CX,
                        cy=CY)
    dets = det.detect(got)[0]
    assert [d.tag_id for d in dets] == [9]
    dist = np.linalg.norm(dets[0].corners[:, None] - ideal[None], axis=-1)
    assert dist.min(axis=1).max() < 1.0

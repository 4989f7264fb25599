"""Parity of the port's threshold stage (ros_vision_tpu_torch/ops/threshold.py
and the K1 wrapper ops/threshold_kernel.py) with the JAX package: the plain
chain and the kernel's plain version are bit-exact against
ros_vision_tpu/ops/threshold.py and the interpret-mode Pallas kernel
ops/threshold_pallas.adaptive_threshold_fused."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros_vision_tpu.ops import threshold as jthr
from ros_vision_tpu.ops.threshold_pallas import adaptive_threshold_fused
from ros_vision_tpu_torch import _build
from ros_vision_tpu_torch.device import kernel_route, require_cuda
from ros_vision_tpu_torch.ops import threshold as tthr
from ros_vision_tpu_torch.ops import threshold_kernel as tk
from tests.torch_port_helpers import bench_frames, n, small_scene, t


def _frames(kind: str) -> np.ndarray:
    if kind == "render":
        return bench_frames(256, 128, seeds=(0, 1), noise_sigma=3.0)[0]
    rng = np.random.default_rng(5)
    if kind == "noise":
        return rng.integers(0, 256, (2, 64, 128), dtype=np.uint8)
    # flat regions (spread < 5 -> 127) with a few edges
    img = np.full((1, 64, 128), 100, np.uint8)
    img[:, 20:40, 30:90] = 103
    img[:, 40:, 90:] = 180
    return img


@pytest.mark.parametrize("kind", ["render", "noise", "flat"])
def test_plain_chain_bit_exact(kind):
    g = _frames(kind)
    jd = jthr.decimate2(jnp.asarray(g))
    jt, (jtmin, jtmax, jfmin, jfmax) = jthr.adaptive_threshold(jd)
    td = tthr.decimate2(t(g))
    tt, (ttmin, ttmax, tfmin, tfmax) = tthr.adaptive_threshold(td)
    for a, b in ((jd, td), (jt, tt), (jtmin, ttmin), (jtmax, ttmax),
                 (jfmin, tfmin), (jfmax, tfmax)):
        np.testing.assert_array_equal(n(a), n(b))


@pytest.mark.parametrize("kind", ["render", "noise", "flat"])
def test_k1_wrapper_matches_pallas_interpret(kind):
    g = _frames(kind)
    jd, jt = adaptive_threshold_fused(jnp.asarray(g), interpret=True)
    before = tk.launches.count
    td, tt = tk.adaptive_threshold_fused(t(g))
    assert tk.launches.count == before          # CPU tensor: plain version
    np.testing.assert_array_equal(n(jd), n(td))
    np.testing.assert_array_equal(n(jt), n(tt))


def test_yuyv_to_gray():
    rng = np.random.default_rng(2)
    yuyv = rng.integers(0, 256, (2, 16, 64), dtype=np.uint8)
    np.testing.assert_array_equal(n(jthr.yuyv_to_gray(jnp.asarray(yuyv))),
                                  n(tthr.yuyv_to_gray(t(yuyv))))


def test_kernel_route_and_checks():
    g = t(small_scene())
    assert kernel_route(g) == "cpu"
    with pytest.raises(ValueError):
        kernel_route(torch.empty(2, device="meta"))
    with pytest.raises(ValueError, match="expected torch.uint8"):
        _build.check_tensor(g.to(torch.int32), "gray", torch.uint8,
                            tuple(g.shape), g.device)
    with pytest.raises(ValueError, match="shape"):
        _build.check_tensor(g, "gray", torch.uint8, (1, 1, 1), g.device)
    with pytest.raises(ValueError, match="contiguous"):
        _build.check_tensor(g.transpose(1, 2), "gray", torch.uint8,
                            tuple(g.transpose(1, 2).shape), g.device)


def test_require_cuda_never_picks_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        require_cuda()


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """The kernel build never silently falls back: without nvcc it raises."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_library_name_tracks_sources():
    """The built library is named by a hash of the sources and flags, so
    an edited source is never served a stale binary."""
    p = _build.library_path()
    assert p.parent == _build.BUILD_DIR and p.suffix == ".so"
    assert p == _build.library_path()
    assert {s.name for s in _build._sources()} >= {
        "threshold.cu", "ccl.cu", "boundary.cu", "histogram.cu", "scan.cuh"}


def emulate_bands(gray: np.ndarray, band: int, mwbd: int = 5):
    """csrc/threshold.cu on the CPU: per block, `band` tile rows of one
    frame with one halo tile row above and below (neutral min 255 / max 0
    beyond the frame), each thread's tile pair sampled from the even
    bytes of its 16 (or, for a lone last tile, 8) bytes of each even row,
    the tile min/max padded by a neutral column on each side, the 3x3
    dilation and the byte-wise strict threshold."""
    b, h, w = gray.shape
    th, tw = h // 8, w // 8
    decim = np.full((b, h // 2, w // 2), -1, np.int32)
    thresh = np.full((b, h // 2, w // 2), -1, np.int32)
    for f in range(b):
        for ty0 in range(0, th, band):
            nb = min(band, th - ty0)
            tmin = np.full((nb + 2, tw + 2), 255, np.int32)
            tmax = np.zeros((nb + 2, tw + 2), np.int32)
            samp = np.zeros((nb * 4, tw * 4), np.int32)
            for k in range(nb + 2):
                ty = ty0 - 1 + k
                if not 0 <= ty < th:
                    continue
                for tp in range(-(-tw // 2)):
                    nbytes = 16 if 2 * tp + 1 < tw else 8
                    rows = gray[f, ty * 8:ty * 8 + 8:2,
                                16 * tp:16 * tp + nbytes]
                    even = rows[:, ::2].astype(np.int32)    # (4, 8 or 4)
                    for j in range(nbytes // 8):
                        tile = even[:, 4 * j:4 * j + 4]
                        t0 = 2 * tp + j
                        tmin[k, 1 + t0] = tile.min()
                        tmax[k, 1 + t0] = tile.max()
                        if 1 <= k <= nb:
                            samp[(k - 1) * 4:k * 4, 4 * t0:4 * t0 + 4] = tile
            for k in range(nb):
                y2 = (ty0 + k) * 4
                decim[f, y2:y2 + 4] = samp[4 * k:4 * k + 4]
                for t0 in range(tw):
                    mn = tmin[k:k + 3, t0:t0 + 3].min()
                    mx = tmax[k:k + 3, t0:t0 + 3].max()
                    spread = mx - mn
                    v = samp[4 * k:4 * k + 4, 4 * t0:4 * t0 + 4]
                    out = np.where(v > mn + spread // 2, 255, 0)
                    if spread < mwbd:
                        out[:] = 127
                    thresh[f, y2:y2 + 4, 4 * t0:4 * t0 + 4] = out
    assert (decim >= 0).all() and (thresh >= 0).all()
    return decim.astype(np.uint8), thresh.astype(np.uint8)


def _w16_8() -> np.ndarray:
    """(2, 48, 136) frames: W % 16 == 8, so the last tile of each row is
    a lone 8-byte load; 6 tile rows; a flat corner (threshold 127)."""
    g = bench_frames(136, 48, seeds=(3, 4), noise_sigma=4.0)[0]
    g[:, 32:, 96:] = 100
    return g


@pytest.mark.parametrize("kind,band", [
    ("render", 1), ("render", 3), ("render", 8), ("render", 16),
    ("noise", 2), ("noise", 3), ("flat", 5), ("w16_8", 1), ("w16_8", 4),
    ("w16_8", 6)])
def test_band_emulation_bit_exact(kind, band):
    """Band heights that divide h/8 and that do not (the last band short),
    and W % 16 == 8, against the plain chain and the interpret-mode
    Pallas kernel."""
    g = _w16_8() if kind == "w16_8" else _frames(kind)
    jd, jt = adaptive_threshold_fused(jnp.asarray(g), interpret=True)
    pd, pt = tk.adaptive_threshold_plain(t(g))
    np.testing.assert_array_equal(n(pd), n(jd))
    np.testing.assert_array_equal(n(pt), n(jt))
    ed, et = emulate_bands(g, band)
    np.testing.assert_array_equal(ed, n(jd))
    np.testing.assert_array_equal(et, n(jt))


def test_w16_8_frames_have_every_threshold_value():
    _, tt = tk.adaptive_threshold_plain(t(_w16_8()))
    assert _w16_8().shape[2] % 16 == 8
    assert set(np.unique(n(tt)).tolist()) == {0, 127, 255}


@pytest.mark.parametrize("b,h,w,band,bands", [
    (4, 800, 1280, 3, 34), (4, 1080, 1920, 4, 34), (1, 800, 1280, 1, 100),
    (2, 808, 1288, 1, 101), (1, 400, 640, 1, 50), (64, 800, 1280, 16, 7),
    (1, 8, 8, 1, 1)])
def test_threshold_plan(b, h, w, band, bands):
    """Bands of floor(th * B / 132) tile rows (fewer where a band would
    pass 48 KB of shared memory): a B=4 batch gives the H100's 132 SMs at
    least one block each; the launcher's layout."""
    plan = tk.threshold_plan(b, h, w, 132)
    assert (plan.band, plan.bands) == (band, bands)
    th = h // 8
    assert plan.bands == -(-th // plan.band)
    assert b * plan.bands >= min(132, b * th)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert plan.smem_bytes == tk.threshold_smem(plan.band, w // 8)
    assert plan.smem_bytes <= tk.SMEM_DEFAULT
    assert plan.args() == (plan.band, plan.bands, plan.threads,
                           plan.smem_bytes)


def test_threshold_plan_keeps_wide_frames_in_48k():
    plan = tk.threshold_plan(64, 64, 8192, 132)
    assert plan.smem_bytes <= tk.SMEM_DEFAULT and plan.band >= 1


@pytest.mark.parametrize("b,h,w", [(1, 0, 8), (1, 8, 0), (1, 12, 8),
                                   (1, 8, 12), (0, 8, 8), (70000, 8, 8),
                                   (1, 8, 20000)])
def test_threshold_plan_refuses_what_the_launcher_rejects(b, h, w):
    with pytest.raises(ValueError):
        tk.threshold_plan(b, h, w, 132)

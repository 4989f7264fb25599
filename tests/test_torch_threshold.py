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

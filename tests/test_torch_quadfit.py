"""Parity of the port's quad-fitting layer with the JAX package: blocked
prefix sums (ros_vision_tpu_torch/ops/scan.py), segment utilities
(ops/segments.py) and cluster_and_fit (ops/quadfit.py).

Tolerances: integer-valued data (counts, slots, segment ids) is exact in
f32 and must match bit for bit. Float prefix sums are summed in another
order than XLA's (the JAX package's blocked matmul accumulates each block
sequentially on the CPU; the port uses a fixed log-step association so the
CPU and the card agree), so they are held to the f64 truth within the
rounding bound of a 512-term f32 sum. Tag corners from cluster_and_fit on
clean renders are held to 2e-3 decimated px of JAX: the line fits use
atan2/cos/sin, whose last bit differs between XLA and PyTorch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros_vision_tpu.ops import ccl as jccl
from ros_vision_tpu.ops import quadfit as jqf
from ros_vision_tpu.ops import scan as jscan
from ros_vision_tpu.ops import segments as jsegs
from ros_vision_tpu.ops import threshold as jthr
from ros_vision_tpu_torch.ops import quadfit as tqf
from ros_vision_tpu_torch.ops import scan as tscan
from ros_vision_tpu_torch.ops import segments as tsegs
from tests.torch_port_helpers import bench_frames, n, t


def _ints(shape, seed, hi=50):
    return np.random.default_rng(seed).integers(0, hi, shape).astype(
        np.float32)


@pytest.mark.parametrize("length", [100, 512, 3000])
def test_cumsum_mxu_integer_exact(length):
    x = _ints((2, 3, length), 0)
    np.testing.assert_array_equal(n(jscan.cumsum_mxu(jnp.asarray(x))),
                                  n(tscan.cumsum_mxu(t(x))))
    np.testing.assert_array_equal(
        n(jscan.cumsum_mxu(jnp.asarray(x), axis=1)),
        n(tscan.cumsum_mxu(t(x), axis=1)))


def test_cumsum_mxu_float_within_f32_rounding():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 4096)) * 30).astype(np.float32)
    truth = np.cumsum(x.astype(np.float64), axis=-1)
    bound = 512 * np.finfo(np.float32).eps * np.cumsum(np.abs(x), axis=-1)
    for got in (n(jscan.cumsum_mxu(jnp.asarray(x))),
                n(tscan.cumsum_mxu(t(x)))):
        assert (np.abs(got - truth) <= bound).all()


def test_blocked_and_overlapped_parts_integer_exact():
    x = _ints((2, 1000, 6), 2)
    jl, jt, jb = jscan.blocked_cumsum_parts(jnp.asarray(x))
    tl, tt, tb = tscan.blocked_cumsum_parts(t(x))
    assert jb == tb == 128
    np.testing.assert_array_equal(n(jl), n(tl))
    np.testing.assert_array_equal(n(jt), n(tt))
    jo, jb, jov = jscan.overlapped_cumsum(jnp.asarray(x))
    to, tb, tov = tscan.overlapped_cumsum(t(x))
    assert (jb, jov) == (tb, tov) == (128, 40)
    np.testing.assert_array_equal(n(jo), n(to))


def test_segmented_cumsums_integer_exact():
    rng = np.random.default_rng(3)
    k = 300
    starts = rng.random((2, k)) < 0.05
    starts[:, 0] = True
    start_idx = np.maximum.accumulate(
        np.where(starts, np.arange(k), 0), axis=1).astype(np.int32)
    x2 = _ints((2, k), 4)
    x3 = _ints((2, k, 6), 5)
    for x in (x2, x3):
        np.testing.assert_array_equal(
            n(jscan.segmented_cumsum_from_starts(jnp.asarray(x),
                                                 jnp.asarray(start_idx))),
            n(tscan.segmented_cumsum_from_starts(t(x), t(start_idx))))
        np.testing.assert_array_equal(
            n(jsegs.segmented_cumsum(jnp.asarray(x), jnp.asarray(starts))),
            n(tsegs.segmented_cumsum(t(x), t(starts))))


@pytest.mark.parametrize("k", [5, 64, 300, 1000])
def test_thin_uniform_and_compact_exact(k):
    rng = np.random.default_rng(k)
    valid = rng.random((2, 900)) < 0.4
    jkeep, jslot = jsegs.thin_uniform(jnp.asarray(valid), k)
    tkeep, tslot = tsegs.thin_uniform(t(valid), k)
    np.testing.assert_array_equal(n(jkeep), n(tkeep))
    np.testing.assert_array_equal(n(jslot)[n(jkeep)], n(tslot)[n(tkeep)])
    payload = rng.integers(0, 1 << 20, (2, 900)).astype(np.int32)
    jout, jc = jsegs.compact(jnp.asarray(valid), {"p": jnp.asarray(payload)},
                             k, {"p": jnp.int32(-7)})
    tout, tc = tsegs.compact(t(valid), {"p": t(payload)}, k, {"p": -7})
    np.testing.assert_array_equal(n(jc), n(tc))
    np.testing.assert_array_equal(n(jout["p"]), n(tout["p"]))


@pytest.mark.parametrize("total", [90013, 90016])
def test_thin_uniform_ieee_division(total):
    """The 1280x800 stage-A cap (25,600 px) against a bench-scene-sized
    stream, at totals where an f32 division and a multiplication by the
    rounded reciprocal disagree: the kept set must follow the division."""
    k = 25600
    assert np.float32(k - 2) / np.float32(total) != \
        np.float32(k - 2) * (np.float32(1) / np.float32(total))
    rng = np.random.default_rng(total)
    valid = np.zeros((1, 100_000), bool)
    valid[0, np.sort(rng.choice(100_000, total, replace=False))] = True
    jkeep, jslot = jsegs.thin_uniform(jnp.asarray(valid), k)
    tkeep, tslot = tsegs.thin_uniform(t(valid), k)
    np.testing.assert_array_equal(n(jkeep), n(tkeep))
    np.testing.assert_array_equal(n(jslot)[n(jkeep)], n(tslot)[n(tkeep)])


def test_segment_ids_and_take1():
    rng = np.random.default_rng(6)
    lo = np.sort(rng.integers(0, 40, (2, 500)), axis=1).astype(np.int32)
    hi = rng.integers(0, 3, (2, 500)).astype(np.int32)
    valid = rng.random((2, 500)) < 0.9
    for keys in ((lo,), (lo, hi)):
        j = jsegs.segment_ids_from_sorted_keys(
            *[jnp.asarray(x) for x in keys], valid=jnp.asarray(valid),
            max_segments=30)
        tt = tsegs.segment_ids_from_sorted_keys(
            *[t(x) for x in keys], valid=t(valid), max_segments=30)
        np.testing.assert_array_equal(n(j), n(tt))
    arr = rng.normal(size=(2, 50, 3)).astype(np.float32)
    idx = rng.integers(0, 50, (2, 80)).astype(np.int32)
    np.testing.assert_array_equal(
        n(jsegs.take1(jnp.asarray(arr), jnp.asarray(idx))),
        n(tsegs.take1(t(arr), t(idx))))
    np.testing.assert_array_equal(
        n(jsegs.take1(jnp.asarray(arr[..., 0]), jnp.asarray(idx))),
        n(tsegs.take1(t(arr[..., 0]), t(idx))))


def test_fit_line_and_payload():
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(64, 30, 2)).astype(np.float32) * [5, 0.3]
    w = rng.uniform(0.1, 1, (64, 30)).astype(np.float32)
    m = np.stack([(w * pts[..., 0]).sum(1), (w * pts[..., 1]).sum(1),
                  (w * pts[..., 0] ** 2).sum(1),
                  (w * pts[..., 0] * pts[..., 1]).sum(1),
                  (w * pts[..., 1] ** 2).sum(1), w.sum(1)], -1)
    cnt = np.full(64, 30, np.float32)
    j = jqf.fit_line_f32(jnp.asarray(m), jnp.asarray(cnt))
    tt = tqf.fit_line_f32(t(m), t(cnt))
    for key in ("ex", "ey", "nx", "ny", "err", "mse"):
        np.testing.assert_allclose(n(tt[key]), n(j[key]), rtol=1e-5,
                                   atol=1e-5)
    x2, y2 = rng.integers(0, 2000, (2, 100)).astype(np.int32)
    gx, gy = rng.integers(-1, 2, (2, 100)).astype(np.int32)
    jp = jqf.pack_payload(*map(jnp.asarray, (x2, y2, gx, gy)))
    tp = tqf.pack_payload(*map(t, (x2, y2, gx, gy)))
    np.testing.assert_array_equal(n(jp), n(tp))
    for a, b in zip(jqf.unpack_payload(jp), tqf.unpack_payload(tp)):
        np.testing.assert_array_equal(n(a), n(b))
    for k in (4096, 32768):
        assert tqf.QuadFitConfig(max_points=k).max_boundary_pixels == \
            jqf.QuadFitConfig(max_points=k).max_boundary_pixels


@pytest.fixture(scope="module")
def clean_points():
    """Boundary points of two clean 512x320 renders (the bench layout
    scaled, two rotations) from the JAX front half."""
    g = np.concatenate([
        bench_frames(512, 320, seeds=(0,), noise_sigma=0.0)[0],
        bench_frames(512, 320, seeds=(0,), noise_sigma=0.0,
                     angles=(12, -20, 35, 5))[0]])
    decim = jthr.decimate2(jnp.asarray(g))
    th = jthr.adaptive_threshold(decim)[0]
    _, _, ranks = jccl.label_components(th)
    cfg = jqf.QuadFitConfig(max_points=4096, max_segments=256, max_quads=16)
    pts, _ = jqf.boundary_points(th, ranks, cfg)
    return {k: np.asarray(v) for k, v in pts.items()}, np.asarray(decim)


@pytest.mark.parametrize("branch", ["fast", "stable"])
def test_cluster_and_fit_tag_corners(clean_points, branch, monkeypatch):
    """Both windowed-error branches (the stable one forced by lowering
    its segment-size gate in both packages)."""
    if branch == "stable":
        monkeypatch.setattr(jqf, "ERRS_STABLE_MIN_SZ", 64)
        monkeypatch.setattr(tqf, "ERRS_STABLE_MIN_SZ", 64)
    pts, decim = clean_points
    jcfg = jqf.QuadFitConfig(max_points=4096, max_segments=256, max_quads=16)
    tcfg = tqf.QuadFitConfig(max_points=4096, max_segments=256, max_quads=16)
    jq = jax.jit(lambda p, d: jqf.cluster_and_fit(p, d, jcfg))(
        {k: jnp.asarray(v) for k, v in pts.items()}, jnp.asarray(decim))
    tq = tqf.cluster_and_fit({k: t(v) for k, v in pts.items()}, t(decim),
                             tcfg)
    for key in ("seg", "count", "seg_ok"):
        np.testing.assert_array_equal(n(jq[key]), n(tq[key]))
    # tag-sized quads (>= 100 decimated px^2; the smallest tag here covers
    # ~150) must pair up one to one. Tiny junk quads whose windowed line
    # errors are dominated by prefix-sum rounding may come and go.
    for b in range(2):
        want = _tag_quads(jq, b)
        got = _tag_quads(tq, b)
        assert len(want) == len(got) >= 4
        for c in want:
            err = np.abs(got - c[None]).reshape(len(got), -1).max(axis=1)
            assert err.min() <= 2e-3, err.min()


def _tag_quads(q, b: int) -> np.ndarray:
    c = n(q["corners"])[b][n(q["quad_valid"])[b]]
    d1 = c[:, 2] - c[:, 0]
    d2 = c[:, 3] - c[:, 1]
    area = 0.5 * np.abs(d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0])
    return c[area >= 100]


def test_cluster_and_fit_counts_one_host_read(clean_points):
    from ros_vision_tpu_torch.device import HostSyncs
    pts, decim = clean_points
    syncs = HostSyncs()
    reads = []
    item = syncs.item
    syncs.item = lambda x: reads.append(x) or item(x)
    tqf.cluster_and_fit({k: t(v) for k, v in pts.items()}, t(decim),
                        tqf.QuadFitConfig(max_points=4096, max_segments=256,
                                          max_quads=16), syncs)
    assert len(reads) == 1
    # the count also holds the constant tables' 14 uploads
    assert syncs.count == 15
    assert torch.get_num_threads() == 1

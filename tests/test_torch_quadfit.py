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
import hashlib

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


def test_cluster_and_fit_counts_one_host_read(clean_points, monkeypatch):
    """A device's first call uploads the 14 constant tables; a second one
    uploads nothing, and its one host sync is the windowed-error read."""
    from ros_vision_tpu_torch import device
    from ros_vision_tpu_torch.device import HostSyncs
    pts, decim = clean_points
    cfg = tqf.QuadFitConfig(max_points=4096, max_segments=256, max_quads=16)
    monkeypatch.setattr(device, "_TABLES", {})
    counts = []
    for _ in range(2):
        syncs = HostSyncs()
        reads, uploads = [], []
        item, upload = syncs.item, syncs.upload
        syncs.item = lambda x: reads.append(x) or item(x)
        syncs.upload = lambda *a: uploads.append(a) or upload(*a)
        tqf.cluster_and_fit({k: t(v) for k, v in pts.items()}, t(decim),
                            cfg, syncs)
        assert len(reads) == 1
        counts.append((len(uploads), syncs.count))
    assert counts == [(14, 15), (0, 1)]
    assert torch.get_num_threads() == 1


def test_constant_tables_equal_what_as_tensor_gives(monkeypatch):
    from ros_vision_tpu_torch import device
    from ros_vision_tpu_torch.device import HostSyncs
    monkeypatch.setattr(device, "_TABLES", {})
    tabs = tqf.constant_tables(torch.device("cpu"), HostSyncs())
    assert tqf.constant_tables(torch.device("cpu"), HostSyncs()) is tabs
    want = {"taps": [torch.as_tensor([((s if s < 5 else s - 10) + j) % 16
                                      for s in range(10)])
                     for j in range(-3, 4)],
            "nxt_idx": torch.as_tensor([1, 2, 3, 4, 0, 6, 7, 8, 9, 0]),
            "prv_idx": torch.as_tensor([9, 0, 1, 2, 0, 4, 5, 6, 7, 8]),
            "pk_slot_ok": torch.as_tensor([True] * 4 + [False] * 2
                                          + [True] * 4),
            "pair_a": torch.as_tensor(tqf._PAIR_A),
            "pair_b": torch.as_tensor(tqf._PAIR_B),
            "combo_pairs": torch.as_tensor(tqf._COMBO_PAIRS),
            "combo_last": torch.as_tensor(tqf._COMBOS[:, 3])}
    assert set(tabs) == set(want)
    for name, w in want.items():
        for got, ww in zip(*([tabs[name], w] if name == "taps"
                             else [[tabs[name]], [w]])):
            assert got.dtype == ww.dtype, name
            assert torch.equal(got, ww), name
    assert len(tabs["taps"]) == 7


# sha256 (first 16 hex digits) over the sorted keys, dtypes and bytes of
# cluster_and_fit's outputs on clean_points, computed with the function
# before it was split into fit_sort, fit_lines and fit_quads (the JAX
# package's inputs, one torch thread)
PRESPLIT = {("fast", False): "5eb8a97cecccb28a",
            ("fast", True): "f623ba3a1712906d",
            ("stable", False): "ce8c07611a376918",
            ("stable", True): "ce8c07611a376918"}


def _digest(out: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(out):
        v = out[k].contiguous()
        h.update(k.encode())
        h.update(str(v.dtype).encode())
        h.update(v.numpy().tobytes())
    return h.hexdigest()[:16]


def _cfg(pallas=False, **kw):
    return tqf.QuadFitConfig(**{"max_points": 4096, "max_segments": 256,
                                "max_quads": 16, "use_pallas_sort": pallas,
                                **kw})


@pytest.mark.parametrize("branch", ["fast", "stable"])
@pytest.mark.parametrize("pallas", [False, True])
def test_stages_bit_identical_to_the_presplit_function(
        clean_points, branch, pallas, monkeypatch):
    """fit_sort, the read, fit_lines and fit_quads run in turn give the
    pre-split function's bits, through both windowed-error branches."""
    from ros_vision_tpu_torch.device import HostSyncs
    if branch == "stable":
        monkeypatch.setattr(tqf, "ERRS_STABLE_MIN_SZ", 64)
    pts, decim = clean_points
    cfg = _cfg(pallas)
    dm = t(decim)
    tabs = tqf.constant_tables(dm.device, HostSyncs())
    s = tqf.fit_sort(cfg, tuple(dm.shape), t(pts["key"]), t(pts["pack2"]))
    assert bool(s["stable"]) == (branch == "stable")
    ln = tqf.fit_lines(cfg, tabs, bool(s["stable"]), dm,
                       **{k: s[k] for k in tqf._LINES_IN})
    q = tqf.fit_quads(cfg, tabs, **{k: s[k] for k in tqf._QUADS_IN_S},
                      **{k: ln[k] for k in tqf._QUADS_IN_L})
    assert _digest(tqf._result(s, ln, q)) == PRESPLIT[branch, pallas]
    out = tqf.cluster_and_fit({k: t(v) for k, v in pts.items()}, dm, cfg)
    assert _digest(out) == PRESPLIT[branch, pallas]


class _CpuGraph:
    """A CPU stand-in for a captured CUDA graph: it runs the stage on its
    bound inputs once at capture, and each replay runs it again and
    writes the results into the same output tensors."""

    def __init__(self, fn, bound):
        self.fn, self.bound = fn, bound
        self.outputs = fn(**bound)

    def replay(self):
        for k, v in self.fn(**self.bound).items():
            self.outputs[k].copy_(v)


@pytest.fixture
def cpu_graphs(monkeypatch):
    from ros_vision_tpu_torch.device import HostSyncs

    def record(self, fn, bound):
        g = _CpuGraph(fn, bound)
        return g, g.outputs
    monkeypatch.setattr(tqf.GraphRunner, "_record", record)
    tqf.constant_tables(torch.device("cpu"), HostSyncs())


def _run(runner, pts, decim, cfg):
    from ros_vision_tpu_torch.device import HostSyncs
    syncs = HostSyncs()
    out = runner.run({k: t(v) for k, v in pts.items()}, t(decim), cfg,
                     syncs)
    assert syncs.count == 1
    return out


def test_graph_runner_replays_bit_identical(clean_points, cpu_graphs):
    """The runner's eager, capture and replay calls give the eager bits;
    a result it returned keeps them when a later call replays the graphs
    on other inputs."""
    pts, decim = clean_points
    runner = tqf.GraphRunner()
    got = [_run(runner, pts, decim, _cfg()) for _ in range(3)]
    assert runner.runs == {"eager": 1, "captured": 1, "replayed": 1}
    assert [_digest(o) for o in got] == [PRESPLIT["fast", False]] * 3
    flipped = ({k: v[::-1].copy() for k, v in pts.items()},
               decim[::-1].copy())
    other = _run(runner, *flipped, _cfg())
    assert runner.runs["replayed"] == 2
    assert [_digest(o) for o in got] == [PRESPLIT["fast", False]] * 3
    for k in other:
        np.testing.assert_array_equal(n(other[k]), n(got[0][k])[::-1],
                                      err_msg=k)


def test_graph_runner_runs_eagerly_where_capture_fails(clean_points,
                                                       cpu_graphs,
                                                       monkeypatch):
    """A stage whose capture raises runs eagerly, then and from then on,
    with a warning; the other stages still replay; outputs keep their
    bits."""
    pts, decim = clean_points
    runner = tqf.GraphRunner()
    record = tqf.GraphRunner._record

    def failing(self, fn, bound):
        if fn.func is tqf.fit_lines:
            raise RuntimeError("capture invalidated")
        return record(self, fn, bound)
    monkeypatch.setattr(tqf.GraphRunner, "_record", failing)
    _run(runner, pts, decim, _cfg())
    with pytest.warns(UserWarning, match="lines stage's capture failed"):
        got = [_run(runner, pts, decim, _cfg())]
    got += [_run(runner, pts, decim, _cfg()) for _ in range(2)]
    assert runner.runs == {"eager": 4, "captured": 0, "replayed": 0}
    assert {key[0] for key in runner._graphs} == {"sort", "quads"}
    assert [_digest(o) for o in got] == [PRESPLIT["fast", False]] * 3


@pytest.mark.parametrize("change", ["B", "K", "decim", "config", "branch"])
def test_graph_key_separates(clean_points, cpu_graphs, change, monkeypatch):
    """A call that differs from two earlier ones only in `change` runs a
    stage eagerly again: its graphs are keyed apart."""
    pts, decim = clean_points
    runner = tqf.GraphRunner()
    for _ in range(2):
        _run(runner, pts, decim, _cfg())
    cfg = _cfg()
    if change == "B":
        pts, decim = {k: v[:1] for k, v in pts.items()}, decim[:1]
    elif change == "K":
        pts = {k: v[:, :2048] for k, v in pts.items()}
    elif change == "decim":
        decim = decim[:, :-2]
    elif change == "config":
        cfg = _cfg(max_quads=8)
    else:
        monkeypatch.setattr(tqf, "ERRS_STABLE_MIN_SZ", 64)
    got = _run(runner, pts, decim, cfg)
    assert runner.runs == {"eager": 2, "captured": 1, "replayed": 0}
    stages = {key[0] for key in runner._seen}
    assert stages == {"sort", "lines", "quads"}
    # only the lines stage is keyed by the branch: sort and quads replay
    assert len(runner._seen) == (4 if change == "branch" else 6)
    want = _digest(tqf.cluster_and_fit({k: t(v) for k, v in pts.items()},
                                       t(decim), cfg))
    assert _digest(got) == want
    assert _digest(_run(runner, pts, decim, cfg)) == want
    assert runner.runs["captured"] == 2


def test_recording_holds_launch_counts_for_each_replay():
    from ros_vision_tpu_torch import _build
    c = _build.LaunchCounter("probe")
    c.add(2)
    with _build.recording() as held:
        c.add(3)
        c.add(0)
    assert (c.count, c.kernels) == (1, 2) and held == [(c, 3), (c, 0)]
    for _ in range(2):
        _build.replayed(held)
    assert (c.count, c.kernels) == (5, 8)

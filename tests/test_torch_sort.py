"""Parity of K9 (ros_vision_tpu_torch/ops/sort_kernel.py sort_tpu) with the
Pallas bitonic sort ops/sort_pallas.sort_tpu in interpret mode, and of the
port's use_pallas_sort configuration of cluster_and_fit and TorchDetector.

On the CPU the wrapper runs its plain version (stable torch.sorts from the
last key to the first) and counts no launch. Where every operand is a key
the comparison is exact; with a payload plane the keys compare exactly
and the payload as a multiset within each run of equal keys (the bitonic
network is not stable). sort_network_plain, the network itself (the
kernel's comparator on the card), equals the interpret-mode kernel bit for
bit, payload order included. The shapes are those of
tests/test_sort_pallas.py. The launch plan of csrc/sort.cu (sort_plan) is
checked against the card's limits at the path's widths.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ros_vision_tpu.ops import ccl as jccl
from ros_vision_tpu.ops import quadfit as jqf
from ros_vision_tpu.ops import threshold as jthr
from ros_vision_tpu.ops.sort_pallas import sort_tpu as jsort
from ros_vision_tpu_torch.apriltag.detector import (DetectorConfig,
                                                    TorchDetector)
from ros_vision_tpu_torch.apriltag.render import (render_scene,
                                                  simple_square_corners)
from ros_vision_tpu_torch.ops import quadfit as tqf
from ros_vision_tpu_torch.ops import sort_kernel as sk
from tests.torch_port_helpers import bench_frames, n, t

KEY_INVALID = int(jqf.KEY_INVALID)
SMEM_LIMIT = 232448    # 227 KB: the shared memory one H100 block may opt in to


def _check(ops, num_keys, exact=True):
    want = [n(w) for w in jsort([jnp.asarray(o) for o in ops],
                                num_keys=num_keys, interpret=True)]
    net = sk.sort_network_plain([t(o) for o in ops], num_keys)
    for w, g in zip(want, net, strict=True):
        np.testing.assert_array_equal(w, n(g))
    before = sk.launches.count
    got = [n(g) for g in sk.sort_tpu([t(o) for o in ops], num_keys)]
    assert sk.launches.count == before            # CPU: plain version
    assert len(got) == len(ops)
    for g, o in zip(got, ops):
        assert g.dtype == np.int32 and g.shape == o.shape
    for w, g in zip(want[:num_keys], got[:num_keys]):
        np.testing.assert_array_equal(w, g)
    if exact:
        for w, g in zip(want[num_keys:], got[num_keys:]):
            np.testing.assert_array_equal(w, g)
    return want, got


@pytest.mark.parametrize("k", [128, 512, 1000, 2048])
@pytest.mark.parametrize("num_keys,nops", [(1, 1), (2, 2)])
def test_sort_parity_random(k, num_keys, nops):
    rng = np.random.default_rng(k * 7 + nops)
    ops = [rng.integers(0, 1 << 22, (3, k)).astype(np.int32)
           for _ in range(nops)]
    _check(ops, num_keys)


def test_sort_parity_sentinel_heavy():
    """Mostly-invalid streams (the narrow-path regime): KEY_INVALID keys
    with zero payloads, a few real points that must come first."""
    rng = np.random.default_rng(0)
    b, k = 2, 4096
    key = np.full((b, k), KEY_INVALID, np.int32)
    pack = np.zeros((b, k), np.int32)
    for bi in range(b):
        idx = rng.choice(k, 37, replace=False)
        key[bi, idx] = rng.integers(0, 1 << 22, 37)
        pack[bi, idx] = rng.integers(0, 1 << 28, 37)
    _check([key, pack], 2)


def test_sort_parity_duplicate_keys():
    """Heavy ties over both key planes: exact, since with every operand a
    key equal tuples are identical."""
    rng = np.random.default_rng(1)
    key = rng.integers(0, 7, (2, 2048)).astype(np.int32)
    pack = rng.integers(0, 5, (2, 2048)).astype(np.int32)
    _check([key, pack], 2)


def test_sort_parity_peak_pattern():
    """The (3, 3) peak sort of cluster_and_fit: (segment, -errbits, pos)
    with a negative second key, K not a power of two."""
    rng = np.random.default_rng(2)
    b, k, nseg = 2, 1000, 64
    seg = rng.integers(0, nseg + 1, (b, k)).astype(np.int32)
    errs = rng.exponential(5.0, (b, k)).astype(np.float32)
    errs[:, ::7] = 0.0
    errs[:, 3::11] = errs[:, 3:4]                  # ties on the error
    negb = -errs.view(np.int32)
    pos = np.tile(np.arange(k, dtype=np.int32), (b, 1))
    want, got = _check([seg, negb, pos], 3)
    assert (got[1] < 0).any()
    perr = (-got[1]).view(np.float32)
    assert (np.diff(perr, axis=1)[np.diff(got[0], axis=1) == 0] <= 0).all()


def test_sort_payload_multiset():
    """num_keys=1 with a payload plane: keys exact, payload a multiset
    within each run of equal keys."""
    rng = np.random.default_rng(3)
    key = rng.integers(0, 50, (2, 1000)).astype(np.int32)
    pay = rng.integers(-1000, 1000, (2, 1000)).astype(np.int32)
    want, got = _check([key, pay], 1, exact=False)
    for b in range(2):
        for v in np.unique(want[0][b]):
            run = want[0][b] == v
            np.testing.assert_array_equal(np.sort(want[1][b][run]),
                                          np.sort(got[1][b][run]))
        # the plain version is stable
        order = np.argsort(key[b], kind="stable")
        np.testing.assert_array_equal(got[1][b], pay[b][order])


def test_sort_checks_its_operands():
    a = t(np.zeros((2, 8), np.int32))
    with pytest.raises(ValueError):
        sk.sort_tpu([a] * 4, num_keys=1)
    with pytest.raises(ValueError):
        sk.sort_tpu([a, a], num_keys=3)
    with pytest.raises(ValueError):
        sk.sort_tpu([a, t(np.zeros((2, 9), np.int32))], num_keys=1)
    with pytest.raises(ValueError):
        sk.sort_tpu([a.to(dtype=t(np.zeros(1)).dtype)], num_keys=1)
    assert [sk.padded_length(k) for k in (1, 256, 257, 1000, 131072)] == \
        [256, 256, 512, 1024, 131072]


def _network_case(kind: str, k: int):
    """(operands, num_keys) after tests/test_sort_pallas.py, most with
    payload planes (num_keys < len(operands))."""
    rng = np.random.default_rng(k)
    if kind == "random":
        return [rng.integers(0, 1 << 22, (3, k)).astype(np.int32)
                for _ in range(2)], 1
    if kind == "three_planes":
        return [rng.integers(0, 9, (2, k)).astype(np.int32),
                rng.integers(0, 4, (2, k)).astype(np.int32),
                rng.integers(-1000, 1000, (2, k)).astype(np.int32)], 2
    if kind == "sentinel":
        key = np.full((2, k), KEY_INVALID, np.int32)
        pack = np.zeros((2, k), np.int32)
        idx = rng.choice(k, 37, replace=False)
        key[:, idx] = rng.integers(0, 1 << 22, 37)
        pack[:, idx] = rng.integers(0, 1 << 28, 37)
        return [key, pack], 1
    if kind == "duplicate":
        return [rng.integers(0, 7, (2, k)).astype(np.int32),
                rng.integers(0, 5, (2, k)).astype(np.int32)], 1
    # the theta-sort pattern (seg << 20 | theta, pack3)
    seg = rng.integers(0, 257, (2, k)).astype(np.int32)
    theta = rng.integers(0, 1 << 20, (2, k)).astype(np.int32)
    return [(seg << 20) | theta,
            rng.integers(0, 1 << 22, (2, k)).astype(np.int32)], 1


@pytest.mark.parametrize("kind,k", [
    ("random", 128), ("random", 1000), ("random", 2048),
    ("three_planes", 512), ("three_planes", 1000),
    ("sentinel", 4096), ("duplicate", 2048), ("theta", 16384),
    ("three_planes", 16385), ("duplicate", 16385)])
def test_network_plain_matches_pallas(kind, k):
    """sort_network_plain equals the interpret-mode kernel bit for bit,
    payload order included; K = 16,385 pads to 32,768, a row that the
    card holds in a cluster of two blocks."""
    ops, num_keys = _network_case(kind, k)
    want = jsort([jnp.asarray(o) for o in ops], num_keys=num_keys,
                 interpret=True)
    got = sk.sort_network_plain([t(o) for o in ops], num_keys)
    assert len(got) == len(ops)
    for w, g in zip(want, got, strict=True):
        assert n(g).dtype == np.int32 and n(g).shape == ops[0].shape
        np.testing.assert_array_equal(n(w), n(g))


def _path_pattern(kind: str, k: int):
    """Every operand a key, as in each sort of cluster_and_fit."""
    rng = np.random.default_rng(k + len(kind))
    if kind == "duplicate":
        return [rng.integers(0, 7, (2, k)).astype(np.int32),
                rng.integers(0, 5, (2, k)).astype(np.int32)]
    if kind == "sentinel":
        key = np.full((2, k), KEY_INVALID, np.int32)
        key[:, ::97] = rng.integers(0, 1 << 22, (2, len(range(0, k, 97))))
        return [key, np.where(key == KEY_INVALID, 0, key & 0xFFF)
                .astype(np.int32)]
    # the peak sort: (segment, -errbits, pos) with a negative second key
    errs = rng.exponential(5.0, (2, k)).astype(np.float32)
    errs[:, ::7] = 0.0
    return [rng.integers(0, 1025, (2, k)).astype(np.int32),
            -errs.view(np.int32),
            np.tile(np.arange(k, dtype=np.int32), (2, 1))]


@pytest.mark.parametrize("kind", ["duplicate", "sentinel", "negative_key"])
@pytest.mark.parametrize("k", [8192, 32768, 131072])
def test_network_plain_equals_stable_sort_where_all_keys(kind, k):
    """At the path's widths, on its patterns, the network equals the
    stable sorts bit for bit when every operand is a key."""
    ops = [t(o) for o in _path_pattern(kind, k)]
    got = sk.sort_network_plain(ops, len(ops))
    want = sk.sort_plain(ops, len(ops))
    for w, g in zip(want, got, strict=True):
        np.testing.assert_array_equal(n(w), n(g))
    if kind == "negative_key":
        assert (n(got[1]) < 0).any()


@pytest.mark.parametrize("nops", [1, 2, 3])
@pytest.mark.parametrize("k", [8192, 32768, 131072])
def test_sort_plan_fits_one_launch(k, nops):
    """At every width of the path a row is one thread-block cluster of at
    most 8 blocks (the portable maximum), each within a block's 227 KB of
    shared memory and 1024 threads, a warp's span of E * 32 elements
    within a block where the cluster has more than one, and the call is
    one launch."""
    plan = sk.sort_plan(k, nops)
    assert plan.n == k and plan.launches == 1
    assert plan.tile * plan.cluster == plan.n
    assert 1 <= plan.cluster <= 8
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.threads * sk.ELEMS == plan.tile and plan.threads <= 1024
    assert plan.cluster == 1 or plan.tile >= 32 * sk.ELEMS
    assert plan.cluster == {8192: 1, 32768: 2, 131072: 8}[k]


@pytest.mark.parametrize("k", [1, 256, 1000, 16384, 131072, 131073, 262144,
                               1 << 20])
def test_sort_plan_multi_launch_only_past_one_cluster(k):
    """The device-memory launches start only above N = 131,072: one
    cluster launch, then per stage above it its strides >= 131,072 and one
    more cluster launch."""
    plan = sk.sort_plan(k, 3)
    big = 8 * sk.BLOCK_TILE
    if plan.n <= big:
        assert plan.launches == 1
        assert plan.tile == min(plan.n, sk.BLOCK_TILE)
    else:
        launches, size = 1, 2 * big
        while size <= plan.n:
            launches += (size // big).bit_length() - 1 + 1
            size *= 2
        assert plan.cluster == 8 and plan.launches == launches > 1


@pytest.fixture(scope="module")
def scene_points():
    """Boundary points of the 320x160 two-tag scene of
    tests/test_sort_pallas.py test_cluster_and_fit_bitonic_parity, from
    the JAX front half."""
    img, _ = render_scene(
        [3, 77], [simple_square_corners(80, 60, 34, angle_deg=-7),
                  simple_square_corners(220, 90, 40, angle_deg=25)],
        320, 160)
    g = jnp.asarray(img)[None]
    decim = jthr.decimate2(g)
    th, _ = jthr.adaptive_threshold(decim)
    _, _, ranks = jccl.label_components(th)
    cfg = jqf.QuadFitConfig(max_points=4096, max_segments=64, max_quads=8)
    pts, _ = jqf.boundary_points(th, ranks, cfg)
    return {k: np.asarray(v) for k, v in pts.items()}, np.asarray(decim)


def test_cluster_and_fit_pallas_sort(scene_points):
    """The port with use_pallas_sort equals its default configuration bit
    for bit, and the JAX package's use_pallas_sort path (Pallas sorts in
    interpret mode) on segments and tag corners."""
    pts, decim = scene_points
    kw = dict(max_points=4096, max_segments=64, max_quads=8)
    jcfg = jqf.QuadFitConfig(use_pallas_sort=True, **kw)
    jq = jax.jit(lambda p, d: jqf.cluster_and_fit(p, d, jcfg))(
        {k: jnp.asarray(v) for k, v in pts.items()}, jnp.asarray(decim))
    tpts = {k: t(v) for k, v in pts.items()}
    base = tqf.cluster_and_fit(tpts, t(decim), tqf.QuadFitConfig(**kw))
    got = tqf.cluster_and_fit(tpts, t(decim),
                              tqf.QuadFitConfig(use_pallas_sort=True, **kw))
    assert set(base) == set(got)
    for name in base:
        np.testing.assert_array_equal(n(base[name]), n(got[name]),
                                      err_msg=name)
    for key in ("seg", "count", "seg_ok"):
        np.testing.assert_array_equal(n(jq[key]), n(got[key]))
    want = n(jq["corners"])[0][n(jq["quad_valid"])[0]]
    have = n(got["corners"])[0][n(got["quad_valid"])[0]]
    assert len(want) == len(have) >= 2
    for c in want:
        err = np.abs(have - c[None]).reshape(len(have), -1).max(axis=1)
        assert err.min() <= 2e-3, err.min()


def test_config_from_jax_carries_use_pallas_sort():
    from ros_vision_tpu.apriltag.detector import DetectorConfig as JaxConfig
    from ros_vision_tpu_torch.apriltag.detector import config_from_jax
    for ups in (None, False, True):
        cfg = config_from_jax(dataclasses.asdict(
            JaxConfig(width=320, height=160, use_pallas_sort=ups)))
        assert cfg.use_pallas_sort is ups
        det = TorchDetector(cfg, device="cpu")
        assert det._qcfg.use_pallas_sort is bool(ups)
        assert det._qcfg_narrow.use_pallas_sort is bool(ups)


def test_detector_pallas_sort_bit_identical(monkeypatch):
    """A small TorchDetector with the switch on and off gives bit-identical
    packed outputs; with it on, cluster_and_fit's four sorts go through
    sort_tpu."""
    g, _ = bench_frames(320, 200, seeds=(0, 1), angles=(10, 20, -35, 50))
    kw = dict(width=320, height=200, fx=225.0, fy=225.0, cx=160.0,
              cy=100.0, max_points=4096, max_segments=128, max_quads=16)
    calls = []
    real = sk.sort_tpu

    def counting(ops, num_keys=1):
        calls.append((len(ops), num_keys))
        return real(ops, num_keys)

    monkeypatch.setattr(sk, "sort_tpu", counting)
    base = TorchDetector(DetectorConfig(**kw), device="cpu")
    want = n(base.detect_raw_packed(g))
    assert calls == []
    det = TorchDetector(DetectorConfig(use_pallas_sort=True, **kw),
                        device="cpu")
    got = n(det.detect_raw_packed(g))
    assert sorted(calls) == [(1, 1), (2, 2), (2, 2), (3, 3)]
    np.testing.assert_array_equal(want, got)
    assert want[..., 0].sum() > 0                     # some tag found

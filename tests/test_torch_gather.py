"""Parity of the K4 value histogram, the K10 table gather and the K11
segment min/max (ros_vision_tpu_torch/ops/gather_kernel.py) with
ops/gather_pallas value_histogram, table_take_cm and segment_min_max
(interpret mode) and their references: bit-exact, values outside [0, S)
not counted, indices outside [0, S) read 0, segment ids outside [0, S)
dropped; the K4 launch plan covers every bin once. K10 equals the
interpret-mode kernel on finite tables and table_take_cm_ref everywhere:
the TPU kernel's one-hot matmul turns -0.0 into +0.0 and spreads a
non-finite table entry over its 256-row chunk."""
import jax.numpy as jnp
import numpy as np
import pytest

from ros_vision_tpu.ops import gather_pallas as gp
from ros_vision_tpu_torch.ops import gather_kernel as gk
from tests.torch_port_helpers import n, t

S = 1025                       # max_segments + 1, as cluster_and_fit calls it


def _values(kind: str, b: int, k: int) -> np.ndarray:
    rng = np.random.default_rng(11)
    if kind == "uniform":
        return rng.integers(0, S, (b, k), dtype=np.int32)
    if kind == "out_of_range":
        return rng.integers(-40, S + 40, (b, k), dtype=np.int32)
    # sorted segment ids with a long overflow bucket, as after the
    # (key, payload) sort of cluster_and_fit
    v = np.sort(rng.integers(0, 300, (b, k)), axis=1).astype(np.int32)
    v[:, k // 2:] = S - 1
    return v


@pytest.mark.parametrize("kind", ["uniform", "out_of_range", "sorted_ids"])
@pytest.mark.parametrize("k", [2048, 8192])
def test_histogram_bit_exact(kind, k):
    v = _values(kind, 2, k)
    want = gp.value_histogram_ref(jnp.asarray(v), S)
    got = gk.histogram(t(v), S)
    assert got.dtype == gk.value_histogram_plain(t(v), S).dtype
    np.testing.assert_array_equal(n(want), n(got))
    if kind == "out_of_range":
        inside = ((v >= 0) & (v < S)).sum(axis=1)
        np.testing.assert_array_equal(n(got).sum(axis=1), inside)


def test_histogram_matches_pallas_interpret():
    v = _values("out_of_range", 2, 4096)
    want = gp.value_histogram(jnp.asarray(v), S, interpret=True)
    before = gk.launches.count
    got = gk.histogram(t(v), S)
    assert gk.launches.count == before          # CPU tensor: plain version
    np.testing.assert_array_equal(n(want), n(got))


def test_histogram_of_a_noncontiguous_view():
    v = _values("uniform", 2, 4096)
    wide = t(np.concatenate([v, v], axis=1))
    got = gk.histogram(wide[:, :4096], S)
    np.testing.assert_array_equal(n(gp.value_histogram_ref(
        jnp.asarray(v), S)), n(got))


@pytest.mark.parametrize("s", [1, 7, 8, 1025, 8192])
def test_histogram_plan(s):
    """One cluster of at most 8 blocks per row; the ranks' bin slices
    cover [0, S) once (each output bin written by exactly one block); the
    table fits a block's static 48 KB of shared memory; whole warps, as
    the kernel's __match_any_sync needs."""
    plan = gk.histogram_plan(s)
    assert 1 <= plan.cluster <= 8 and plan.threads <= 1024
    assert plan.threads % 32 == 0
    slices = [range(r * plan.bins_per_rank,
                    min(s, (r + 1) * plan.bins_per_rank))
              for r in range(plan.cluster)]
    assert sorted(i for sl in slices for i in sl) == list(range(s))
    assert plan.smem_bytes == 4 * s <= 48 * 1024
    if s == S:
        assert plan.bins_per_rank == 129


@pytest.mark.parametrize("s", [0, 8193])
def test_histogram_plan_refuses_what_one_table_cannot_hold(s):
    with pytest.raises(ValueError):
        gk.histogram_plan(s)


@pytest.mark.parametrize("k", [32768, 131072])
def test_histogram_at_the_path_widths(k):
    """The per-segment counts at the widths the detector runs K4 (1280x800
    and 1920x1080), on sorted ids with a sentinel tail."""
    v = _values("sorted_ids", 2, k)
    want = gp.value_histogram_ref(jnp.asarray(v), S)
    np.testing.assert_array_equal(n(want), n(gk.histogram(t(v), S)))


def _table_case(b=2, s=S, c=4, k=2048, seed=5):
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 100, (b, s, c)).astype(np.float32)
    idx = rng.integers(-30, s + 30, (b, k)).astype(np.int32)
    idx[:, :4] = [-1, s, np.iinfo(np.int32).max, np.iinfo(np.int32).min]
    return table, idx


@pytest.mark.parametrize("c", [1, 4, 9, 3, 5, 8])
def test_table_take_cm_bit_exact(c):
    table, idx = _table_case(c=c)
    want = n(gp.table_take_cm(jnp.asarray(table), jnp.asarray(idx),
                              interpret=True))
    np.testing.assert_array_equal(
        want, n(gp.table_take_cm_ref(jnp.asarray(table), jnp.asarray(idx))))
    before = gk.take_launches.count
    for fn in (gk.table_take_cm_plain, gk.take_cm):
        got = n(fn(t(table), t(idx)))
        assert got.dtype == np.float32 and got.shape == (2, c, 2048)
        np.testing.assert_array_equal(want, got)
    assert gk.take_launches.count == before      # CPU tensor: plain version
    np.testing.assert_array_equal(want[:, :, :4], 0.0)


@pytest.mark.parametrize("case, c", [("k2051", 4), ("all_out_of_range", 1),
                                     ("all_out_of_range", 4),
                                     ("all_out_of_range", 9)])
def test_table_take_cm_edges(case, c):
    """A K that is no multiple of 4 (the kernel's scalar path) and indices
    that all lie outside [0, S) (an output of zeros)."""
    table, idx = _table_case(c=c, k=2051)
    if case == "all_out_of_range":
        rng = np.random.default_rng(2)
        idx = rng.choice(np.array([-1, S, 2 ** 31 - 1, -(2 ** 31)]),
                         idx.shape).astype(np.int32)
    want = n(gp.table_take_cm(jnp.asarray(table), jnp.asarray(idx),
                              interpret=True))
    np.testing.assert_array_equal(
        want, n(gp.table_take_cm_ref(jnp.asarray(table), jnp.asarray(idx))))
    got = n(gk.take_cm(t(table), t(idx)))
    assert got.shape == (2, c, 2051)
    np.testing.assert_array_equal(want, got)
    if case == "all_out_of_range":
        assert (got == 0.0).all() and not np.signbit(got).any()


def test_table_take_cm_non_finite_follows_ref():
    """-0.0, inf and NaN are copied, as table_take_cm_ref does."""
    table, idx = _table_case(c=2, k=1024)
    table[0, 5] = [-0.0, np.inf]
    table[1, 700] = [np.nan, -np.inf]
    idx[0, 10:13] = 5
    idx[1, 10:13] = 700
    want = n(gp.table_take_cm_ref(jnp.asarray(table), jnp.asarray(idx)))
    got = n(gk.take_cm(t(table), t(idx)))
    np.testing.assert_array_equal(want, got)
    assert np.signbit(got[0, 0, 10]) and np.isposinf(got[0, 1, 10])
    assert np.isnan(got[1, 0, 10]) and np.isneginf(got[1, 1, 10])
    # the TPU kernel's one-hot product differs there
    tpu = n(gp.table_take_cm(jnp.asarray(table), jnp.asarray(idx),
                             interpret=True))
    assert not np.signbit(tpu[0, 0, 10])


def test_table_take_cm_of_noncontiguous_views():
    table, idx = _table_case(c=4, k=2048)
    wide = t(np.concatenate([idx, idx], axis=1))[:, ::2]
    tab_t = t(np.ascontiguousarray(table.transpose(0, 2, 1))).transpose(1, 2)
    assert not wide.is_contiguous() and not tab_t.is_contiguous()
    want = n(gp.table_take_cm_ref(jnp.asarray(table),
                                  jnp.asarray(np.concatenate(
                                      [idx, idx], axis=1)[:, ::2])))
    np.testing.assert_array_equal(want, n(gk.take_cm(tab_t, wide)))


# kind -> (B, K, S): a K that is no multiple of 4 or 8 (the kernel's
# scalar path), one row, one segment, and S above segment_plan's cap of
# segments a cluster holds (two slices)
MINMAX_SHAPES = {"ragged_k": (2, 4098, S), "one_row": (1, 4096, S),
                 "one_segment": (2, 4096, 1),
                 "above_cap": (2, 4096, gk.SEG_MAX_SLICE + 1)}


def _minmax_case(kind, b=2, k=4096, seed=9, s=S):
    rng = np.random.default_rng(seed)
    seg = rng.integers(-20, s + 20, (b, k)).astype(np.int32)
    if kind == "sorted":
        seg = np.sort(rng.integers(0, 300, (b, k)), axis=1).astype(np.int32)
    val = rng.integers(-(2 ** 31), 2 ** 31 - 1, (b, k),
                       dtype=np.int64).astype(np.int32)
    if kind == "small":
        val = rng.integers(-5000, 5000, (b, k)).astype(np.int32)
    return seg, val


@pytest.mark.parametrize("kind", ["wide", "small", "sorted",
                                  *MINMAX_SHAPES])
def test_segment_min_max_bit_exact(kind):
    b, k, s = MINMAX_SHAPES.get(kind, (2, 4096, S))
    seg, val = _minmax_case(kind, b, k, s=s)
    want = gp.segment_min_max(jnp.asarray(seg), jnp.asarray(val), s,
                              interpret=True)
    ref = gp.segment_min_max_ref(jnp.asarray(seg), jnp.asarray(val), s)
    before = gk.minmax_launches.count
    for fn in (gk.segment_min_max_plain, gk.segment_min_max):
        got = fn(t(seg), t(val), s)
        for w, r, g in zip(want, ref, got, strict=True):
            assert n(g).dtype == np.int32 and n(g).shape == (b, s)
            np.testing.assert_array_equal(n(w), n(g))
            np.testing.assert_array_equal(n(r), n(g))
    assert gk.minmax_launches.count == before
    mn, mx = (n(x) for x in want)
    # values past +-2^30 are clamped; empty segments read +-2^30
    if s == 1:
        # the one segment holds values past -2^30 and past 2^30
        assert (mn < -2 ** 30).all() and (mx > 2 ** 30).all()
    else:
        assert mn.max() == 2 ** 30 and mx.min() == -2 ** 30
    if kind == "sorted":
        assert (mn[:, 300:] == 2 ** 30).all() and (mx[:, 300:] == -2 ** 30).all()


def test_segment_min_max_of_noncontiguous_views():
    seg, val = _minmax_case("small")
    wseg = t(np.concatenate([seg, seg], axis=1))[:, :4096]
    wval = t(np.concatenate([val, val], axis=1))[:, :4096]
    assert not wseg.is_contiguous()
    want = gp.segment_min_max_ref(jnp.asarray(seg), jnp.asarray(val), S)
    for w, g in zip(want, gk.segment_min_max(wseg, wval, S), strict=True):
        np.testing.assert_array_equal(n(w), n(g))

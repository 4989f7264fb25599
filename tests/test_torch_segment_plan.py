"""K11 segment_min_max of csrc/segment.cu on the CPU: its launch plan
(ops/gather_kernel.py segment_plan) and a numpy emulation of the kernel's
block logic, held bit-exact against the JAX gather_pallas.segment_min_max
in interpret mode and segment_min_max_ref. The card runs the kernel itself
(chip_smoke.py); the emulation follows its indexing step by step, so that
a chunk, run or table bug shows here without a card.

One cluster of R blocks takes a (row, slice of segments): block rank r
starts both tables of the slice at +-2^30 (every block's start precedes
every push, as the kernel's split cluster barrier ensures), takes points [r * chunk,
(r + 1) * chunk) of the row in steps of threads x SEG_ITEMS, each thread
SEG_ITEMS consecutive points (-1, outside every slice, past the chunk),
folds runs of equal ids in registers, adds every run but its last to its
tables, and merges the last runs of each group of neighbouring lanes of a
warp that hold the same in-slice id into one update. Block rank r owns
segments [r * per_rank, (r + 1) * per_rank) of the slice: every entry a
block changed outside its own goes to its owner's tables, and each owner
writes its segments once.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from ros_vision_tpu.ops import gather_pallas as gp
from ros_vision_tpu_torch.ops import gather_kernel as gk

BIG = 2 ** 30
ITEMS = gk.SEG_ITEMS
CAP = gk.SEG_MAX_SLICE


@pytest.mark.parametrize("s", [1, 1025, CAP + 1])
@pytest.mark.parametrize("k", [1, 4097, 131072])
@pytest.mark.parametrize("b", [1, 4, 12])
def test_segment_plan(b, k, s):
    """Every point in exactly one block's chunk (16-byte groups from each
    chunk's start), every segment owned by exactly one (slice, rank), both
    tables of a slice in a block's 48 KB of shared memory, whole warps, R a
    power of two up to 16 and B x slices x R within the 132 SMs."""
    plan = gk.segment_plan(b, k, s)
    r = plan.cluster
    assert 1 <= r <= 16 and r & (r - 1) == 0
    assert b * plan.slices * r <= gk.SEG_SMS or r == 1
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert plan.chunk % 4 == 0
    owner = np.zeros(k, int)
    for rank in range(r):
        lo = min(k, rank * plan.chunk)
        owner[lo:min(k, lo + plan.chunk)] += 1
    assert (owner == 1).all()
    seen = np.zeros(s, int)
    for z in range(plan.slices):
        s0 = z * plan.segs_per_slice
        ns = min(plan.segs_per_slice, s - s0)
        assert ns >= 1
        for rank in range(r):
            lo = rank * plan.segs_per_rank
            seen[s0 + lo:s0 + min(ns, lo + plan.segs_per_rank)] += 1
    assert (seen == 1).all()
    assert plan.smem_bytes == 8 * plan.segs_per_slice <= 48 * 1024
    if s <= CAP:
        assert plan.slices == 1
    if b == 4 and k == 131072:
        assert r == 16 and plan.chunk == 8192
        assert plan.threads == min(1024, 8192 // ITEMS)


def test_segment_plan_refuses_what_it_cannot_reduce():
    for shape in [(0, 5, 5), (1, -1, 5), (1, 5, 0)]:
        with pytest.raises(ValueError):
            gk.segment_plan(*shape)


def emulate(seg: np.ndarray, val: np.ndarray, s: int, plan) -> tuple:
    """K11 block by block and warp by warp -> (mn, mx); checks that every
    output entry is written exactly once."""
    b, k = seg.shape
    r_count, per_slice = plan.cluster, plan.segs_per_slice
    mn = np.zeros((b, s), np.int64)
    mx = np.zeros((b, s), np.int64)
    writes = np.zeros((b, s), int)
    lane = np.arange(plan.threads)
    for row in range(b):
        for z in range(plan.slices):
            s0 = z * per_slice
            ns = min(per_slice, s - s0)
            tmin = np.full((r_count, ns), BIG, np.int64)
            tmax = np.full((r_count, ns), -BIG, np.int64)
            for rank in range(r_count):
                lo_pt = min(k, rank * plan.chunk)
                hi_pt = min(k, lo_pt + plan.chunk)
                for base in range(lo_pt, hi_pt, plan.threads * ITEMS):
                    p = base + lane[:, None] * ITEMS + np.arange(ITEMS)
                    inside = p < hi_pt
                    at = np.minimum(p, k - 1)
                    ids = np.where(inside, seg[row, at], -1).astype(np.int64)
                    v = np.where(inside, val[row, at], 0).astype(np.int64)
                    local = ids - s0
                    in_slice = (local >= 0) & (local < ns)
                    start = np.ones(ids.shape, bool)
                    start[:, 1:] = ids[:, 1:] != ids[:, :-1]
                    run = np.cumsum(start, axis=1)
                    last = run == run[:, -1:]
                    # every run but the thread's last: straight to the
                    # block's tables
                    hit = in_slice & ~last
                    np.minimum.at(tmin[rank], local[hit], v[hit])
                    np.maximum.at(tmax[rank], local[hit], v[hit])
                    # the last runs, merged over each group of
                    # neighbouring lanes of a warp that hold the same
                    # in-slice id; one update a group
                    key = np.where(in_slice[:, -1], local[:, -1], -1)
                    lo = np.where(last, v, BIG * 4).min(axis=1)
                    hi = np.where(last, v, -BIG * 4).max(axis=1)
                    for w0 in range(0, plan.threads, 32):
                        wk, wlo, whi = (a[w0:w0 + 32] for a in (key, lo, hi))
                        heads = np.flatnonzero(np.r_[True, wk[1:] != wk[:-1]])
                        for g0, g1 in zip(heads, np.r_[heads[1:], 32]):
                            g = wk[g0]
                            if g >= 0:
                                tmin[rank, g] = min(tmin[rank, g],
                                                    wlo[g0:g1].min())
                                tmax[rank, g] = max(tmax[rank, g],
                                                    whi[g0:g1].max())
            # each block's changed entries outside its own segments go to
            # their owner's tables
            per_rank = plan.segs_per_rank
            owner = np.arange(ns) // per_rank
            for rank in range(r_count):
                push = owner != rank
                for q in range(r_count):
                    sel = push & (owner == q)
                    tmin[q, sel] = np.minimum(tmin[q, sel], tmin[rank, sel])
                    tmax[q, sel] = np.maximum(tmax[q, sel], tmax[rank, sel])
            for rank in range(r_count):
                own = slice(rank * per_rank, min(ns, (rank + 1) * per_rank))
                cols = np.arange(s0, s0 + ns)[own]
                mn[row, cols] = tmin[rank, own]
                mx[row, cols] = tmax[rank, own]
                writes[row, cols] += 1
    assert (writes == 1).all(), "an output entry written other than once"
    return mn.astype(np.int32), mx.astype(np.int32)


def _case(kind: str, b: int, k: int, s: int, seed: int = 9):
    rng = np.random.default_rng(seed)
    val = rng.integers(-(2 ** 31), 2 ** 31 - 1, (b, k),
                       dtype=np.int64).astype(np.int32)
    seg = rng.integers(-20, s + 20, (b, k)).astype(np.int32)
    if kind == "small":
        val = rng.integers(-5000, 5000, (b, k)).astype(np.int32)
    elif kind == "sorted":
        # runs of every length, a long overflow bucket as cluster_and_fit
        # gives it, and runs crossing thread, warp and chunk borders
        seg = np.sort(rng.integers(0, min(s, 300), (b, k)), axis=1)
        seg[:, k // 2:] = s - 1
        seg = seg.astype(np.int32)
    elif kind == "out_of_range":
        seg = rng.choice(np.array([-1, s, 2 ** 31 - 1, -(2 ** 31)]),
                         (b, k)).astype(np.int32)
    return seg, val


# (kind, B, K, S, plan change): the plan's own shapes, and plans of few
# threads, so that blocks take several steps and warps several runs
CASES = {
    "wide": ("wide", 2, 4096, 1025, {}),
    "small": ("small", 2, 4096, 1025, {}),
    "sorted": ("sorted", 2, 4096, 1025, {}),
    "sorted_steps": ("sorted", 2, 4096, 1025,
                     {"cluster": 2, "chunk": 2048, "threads": 32,
                      "segs_per_rank": 513}),
    "out_of_range": ("out_of_range", 2, 4096, 1025, {}),
    "multi_slice": ("wide", 2, 4096, CAP + 1, {}),
    "ragged_k": ("wide", 2, 4098, 1025, {"threads": 32}),
    "one_segment": ("sorted", 2, 4096, 1, {}),
}
# the shapes whose interpret-mode parity tests/test_torch_gather.py holds
# already: here only against segment_min_max_ref
REF_ONLY = {"ragged_k", "one_segment"}


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_segment_min_max_bit_exact(case):
    kind, b, k, s, change = CASES[case]
    seg, val = _case(kind, b, k, s)
    plan = dataclasses.replace(gk.segment_plan(b, k, s), **change)
    got = emulate(seg, val, s, plan)
    wants = [gp.segment_min_max_ref(jnp.asarray(seg), jnp.asarray(val), s)]
    if case not in REF_ONLY:
        wants.append(gp.segment_min_max(jnp.asarray(seg), jnp.asarray(val),
                                        s, interpret=True))
    for want in wants:
        for w, g in zip(want, got, strict=True):
            np.testing.assert_array_equal(np.asarray(w), g)
    if kind == "out_of_range":
        assert (got[0] == BIG).all() and (got[1] == -BIG).all()
    if case == "multi_slice":
        assert plan.slices == 2
    if change:
        assert plan.chunk > plan.threads * ITEMS       # several steps

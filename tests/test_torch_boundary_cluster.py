"""K3 boundary_compact as csrc/boundary.cu runs it, on the CPU: its launch
plan (ops/frontend_kernel.py boundary_plan) and a numpy emulation of the
kernel's cluster phases, held bit-exact (key, pack2, counts) against the
port's quadfit.boundary_points_capped, the interpret-mode JAX
frontend_pallas.boundary_compact where the frame is lane-aligned, and the
JAX quadfit.boundary_points path otherwise. The card runs the kernel
itself (chip_smoke.py); the emulation follows its block spans, per-warp
counts and offsets, thinning targets across the pm slices, per-direction
slice counts and fills step by step, so that a split or offset bug shows
here without a card.

Phases (one cluster of C blocks per frame): 1. block r computes the bits
of pixels [r*span, (r+1)*span) and counts the emitting ones per chunk of
threads*4 pixels and warp; 2. the C block totals give each block its
offset and the frame total; 3. kept pixels go to their thinned targets in
pm, which lies in slices of `slice` slots over the blocks and whose
written slots are exactly [0, kept); 4. block r counts the candidates of
its C-th share of those slots (cut at multiples of 4) per direction,
chunk and warp; 5. the 4 x C counts give each (direction, block) its
dir-major offset and the total; 6. kept candidates go to key / pack2, the
blocks fill the tail, rank 0 the count.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from ros_vision_tpu.ops import ccl as jccl
from ros_vision_tpu.ops import frontend_pallas as fp
from ros_vision_tpu_torch.ops import frontend_kernel as fk
from ros_vision_tpu_torch.ops import quadfit as tqf
from tests.test_frontend_pallas import _boundary_ref
from tests.test_torch_frontend import _threshim
from tests.torch_port_helpers import (checkerboard, n, random_threshim,
                                      small_scene, t)

KEY_INVALID = 1 << 22
UNWRITTEN = np.iinfo(np.int64).min
DX = (1, 0, -1, 1)
DY = (0, 1, 1, 1)
F32 = np.float32


def thin_ratio(total: int, cap: int) -> np.float32:
    return min(F32(1), F32(cap - 2) / max(F32(total), F32(1)))


def thin_keep(slot: int, r: np.float32):
    """(keep, target) in f32, one rounding per operation as the kernel."""
    s = F32(slot)
    here = np.floor(s * r)
    return bool(np.floor((s + F32(1)) * r) > here), int(here)


def kept_total(total: int, cap: int) -> int:
    return int(np.floor(F32(total) * thin_ratio(total, cap)))


def boundary_bits(th: np.ndarray, rk: np.ndarray) -> np.ndarray:
    """csrc/boundary.cu boundary_bits at every pixel of an (H, W) frame:
    the threshold bytes first, the ranks only where a direction can
    emit."""
    h, w = th.shape
    v = th.astype(np.int32)
    out = np.zeros((h, w), np.int32)
    inner = (slice(1, h - 1), slice(1, w - 1))
    for d in range(4):
        nv = np.roll(v, (-DY[d], -DX[d]), axis=(0, 1))
        nr = np.roll(rk, (-DY[d], -DX[d]), axis=(0, 1))
        ok = (v + nv == 255) & (rk > 0) & (nr > 0)
        ok[:1], ok[-1:], ok[:, :1], ok[:, -1:] = False, False, False, False
        bit = ok.astype(np.int32) << d | (ok & (nv > v)).astype(np.int32) \
            << (4 + d)
        out[inner] |= bit[inner]
    return out


def warp_slots(flags: np.ndarray, threads: int) -> tuple:
    """Per element of a block's (padded) range, its exclusive rank among
    the flagged ones the way the kernel forms it: per-(chunk, warp)
    counts scanned over the block, then the thread's exclusive prefix
    within its warp, then the element's within its thread's 4. ->
    (ranks, block total)."""
    nw = threads // 32
    per_warp = flags.reshape(-1, 32, fk.BOUNDARY_ITEMS).astype(np.int64)
    wc = per_warp.sum(axis=(1, 2))
    assert wc.size % nw == 0
    wc_ex = np.cumsum(wc) - wc
    th_cnt = per_warp.sum(axis=2)
    th_ex = np.cumsum(th_cnt, axis=1) - th_cnt
    it_ex = np.cumsum(per_warp, axis=2) - per_warp
    ranks = wc_ex[:, None, None] + th_ex[:, :, None] + it_ex
    return ranks.reshape(-1), int(wc.sum())


def plan_for(h: int, w: int, pc: int, cluster: int):
    """The launch plan with `cluster` blocks a frame: boundary_plan's for
    its own size, else its layout rule (spans of whole 16-byte groups, slices
    of whole int4s) at that cluster size; the launcher takes 1 to 8."""
    plan = fk.boundary_plan(h, w, pc)
    if cluster == plan.cluster:
        return plan
    return dataclasses.replace(
        plan, cluster=cluster, span=-(-(-(-h * w // cluster)) // 16) * 16,
        slice=-(-(-(-pc // cluster)) // 4) * 4, smem_bytes=None)


def emulate(th: np.ndarray, rk: np.ndarray, pc: int, k_cap: int,
            cluster: int):
    """The kernel's phases on one (H, W) frame -> (key, pack2, count)."""
    h, w = th.shape
    npx = h * w
    plan = plan_for(h, w, pc, cluster)
    c, span, slc = plan.cluster, plan.span, plan.slice
    chunk = plan.threads * fk.BOUNDARY_ITEMS
    bits = boundary_bits(th, rk).reshape(-1)
    # 1. bits and counts of each block's pixels
    blocks = []
    for r in range(c):
        lo = r * span
        owned = max(0, min(span, npx - lo))
        b = np.zeros(-(-span // chunk) * chunk, np.int32)
        b[:owned] = bits[lo:lo + owned]
        slots, total = warp_slots((b & 0xF) != 0, plan.threads)
        blocks.append((lo, b, slots, total))
    # 2. offsets and the frame total
    totals = [blk[3] for blk in blocks]
    total_a = sum(totals)
    ra, kept_a = thin_ratio(total_a, pc), kept_total(total_a, pc)
    # 3. stage-A targets into the slices
    pm = np.full((c, slc), UNWRITTEN, np.int64)
    for r, (lo, b, slots, _) in enumerate(blocks):
        off = sum(totals[:r])
        for i in np.flatnonzero(b & 0xF):
            keep, tgt = thin_keep(off + int(slots[i]), ra)
            if keep:
                s = tgt // slc
                assert pm[s, tgt - s * slc] == UNWRITTEN, "target written twice"
                y, x = divmod(lo + int(i), w)
                pm[s, tgt - s * slc] = ((y << 11 | x) << 8) | int(b[i])
    flat = pm.reshape(-1)
    assert (flat[:kept_a] != UNWRITTEN).all(), \
        "a slot below kept(T_A) was never written"
    assert (flat[kept_a:] == UNWRITTEN).all(), "a slot past kept(T_A) written"
    # 4. block r's share [b_lo, b_hi) of the valid slots [0, kept(T_A)),
    # cut at multiples of 4; its candidates per direction
    cuts = [(r * kept_a // c) & ~3 for r in range(c)] + [kept_a]
    counts_b = np.zeros((4, c), np.int64)
    slots_b = {}
    for r in range(c):
        b_lo, b_hi = cuts[r], cuts[r + 1]
        assert b_lo % 4 == 0 and 0 <= b_hi - b_lo <= slc + 4
        v = np.full(-(-(slc + 4) // chunk) * chunk, -1, np.int64)
        v[:b_hi - b_lo] = flat[b_lo:b_hi]
        for d in range(4):
            ok = (v >= 0) & (((v >> d) & 1) == 1)
            ranks, counts_b[d, r] = warp_slots(ok, plan.threads)
            slots_b[r, d] = (ok, v, ranks)
    # 5. dir-major offsets and the total
    total_b = int(counts_b.sum())
    rb, kept_b = thin_ratio(total_b, k_cap), kept_total(total_b, k_cap)
    key = np.full(k_cap, UNWRITTEN, np.int64)
    pack2 = np.full(k_cap, UNWRITTEN, np.int64)
    # 6. stage-B write, the shared fill, the count
    for r in range(c):
        for d in range(4):
            ok, v, slots = slots_b[r, d]
            off = int(counts_b[:d].sum() + counts_b[d, :r].sum())
            for i in np.flatnonzero(ok):
                keep, tgt = thin_keep(off + int(slots[i]), rb)
                if not keep:
                    continue
                word = int(v[i])
                py, px = (word >> 19) & 0x7FF, (word >> 8) & 0x7FF
                g = 1 if (word >> (4 + d)) & 1 else -1
                ra_, rb_ = rk[py, px], rk[py + DY[d], px + DX[d]]
                assert key[tgt] == UNWRITTEN, "point target written twice"
                key[tgt] = (min(ra_, rb_) - 1) << 11 | (max(ra_, rb_) - 1)
                pack2[tgt] = ((2 * px + DX[d]) << 15
                              | (2 * py + DY[d]) << 4
                              | (DX[d] * g + 1) << 2 | (DY[d] * g + 1))
    for r in range(c):
        fill = np.arange(kept_b + r * plan.threads, k_cap,
                         c * plan.threads)
        fill = (fill[:, None] + np.arange(plan.threads)).reshape(-1)
        fill = fill[fill < k_cap]
        assert (key[fill] == UNWRITTEN).all(), "fill over a point"
        key[fill], pack2[fill] = KEY_INVALID, 0
    assert (key != UNWRITTEN).all() and (pack2 != UNWRITTEN).all()
    return key.astype(np.int32), pack2.astype(np.int32), kept_b


def _scene2():
    return _threshim(np.concatenate([small_scene(0), small_scene(1)]))


def _straddle():
    """(1, 64, 128): 8x16 black/white blocks, so that every 8-row block
    span of the 8-block plan (1,024 px) starts and ends on emitting
    rows."""
    yy, xx = np.mgrid[:64, :128]
    return np.where((yy // 8 + xx // 16) % 2, 255, 0).astype(np.uint8)[None]


CASES = {
    "scene": (_scene2, 25),                                  # (2, 64, 128)
    "ragged_540": (lambda: random_threshim(1, 540, 100, seed=6), 25),
    "straddle": (_straddle, 25),
    # 2x2-px blobs: thousands of blob pairs, both caps overflow
    "overflow": (lambda: _threshim(checkerboard(256, 512, 4, 0.1, 1)), 4),
}
CAPS = [(1536, 2048), (256, 2048), (1536, 384), (192, 256)]


def _ranks(th: np.ndarray, min_blob: int) -> np.ndarray:
    return n(fk.label_components_plain(t(th), min_blob)[2]).reshape(th.shape)


@pytest.mark.parametrize("cluster", [1, 8, 16])
@pytest.mark.parametrize("caps", CAPS, ids=[f"p{p}_k{k}" for p, k in CAPS])
@pytest.mark.parametrize("case", list(CASES))
def test_cluster_emulation_bit_exact(case, caps, cluster):
    make, min_blob = CASES[case]
    th = make()
    b, h, w = th.shape
    rk = _ranks(th, min_blob)
    p_cap, k_cap = caps
    pc = tqf.boundary_block_rows(p_cap, w) * w
    pts, counts = tqf.boundary_points_capped(t(th), t(rk).view(b, -1),
                                             p_cap, k_cap)
    jth, jrk = jnp.asarray(th), jnp.asarray(rk)
    if w % 128 == 0 and h % 8 == 0:
        jkey, jpack2, jcounts = fp.boundary_compact(jth, jrk, p_cap, k_cap,
                                                    interpret=True)
        jkey, jpack2 = n(jkey)[:, :k_cap], n(jpack2)[:, :k_cap]
    else:
        jpts, jcounts = _boundary_ref(jth, jrk.reshape(b, -1), p_cap, k_cap)
        jkey, jpack2 = n(jpts["key"]), n(jpts["pack2"])
    np.testing.assert_array_equal(n(pts["key"]), jkey)
    np.testing.assert_array_equal(n(pts["pack2"]), jpack2)
    np.testing.assert_array_equal(n(counts), n(jcounts))
    for i in range(b):
        key, pack2, count = emulate(th[i], rk[i], pc, k_cap, cluster)
        np.testing.assert_array_equal(key, jkey[i])
        np.testing.assert_array_equal(pack2, jpack2[i])
        assert count == int(n(counts)[i])


def test_cases_do_what_they_are_for():
    """The straddle frame emits on both sides of every block split; the
    overflow frame overflows both caps at the smallest caps; the ragged
    frame's height is no multiple of 8."""
    th = _straddle()[0]
    plan = fk.boundary_plan(*th.shape, 1536)
    bits = boundary_bits(th, _ranks(th[None], 25)[0]).reshape(-1)
    for r in range(1, plan.cluster):
        split = r * plan.span
        assert bits[split - 64:split].any() and bits[split:split + 64].any()
    th = CASES["overflow"][0]()
    rk = _ranks(th, 4)
    emitting = int(((boundary_bits(th[0], rk[0]) & 0xF) != 0).sum())
    assert emitting > tqf.boundary_block_rows(192, th.shape[2]) * th.shape[2]
    assert CASES["ragged_540"][0]().shape[1] % 8 != 0


def _pc_max(w: int) -> int:
    """The largest stage-A cap any p_cap gives at width w (the
    307,200-element clamp of boundary_block_rows)."""
    return tqf.boundary_block_rows(10 ** 9, w) * w


def test_plan_fits_every_legal_frame():
    """Every frame size the launcher takes (1 to 1023 a side), at the
    largest stage-A cap of its width: the layout the launcher checks, and
    shared memory within the 227 KB a block may opt in to."""
    worst = 0
    for w in range(1, 1024):
        pc = _pc_max(w)
        assert pc <= 76_800
        for h in range(1, 1024):
            plan = fk.boundary_plan(h, w, pc)
            worst = max(worst, plan.smem_bytes)
    assert worst <= fk.SMEM_LIMIT
    plan = fk.boundary_plan(1023, 1023, _pc_max(1023))
    assert plan.smem_bytes == worst


@pytest.mark.parametrize("h,w,pc", [
    (400, 640, 25_600), (540, 960, 76_800), (37, 53, 24_592),
    (541, 963, 69_336), (1, 1, 1), (1023, 1023, 73_656)])
def test_plan_fits_the_launchers_layout(h, w, pc):
    """What rvt_boundary_compact requires of a plan."""
    plan = fk.boundary_plan(h, w, pc)
    assert plan.cluster == fk.BOUNDARY_CLUSTER <= 16
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert plan.span % 16 == 0 and plan.span * plan.cluster >= h * w
    assert plan.slice % 4 == 0 and plan.slice * plan.cluster >= pc
    assert plan.span - 16 < -(-h * w // plan.cluster)
    chunk, warps = plan.threads * fk.BOUNDARY_ITEMS, plan.threads // 32
    assert plan.smem_bytes == 4 * (
        plan.slice + -(-plan.span // chunk) * warps
        + 4 * -(-(plan.slice + 4) // chunk) * warps + 8) \
        + 2 * (plan.span + fk.STAGE_HALO)
    assert plan.args() == (plan.cluster, plan.threads, plan.span,
                           plan.slice, plan.smem_bytes)


@pytest.mark.parametrize("h,w,pc", [
    (0, 5, 10), (5, 0, 10), (1024, 5, 10), (5, 1024, 10), (100, 100, 0),
    (1000, 1000, 1_000_000), (1023, 1023, 600_000)])
def test_plan_refuses_what_the_launcher_rejects(h, w, pc):
    with pytest.raises(ValueError):
        fk.boundary_plan(h, w, pc)


def test_wrapper_refuses_large_frames():
    th = np.zeros((1, 8, 1024), np.uint8)
    rk = np.zeros((1, 8, 1024), np.int32)
    with pytest.raises(ValueError):
        fk.boundary_compact(t(th), t(rk), 100, 100)


def test_pallas_ranks_agree_with_the_plain_ranks():
    """The emulation takes K2's plain ranks; on the scene they are the
    JAX ranks."""
    th = _scene2()
    _, _, jr = jccl.label_components(jnp.asarray(th))
    np.testing.assert_array_equal(n(jr).reshape(th.shape), _ranks(th, 25))

"""Boundary extraction + quad fitting (PyTorch).

Counterpart of ros_vision_tpu/ops/quadfit.py, same fixed-shape algorithm
and the same f32 numerical scheme (per-segment coordinate centering,
1/256-scaled gradient weights): boundary points of big blob pairs,
compacted and uniformly thinned to K slots; segment tables from a sort by
(blob-pair key, payload); a theta sort within segments; windowed line-fit
errors from segmented prefix sums; 7-tap smoothing, <= 10 maxima per
segment, the 45 pair fits and 210 quad combinations; corners of the best
combination. The two histograms go through K4 (ops/gather_kernel.py).
Cumsums and gathers stay PyTorch ops, as they stayed XLA ops in the JAX
package. The four sorts follow cfg.use_pallas_sort as in the JAX
package: off, every lax.sort becomes a stable torch.sort (each multi-key
sort sorts one int64 packing of its int32 keys); on, all four go through
K9 (ops/sort_kernel.py sort_tpu), with every operand a key, so the two
configurations give bit-identical outputs.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ros_vision_tpu_torch.ops import mathf, scan
from ros_vision_tpu_torch.ops import segments as segs
from ros_vision_tpu_torch.ops import sort_kernel
from ros_vision_tpu_torch.ops.gather_kernel import histogram

MIN_BLOB_PIXELS = 25
MIN_CLUSTER_POINTS = 24
ERRS_STABLE_MIN_SZ = 2048
MAX_NMAXIMA = 10
MAX_LINE_FIT_MSE = 10.0
COS_CRITICAL_RAD = math.cos(10 * math.pi / 180)
WEIGHT_SCALE = 1.0 / 256.0
N_PAIRS = 45
N_COMBOS = 210
_BIGI = 2 ** 30

_PAIR_IDX = np.full((MAX_NMAXIMA, MAX_NMAXIMA), -1, np.int64)
for _i, (_a, _b) in enumerate(itertools.combinations(range(MAX_NMAXIMA), 2)):
    _PAIR_IDX[_a, _b] = _i
_COMBOS = np.array(list(itertools.combinations(range(MAX_NMAXIMA), 4)),
                   np.int64)  # (210, 4)
_COMBO_PAIRS = np.stack([
    _PAIR_IDX[_COMBOS[:, 0], _COMBOS[:, 1]],
    _PAIR_IDX[_COMBOS[:, 1], _COMBOS[:, 2]],
    _PAIR_IDX[_COMBOS[:, 2], _COMBOS[:, 3]],
    _PAIR_IDX[_COMBOS[:, 0], _COMBOS[:, 3]],   # edge 3->0 uses the reverse fit
], axis=1)  # (210, 4)
_PAIR_A = np.array([a for a, _ in itertools.combinations(range(10), 2)])
_PAIR_B = np.array([b for _, b in itertools.combinations(range(10), 2)])


@dataclasses.dataclass(frozen=True)
class QuadFitConfig:
    max_points: int = 131072     # K: boundary points kept per frame
    max_segments: int = 1024     # NSEG: blob-pair clusters per frame
    max_quads: int = 128         # NQ: quads emitted per frame
    tag_width: int = 4           # min tag width in decimated px
    normal_border: bool = True
    reversed_border: bool = False
    use_pallas_sort: bool = False  # the four sorts through K9

    @property
    def max_boundary_pixels(self) -> int:
        """First-stage compaction cap: pixels that emit any boundary point
        (each such pixel emits 1-4 points; ~2 on average)."""
        return (3 * self.max_points) // 4


RANK_BITS = 11
KEY_INVALID = 1 << (2 * RANK_BITS)

# The Pallas routing kernels of the JAX package compile only for planes up
# to ~307k int32 elements, so the stage-A cap is clamped to keep the
# (BR, 4W) stage-B plane under it. The clamp was a compiler limit but it
# decides which points a saturated frame keeps, so it is part of the
# output contract and the port keeps it.
_ROUTE_MAX_ELEMS = 307_200


def boundary_block_rows(p_cap: int, w: int) -> int:
    """Stage-A pixel rows (8-aligned) for pixel cap `p_cap` at width `w`."""
    rows = -(-(-(-p_cap // w)) // 8) * 8
    return min(rows, (_ROUTE_MAX_ELEMS // (4 * w)) // 8 * 8)


def pack_payload(x2, y2, gx, gy):
    """x-major point payload: sorted within a blob-pair key it gives
    xmin/xmax as the first/last element of each segment."""
    return (x2 << 15) | (y2 << 4) | ((gx + 1) << 2) | (gy + 1)


def unpack_payload(p):
    return p >> 15, (p >> 4) & 0x7FF, ((p >> 2) & 0x3) - 1, (p & 0x3) - 1


def fit_line_f32(m: torch.Tensor, n: torch.Tensor) -> dict:
    """Line fit from window moments m[..., 6] = [Mx, My, Mxx, Mxy, Myy, W]
    and point count n: ex, ey, nx, ny (normal), err, mse."""
    w = m[..., 5]
    w = torch.where(w == 0, 1e-12, w)
    ex = m[..., 0] / w
    ey = m[..., 1] / w
    cxx = m[..., 2] / w - ex * ex
    cxy = m[..., 3] / w - ex * ey
    cyy = m[..., 4] / w - ey * ey
    theta = 0.5 * mathf.atan2(-2 * cxy, cyy - cxx)
    nx = mathf.cos(theta)
    ny = mathf.sin(theta)
    mse = nx * nx * cxx + 2 * nx * ny * cxy + ny * ny * cyy
    return {"ex": ex, "ey": ey, "nx": nx, "ny": ny,
            "err": n * mse, "mse": mse}


_DIRS = ((1, 0), (0, 1), (-1, 1), (1, 1))


def boundary_masks(threshim: torch.Tensor, ranks_img: torch.Tensor):
    """Per-pixel candidate bits (B, H, W) int32 (bit d: direction d emits,
    bit 4+d: its gradient sign is +) and per-direction blob-pair keys
    (B, 4, H, W) int32 (BlobDiff, apriltag_gpu.cu:226-360)."""
    _, h, w = threshim.shape
    dev = threshim.device
    v = threshim.to(torch.int32)
    big = ranks_img > 0
    xs = torch.arange(w, device=dev)
    ys = torch.arange(h, device=dev)
    interior = ((xs >= 1) & (xs <= w - 2))[None, None, :] & \
        ((ys >= 1) & (ys <= h - 2))[None, :, None]
    maskbits = torch.zeros(threshim.shape, dtype=torch.int32, device=dev)
    keych = []
    for d, (dx, dy) in enumerate(_DIRS):
        nv = torch.roll(v, (-dy, -dx), dims=(1, 2))
        nr = torch.roll(ranks_img, (-dy, -dx), dims=(1, 2))
        ok = interior & ((v + nv) == 255) & big & (nr > 0)
        gpos = nv > v
        maskbits = maskbits | (ok.to(torch.int32) << d) \
            | ((ok & gpos).to(torch.int32) << (4 + d))
        lo = torch.minimum(ranks_img, nr) - 1
        hi = torch.maximum(ranks_img, nr) - 1
        keych.append(torch.where(ok & (lo >= 0), (lo << RANK_BITS) | hi,
                                 KEY_INVALID))
    return maskbits, torch.stack(keych, dim=1).to(torch.int32)


def finish_points(pgd: torch.Tensor, key: torch.Tensor) -> dict:
    """(pgd, key) point words -> {key, pack2}. pgd packs
    (py << 14) | (px << 3) | (g << 2) | dir; -1 = empty slot."""
    valid = pgd >= 0
    dirk = (pgd & 3).to(torch.int64)
    g = 2 * ((pgd >> 2) & 1) - 1
    px = (pgd >> 3) & 0x7FF
    py = pgd >> 14
    dtab = torch.tensor(_DIRS, dtype=torch.int32, device=pgd.device)
    dxs = dtab[:, 0][dirk]
    dys = dtab[:, 1][dirk]
    x2 = 2 * px + dxs
    y2 = 2 * py + dys
    key = torch.where(valid, key, KEY_INVALID)
    pack2 = pack_payload(x2, y2, dxs * g, dys * g)
    return {"key": key.to(torch.int32),
            "pack2": torch.where(valid, pack2, 0).to(torch.int32)}


def boundary_points_capped(threshim: torch.Tensor, ranks: torch.Tensor,
                           p_cap: int, k: int):
    """boundary_points with an explicit stage-A pixel cap (rounded to
    boundary_block_rows(p_cap, W) whole rows) and point cap k."""
    b, h, w = threshim.shape
    n = h * w
    dev = threshim.device
    if 2 * w >= 2048 or 2 * h >= 2048:
        raise ValueError("image too large for 11-bit coordinates")
    rimg = ranks.reshape(b, h, w)
    maskbits, keyimg = boundary_masks(threshim, rimg)
    ys = torch.arange(h, dtype=torch.int32, device=dev)
    xs = torch.arange(w, dtype=torch.int32, device=dev)
    pxy = ((ys[:, None] << 11) | xs[None, :])[None]

    # stage A: pixels that emit any point, uniformly thinned, in order
    pc = boundary_block_rows(p_cap, w) * w
    valid_a = (maskbits & 0xF).reshape(b, n) != 0
    keep_a, _ = segs.thin_uniform(valid_a, pc)
    pm_vals = ((pxy << 8) | maskbits).reshape(b, n)
    pm = segs.compact(keep_a, {"pm": pm_vals}, pc, {"pm": -1})[0]["pm"]
    pvalid = pm >= 0
    pix = torch.where(pvalid, ((pm >> 19) & 0x7FF) * w + ((pm >> 8) & 0x7FF),
                      0)

    # stage B: 4 directions per kept pixel (dir-major), thinned to k
    dvalid = torch.stack([pvalid & (((pm >> d) & 1) > 0) for d in range(4)],
                         dim=1)                          # (B, 4, P)
    gbits = torch.stack([(pm >> (4 + d)) & 1 for d in range(4)], dim=1)
    pp = (pm >> 8) & ((1 << 22) - 1)
    cand = ((((pp >> 11) << 14) | ((pp & 0x7FF) << 3))[:, None, :]
            | (gbits << 2)
            | torch.arange(4, dtype=torch.int32, device=dev)[None, :, None])
    keyp = torch.gather(keyimg.reshape(b, 4, n), 2,
                        pix[:, None, :].expand(b, 4, pc).to(torch.int64))
    keep_b, _ = segs.thin_uniform(dvalid.reshape(b, -1), k)
    payload = {"pgd": cand.reshape(b, -1), "key": keyp.reshape(b, -1)}
    pts, counts = segs.compact(keep_b, payload, k,
                               {"pgd": -1, "key": KEY_INVALID})
    return finish_points(pts["pgd"], pts["key"]), counts


def boundary_points(threshim: torch.Tensor, ranks: torch.Tensor,
                    cfg: QuadFitConfig):
    """Black/white blob-pair boundary points compacted to K slots:
    (dict(key, pack2) of (B, K) int32, counts (B,)). ranks (B, H*W)."""
    return boundary_points_capped(threshim, ranks, cfg.max_boundary_pixels,
                                  cfg.max_points)


def _sort2(a: torch.Tensor, b: torch.Tensor):
    """Lexicographic sort of (B, K) rows by (a, b), both nonnegative int32:
    one stable sort of the int64 packing a << 32 | b."""
    key = (a.to(torch.int64) << 32) | b.to(torch.int64)
    s = torch.sort(key, dim=1, stable=True)[0]
    return (s >> 32).to(torch.int32), (s & 0xFFFFFFFF).to(torch.int32)


def _make_sorters(cfg: QuadFitConfig):
    """(sort1, sort2) over (B, K) int32 rows: K9 when cfg.use_pallas_sort
    (every operand a key, so ties are identical tuples and the unstable
    network equals a stable sort), else torch.sort."""
    if cfg.use_pallas_sort:
        return (lambda a: sort_kernel.sort_tpu([a], num_keys=1)[0],
                lambda a, b: tuple(sort_kernel.sort_tpu([a, b], num_keys=2)))
    return lambda a: torch.sort(a, dim=1)[0], _sort2


def _float_sort_key(x: torch.Tensor) -> torch.Tensor:
    """int64 key in [0, 2^32) ordered like x under lax.sort's total order
    for f32 (-0.0 and +0.0 compare equal)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    bits = torch.where(bits == -(2 ** 31), 0, bits)
    key = torch.where(bits < 0, 0x7FFFFFFF - (bits & 0xFFFFFFFF), bits)
    return key + 2 ** 31


def _host_bool(t: torch.Tensor, syncs) -> bool:
    return bool(syncs.item(t) if syncs is not None else t.item())


def cluster_and_fit(pts: dict, decim: torch.Tensor, cfg: QuadFitConfig,
                    syncs=None) -> dict:
    """Compacted boundary points -> quad corners (B, NQ, 4, 2) in
    decimated pixel coords, quad_valid (B, NQ), n_quads (B,), plus stage
    taps. `syncs` (device.HostSyncs) counts the one host read that picks
    the windowed-error formulation (a lax.cond in the JAX package)."""
    b, k = pts["key"].shape
    dev = pts["key"].device
    nseg = cfg.max_segments
    nseg1 = nseg + 1
    i32 = torch.int32
    f32 = torch.float32
    i_global = torch.arange(k, dtype=i32, device=dev)[None].expand(b, k)

    sort1, sort2 = _make_sorters(cfg)

    def clipk(t):
        return t.clamp(0, k - 1)

    # ---- sort by (blob-pair key, x-major payload) -----------------------
    key_s, pack2 = sort2(pts["key"], pts["pack2"])
    x2, y2, gx, gy = unpack_payload(pack2)
    valid_pt = key_s < KEY_INVALID
    seg = segs.segment_ids_from_sorted_keys(key_s, valid=valid_pt,
                                            max_segments=nseg)

    count = histogram(seg, nseg1)                          # (B, NSEG1)
    countf = count.to(f32)
    start_tab = (scan.cumsum_mxu(countf) - countf).to(i32)
    end_tab = start_tab + count - 1

    xmin = segs.take1(x2, clipk(start_tab))
    xmax = segs.take1(x2, clipk(end_tab))
    ykey = sort1(torch.where(valid_pt, seg, nseg) << 11 | y2)
    ymin = segs.take1(ykey, clipk(start_tab)) & 0x7FF
    ymax = segs.take1(ykey, clipk(end_tab)) & 0x7FF
    cx = (xmin + xmax).to(f32) * 0.5 + 0.05118
    cy = (ymin + ymax).to(f32) * 0.5 - 0.028581

    ptab = torch.stack([start_tab.to(f32), count.to(f32), cx, cy], dim=-1)
    pbc = segs.take1(ptab, seg)
    dxp = x2.to(f32) - pbc[..., 2]
    dyp = y2.to(f32) - pbc[..., 3]

    dterm = torch.where(valid_pt, dxp * gx + dyp * gy, 0.0)
    dcum = scan.cumsum_mxu(dterm)
    dot = (segs.take1(dcum, clipk(end_tab))
           - torch.where(start_tab > 0,
                         segs.take1(dcum, clipk(start_tab - 1)), 0.0))

    h2, w2 = decim.shape[1], decim.shape[2]
    max_perimeter = 3 * (2 * w2 + 2 * h2)
    bbox_ok = ((xmax - xmin) * (ymax - ymin)) >= cfg.tag_width
    border_ok = torch.zeros_like(bbox_ok)
    if cfg.normal_border:
        border_ok = border_ok | (dot >= 0)
    if cfg.reversed_border:
        border_ok = border_ok | (dot < 0)
    seg_ok = ((count >= MIN_CLUSTER_POINTS) & (count <= max_perimeter)
              & bbox_ok & border_ok)
    seg_ok[:, nseg] = False

    # ---- theta sort within segments (seg << 20 | theta fixed point) -----
    theta = mathf.atan2(dyp, dxp)
    theta_fx = ((theta + math.pi) * (2 ** 20 / (2 * math.pi))).to(i32) \
        .clamp(0, 2 ** 20 - 1)
    sort_key = (torch.where(valid_pt, seg, nseg) << 20) | theta_fx
    pack3 = (x2 << 11) | y2
    sort_key_s, pack3 = sort2(sort_key, pack3)
    seg = sort_key_s >> 20
    x2 = pack3 >> 11
    y2 = pack3 & 0x7FF
    valid_pt = seg < nseg

    # segment starts/counts/centers are invariant under the within-segment
    # theta sort, so the pre-sort broadcast `pbc` still applies
    start = pbc[..., 0].to(i32)
    sz_pt = pbc[..., 1].to(i32)
    pos = i_global - start

    # ---- line-fit moments, segmented prefix sums ------------------------
    px = x2.to(f32) * 0.5 + 0.5
    py = y2.to(f32) * 0.5 + 0.5
    xc = px - (pbc[..., 2] * 0.5 + 0.5)
    yc = py - (pbc[..., 3] * 0.5 + 0.5)
    ix = px.to(i32)
    iy = py.to(i32)
    inb = (ix > 0) & (ix + 1 < w2) & (iy > 0) & (iy + 1 < h2)
    ixc = ix.clamp(1, w2 - 2)
    iyc = iy.clamp(1, h2 - 2)

    dint = decim.to(i32)
    gxi = F.pad(dint[:, :, 2:] - dint[:, :, :-2], (1, 1))
    gyi = F.pad(dint[:, 2:, :] - dint[:, :-2, :], (0, 0, 1, 1))
    gplane = (((gxi + 255) << 10) | (gyi + 255)).reshape(b, -1)
    gpt = segs.take1(gplane, iyc * w2 + ixc)
    gimx = ((gpt >> 10) - 255).to(f32)
    gimy = ((gpt & 1023) - 255).to(f32)
    wgt = torch.where(inb, torch.sqrt(gimx * gimx + gimy * gimy) + 1.0, 1.0)
    wgt = wgt * WEIGHT_SCALE
    wgt = torch.where(valid_pt, wgt, 0.0)
    mom = torch.stack([wgt * xc, wgt * yc, wgt * xc * xc, wgt * xc * yc,
                       wgt * yc * yc, wgt], dim=-1)       # (B, K, 6)
    pref = scan.segmented_cumsum_from_starts(mom, start)

    def pref_at(position, nonneg=False):
        gathered = segs.take1(pref, clipk(start + clipk(position)))
        if nonneg:
            return gathered
        return torch.where((position >= 0)[..., None], gathered, 0.0)

    total = pref_at(sz_pt - 1, nonneg=True)

    def window_moments(a, bpos):
        """Circular window [a..bpos] within the segment (positions mod
        sz): the wrapped window is the direct one plus the segment total."""
        am = torch.where(a < 0, a + sz_pt, a)
        bm = torch.where(bpos >= sz_pt, bpos - sz_pt, bpos)
        direct = am <= bm
        mwin = (pref_at(bm, nonneg=True) - pref_at(am - 1)
                + torch.where(direct[..., None], 0.0, total))
        nwin = torch.where(direct, bm - am + 1, sz_pt - am + bm + 1)
        return mwin, nwin.to(f32)

    # ---- windowed errors ------------------------------------------------
    ksz = torch.clamp_max(torch.div(sz_pt, 12, rounding_mode="floor"), 20)
    fit_ok_pt = valid_pt & (ksz >= 2)

    def errs_fast():
        mwin, nwin = window_moments(pos - ksz, pos + ksz)
        return fit_line_f32(mwin, nwin)["err"]

    def errs_stable():
        """Windows of giant segments from overlapped-block prefixes: each
        range lies inside one (128+40)-element block, so the rounding of
        every subtraction scales with the block's content."""
        opref, blk, ov = scan.overlapped_cumsum(mom)
        bw = blk + ov

        def lrs(g0, g1, live):
            g0c = clipk(g0)
            g1c = clipk(g1)
            j = torch.div(g1c, blk, rounding_mode="floor")
            base = j * bw - j * blk + ov
            hi = segs.take1(opref, base + g1c)
            lo_pos = base + g0c - 1
            lo = torch.where((g0c - 1 >= j * blk - ov)[..., None],
                             segs.take1(opref, lo_pos.clamp_min(0)), 0.0)
            return torch.where(live[..., None], hi - lo, 0.0)

        a = pos - ksz
        bp = pos + ksz
        wrap_lo = a < 0
        wrap_hi = bp >= sz_pt
        p1a = start + a.clamp_min(0)
        p1b = start + torch.minimum(bp, sz_pt - 1)
        p2a = torch.where(wrap_lo, start + sz_pt + a, start)
        p2b = torch.where(wrap_lo, start + sz_pt - 1, start + bp - sz_pt)
        mwin = (lrs(p1a, p1b, fit_ok_pt)
                + lrs(p2a, p2b, fit_ok_pt & (wrap_lo | wrap_hi)))
        nwin = (2 * ksz + 1).to(f32)
        return fit_line_f32(mwin, nwin)["err"]

    sz_screened = torch.where(seg_ok, count, 0)
    if _host_bool(sz_screened.max() > ERRS_STABLE_MIN_SZ, syncs):
        errs = errs_stable()
    else:
        errs = errs_fast()
    errs = torch.where(fit_ok_pt, errs, 0.0)

    # ---- 7-tap circular smoothing + peaks, boundary region repaired -----
    errs_raw = errs
    smoothed = torch.zeros_like(errs)
    for j in range(-3, 4):
        smoothed = smoothed + math.exp(-j * j / 2.0) * torch.roll(
            errs_raw, -j, dims=1)
    nxt = torch.roll(smoothed, -1, dims=1)
    prv = torch.roll(smoothed, 1, dims=1)
    is_peak_lin = (smoothed > nxt) & (smoothed > prv)

    fw = 8
    pp = torch.cat([torch.arange(fw, dtype=i32, device=dev),
                    torch.arange(-fw, 0, dtype=i32, device=dev)])
    cnt3 = count[..., None]
    pos_tab = torch.where(pp >= 0, pp, cnt3 + pp)            # (B,NSEG1,16)
    in_seg = (pos_tab >= 0) & (pos_tab < cnt3)
    gidx = clipk(start_tab[..., None] + pos_tab)
    eraw = torch.where(in_seg, segs.take1(errs_raw, gidx.reshape(b, -1))
                       .reshape(b, nseg1, 2 * fw), 0.0)

    fpos = torch.cat([torch.arange(5, dtype=i32, device=dev),
                      torch.arange(-5, 0, dtype=i32, device=dev)])
    fpos_abs = torch.where(fpos >= 0, fpos, cnt3 + fpos)
    # exact circular smoothing of fix slot s (signed position s for s < 5,
    # s - 10 from the end otherwise): tap p+j sits at table slot
    # (p+j) mod 16. Summed tap by tap in the order of the global smoothing
    # above (the JAX package folds the taps into a (16, 10) matmul, whose
    # summation order would differ between devices)
    sm_fix = torch.zeros((b, nseg1, 10), dtype=f32, device=dev)
    for j in range(-3, 4):
        taps = torch.tensor([((s if s < 5 else s - 10) + j) % (2 * fw)
                             for s in range(10)], device=dev)
        sm_fix = sm_fix + math.exp(-j * j / 2.0) * eraw[:, :, taps]
    nxt_idx = torch.tensor([1, 2, 3, 4, 0, 6, 7, 8, 9, 0], device=dev)
    prv_idx = torch.tensor([9, 0, 1, 2, 0, 4, 5, 6, 7, 8], device=dev)
    pk_fix = (sm_fix > sm_fix[:, :, nxt_idx]) & \
        (sm_fix > sm_fix[:, :, prv_idx])
    pk_slot_ok = torch.tensor(
        [True, True, True, True, False, False, True, True, True, True],
        device=dev)

    fix_in = (fpos_abs >= 0) & (fpos_abs < cnt3) & (cnt3 >= 2 * fw)
    fgidx_all = clipk(start_tab[..., None] + fpos_abs)
    fgidx = torch.where(fix_in, fgidx_all, k).reshape(b, -1).to(torch.int64)
    pgidx = torch.where(fix_in & pk_slot_ok[None, None, :], fgidx_all,
                        k).reshape(b, -1).to(torch.int64)
    smoothed = F.pad(smoothed, (0, 1)).scatter(
        1, fgidx, sm_fix.reshape(b, -1))[:, :k]
    is_peak_lin = F.pad(is_peak_lin, (0, 1)).scatter(
        1, pgidx, pk_fix.reshape(b, -1))[:, :k]

    errs = torch.where(fit_ok_pt, smoothed, 0.0)
    is_peak = fit_ok_pt & is_peak_lin

    # ---- top-10 maxima per segment: stable sort by (segment, -error) ----
    peak_seg = torch.where(is_peak, seg, nseg)
    if cfg.use_pallas_sort:
        # the JAX package's int formulation: the error's f32 bits order
        # like the error for nonnegative errors, and pos as a third key
        # reproduces the stable order (pos follows the slot within a
        # segment, the primary key)
        errbits = errs.view(torch.int32)
        _, negb_s, ppos_s = sort_kernel.sort_tpu([peak_seg, -errbits, pos],
                                                 num_keys=3)
        perr_s = (-negb_s).view(torch.float32)
    else:
        order = torch.sort((peak_seg.to(torch.int64) << 32)
                           | _float_sort_key(-errs), dim=1, stable=True)[1]
        perr_s = torch.gather(errs, 1, order)
        ppos_s = torch.gather(pos, 1, order)
    pk_count = histogram(peak_seg, nseg1)
    pkf = pk_count.to(f32)
    pstart = (scan.cumsum_mxu(pkf) - pkf).to(i32)
    r11 = torch.arange(MAX_NMAXIMA + 1, dtype=i32, device=dev)
    win_idx = clipk(pstart[..., None] + r11)                # (B, NSEG1, 11)
    src = torch.stack([ppos_s.to(f32), perr_s], dim=-1)
    win = segs.take1(src, win_idx.reshape(b, -1)).reshape(
        b, nseg1, MAX_NMAXIMA + 1, 2)
    in_blk = r11[None, None, :] < pk_count[..., None]
    werr = torch.where(in_blk, win[..., 1], -math.inf)
    thresh = torch.where(pk_count > MAX_NMAXIMA, werr[..., MAX_NMAXIMA],
                         -math.inf)
    qual = in_blk[..., :MAX_NMAXIMA] & \
        (werr[..., :MAX_NMAXIMA] > thresh[..., None])
    nmax = qual.sum(-1)
    mx = torch.where(qual, win[..., :MAX_NMAXIMA, 0].to(i32), _BIGI)
    maxima = torch.sort(mx, dim=2)[0]
    maxima = torch.where(
        torch.arange(MAX_NMAXIMA, device=dev)[None, None, :]
        < nmax[..., None], maxima, 0)
    seg_quad_ok = seg_ok & (nmax >= 4)

    # ---- 45 pair fits + 210 combos --------------------------------------
    seg_sz = count

    def pref_at_seg(position):
        """(B, NSEG1, L) segment-relative position -> prefix (..., 6)."""
        gidx = clipk(start_tab[..., None] + clipk(position))
        g = segs.take1(pref, gidx.reshape(b, -1)).reshape(b, nseg1, -1, 6)
        return torch.where((position >= 0)[..., None], g, 0.0)

    pb = pref_at_seg(maxima)
    pa = pref_at_seg(maxima - 1)
    tot_seg = pref_at_seg((seg_sz - 1)[..., None])       # (B, NSEG1, 1, 6)

    a_idx = torch.as_tensor(_PAIR_A, device=dev)
    b_idx = torch.as_tensor(_PAIR_B, device=dev)
    m_fwd = pb[:, :, b_idx, :] - pa[:, :, a_idx, :]      # (B,NSEG1,45,6)
    n_fwd = (maxima[:, :, b_idx] - maxima[:, :, a_idx] + 1).to(f32)
    m_rev = tot_seg - m_fwd + (pb - pa)[:, :, a_idx, :] + \
        (pb - pa)[:, :, b_idx, :]
    n_rev = seg_sz[..., None].to(f32) - n_fwd + 2.0
    fit_fwd = fit_line_f32(m_fwd, n_fwd)
    fit_rev = fit_line_f32(m_rev, n_rev)

    cp = torch.as_tensor(_COMBO_PAIRS, device=dev)            # (210, 4)
    mse01 = fit_fwd["mse"][:, :, cp[:, 0]]
    mse12 = fit_fwd["mse"][:, :, cp[:, 1]]
    mse23 = fit_fwd["mse"][:, :, cp[:, 2]]
    mse30 = fit_rev["mse"][:, :, cp[:, 3]]
    err_tot = (fit_fwd["err"][:, :, cp[:, 0]] + fit_fwd["err"][:, :, cp[:, 1]]
               + fit_fwd["err"][:, :, cp[:, 2]]
               + fit_rev["err"][:, :, cp[:, 3]])
    dot01_12 = (fit_fwd["nx"][:, :, cp[:, 0]] * fit_fwd["nx"][:, :, cp[:, 1]]
                + fit_fwd["ny"][:, :, cp[:, 0]] * fit_fwd["ny"][:, :, cp[:, 1]])
    slots_ok = torch.as_tensor(_COMBOS[:, 3], device=dev)[None, None, :] \
        < nmax[..., None]
    combo_ok = (slots_ok & (mse01 <= MAX_LINE_FIT_MSE)
                & (mse12 <= MAX_LINE_FIT_MSE) & (mse23 <= MAX_LINE_FIT_MSE)
                & (mse30 <= MAX_LINE_FIT_MSE)
                & (torch.abs(dot01_12) <= COS_CRITICAL_RAD))
    err_masked = torch.where(combo_ok, err_tot, math.inf)
    best = torch.argmin(err_masked, dim=2)                   # (B, NSEG1)
    best_err = torch.gather(err_masked, 2, best[..., None])[..., 0]
    seg_quad_ok = seg_quad_ok & torch.isfinite(best_err) & \
        (best_err / seg_sz.clamp_min(1) <= MAX_LINE_FIT_MSE)

    # ---- corners from the best combo's 4 lines --------------------------
    def line_params(d, pair_col):
        pidx = cp[:, pair_col][best]                         # (B, NSEG1)
        return {kk: torch.gather(d[kk], 2, pidx[..., None])[..., 0]
                for kk in ("ex", "ey", "nx", "ny")}

    lines = [line_params(fit_fwd, 0), line_params(fit_fwd, 1),
             line_params(fit_fwd, 2), line_params(fit_rev, 3)]
    det_ok = torch.ones((b, nseg1), dtype=torch.bool, device=dev)
    ccx_seg = cx * 0.5 + 0.5
    ccy_seg = cy * 0.5 + 0.5
    corner_xy = [None] * 4
    for i in range(4):
        li, lj = lines[i], lines[(i + 1) & 3]
        a00, a01 = li["ny"], -lj["ny"]
        a10, a11 = -li["nx"], lj["nx"]
        b0 = -li["ex"] + lj["ex"]
        b1 = -li["ey"] + lj["ey"]
        det = a00 * a11 - a10 * a01
        det_ok = det_ok & (torch.abs(det) >= 1e-3)
        l0v = (a11 * b0 - a01 * b1) / torch.where(det == 0, 1e-12, det)
        px_c = li["ex"] + l0v * a00 + ccx_seg
        py_c = li["ey"] + l0v * a10 + ccy_seg
        corner_xy[(i + 1) & 3] = torch.stack([px_c, py_c], dim=-1)
    corners = torch.stack(corner_xy, dim=2)                  # (B,NSEG1,4,2)
    seg_quad_ok = seg_quad_ok & det_ok

    def tri(p0, p1, p2):
        return 0.5 * torch.abs((p1[..., 0] - p0[..., 0])
                               * (p2[..., 1] - p0[..., 1])
                               - (p2[..., 0] - p0[..., 0])
                               * (p1[..., 1] - p0[..., 1]))

    area = tri(corners[:, :, 0], corners[:, :, 1], corners[:, :, 2]) + \
        tri(corners[:, :, 2], corners[:, :, 3], corners[:, :, 0])
    seg_quad_ok = seg_quad_ok & \
        (area >= 0.95 * cfg.tag_width * cfg.tag_width)
    for i in range(4):
        p0 = corners[:, :, i]
        p1 = corners[:, :, (i + 1) & 3]
        p2 = corners[:, :, (i + 2) & 3]
        d1 = p1 - p0
        d2 = p2 - p1
        denom = torch.sqrt((d1 * d1).sum(-1) * (d2 * d2).sum(-1))
        cosdt = (d1 * d2).sum(-1) / torch.where(denom == 0, 1e-12, denom)
        seg_quad_ok = seg_quad_ok & (torch.abs(cosdt) <= COS_CRITICAL_RAD) \
            & (d1[..., 0] * d2[..., 1] >= d1[..., 1] * d2[..., 0])

    # ---- quads to NQ slots, largest area first --------------------------
    # lax.top_k breaks ties by the lower index: a stable descending sort
    nq = cfg.max_quads
    prio = torch.where(seg_quad_ok, area, -1.0)
    top_prio, top_idx = torch.sort(prio, dim=1, descending=True, stable=True)
    top_prio, top_idx = top_prio[:, :nq], top_idx[:, :nq]
    out_c = torch.gather(corners, 1,
                         top_idx[..., None, None].expand(b, nq, 4, 2))
    quad_valid = top_prio > 0
    return {
        "corners": out_c,
        "quad_valid": quad_valid,
        "n_quads": quad_valid.sum(dim=1),
        "seg": seg, "pos": pos, "errs": errs, "is_peak": is_peak,
        "maxima": maxima, "nmax": nmax, "seg_ok": seg_ok, "count": count,
    }

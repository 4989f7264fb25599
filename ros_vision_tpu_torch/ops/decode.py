"""Tag decode on the device: refine edges, homography, bit sampling, code
match (PyTorch).

Counterpart of ros_vision_tpu/ops/decode.py with the same f32 math:
length-adaptive subpixel edge refinement on a static sample superset
(with the undistort-fit-redistort path when calibration is given, and the
32/64/128 sample-grid tier picked by the longest valid edge), the
projective-basis homography, border gray models, bilinear bit sampling,
3x3 decode sharpening and the code match as one matmul against the
family's (4*n_codes, nbits) bit matrix. No result depends on the
process's TF32 flags: the sharpening is shifted f32 slices, the 3x3
products are broadcast multiplies summed over the contracted axis (bmm3,
bmv3), and the code match's matmul is exact in TF32 too.

refine_edges dispatches by device: a CPU tensor runs refine_edges_plain,
whose 25-step undistortion the host drives op by op; a CUDA tensor
launches P2, csrc/refine.cu, once a call, the counterpart of the JAX
function's _refine_edges_core with its lax.fori_loop. The two give the
same sample positions, weights and undistorted points bit for bit; only
the order of the six moment sums differs.

decode_quads reads its constant tables (decode_tables) from the
per-device cache (device.device_tables), uploaded on the device's first
call, and detection_points the tag's corners. On a CUDA device it
replays its body as a CUDA graph once its shapes recur (GraphRunner, one
a detector, one a thread for other callers), with outputs bit-identical
to the eager body; on the CPU the body runs eagerly.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ros_vision_tpu_torch import _build
from ros_vision_tpu_torch.apriltag.families import TagFamily
from ros_vision_tpu_torch.device import device_tables, host_syncs, kernel_route
from ros_vision_tpu_torch.ops import mathf
from ros_vision_tpu_torch.ops.graphs import Runner, stream_id, thread_runner

QUAD_DECIMATE = 2
DECODE_SHARPENING = 0.25
MAX_HAMMING = 2
REFINE_ALPHA_TIERS = (32, 64, 128)
REFINE_NORMAL_STEPS = 25      # range +-(quad_decimate+1), step 0.25

launches = _build.counter("refine_edges")


def bmm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., I, J) @ b (..., J, K) as broadcast f32 products summed over
    J: elementwise work that the TF32 flags, unlike a matmul's, never
    round."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def bmv3(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """a (..., I, J) @ v (..., J), as bmm3 does it."""
    return (a * v[..., None, :]).sum(-1)


def laplacian3(grid: torch.Tensor) -> torch.Tensor:
    """The 3x3 kernel [[0,-1,0],[-1,4,-1],[0,-1,0]] over the last two axes
    of `grid`, zero-padded (the decode sharpening), as f32 shifted slices
    where a convolution would round to TF32 under cuDNN's default."""
    pad = F.pad(grid, (1, 1, 1, 1))
    return 4.0 * grid - pad[..., :-2, 1:-1] - pad[..., 2:, 1:-1] \
        - pad[..., 1:-1, :-2] - pad[..., 1:-1, 2:]


def adjust_pixel_centers(corners: torch.Tensor) -> torch.Tensor:
    """Decimated -> full-res coords (AdjustPixelCenters)."""
    return (corners - 0.5) * QUAD_DECIMATE + 0.5


def _bilinear(gray_f: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """Bilinear sample with apriltag's half-pixel convention; returns
    (value, in_bounds). Indices are clipped before the gather."""
    b, h, w = gray_f.shape
    x1 = torch.floor(px - 0.5)
    y1 = torch.floor(py - 0.5)
    fx = px - 0.5 - x1
    fy = py - 0.5 - y1
    x1i = x1.to(torch.int32)
    y1i = y1.to(torch.int32)
    ok = (x1i >= 0) & (x1i + 1 < w) & (y1i >= 0) & (y1i + 1 < h)
    x1c = x1i.clamp(0, w - 2)
    y1c = y1i.clamp(0, h - 2)
    flat = gray_f.reshape(b, -1)
    shp = px.shape

    def at(yy, xx):
        idx = (yy * w + xx).reshape(b, -1).to(torch.int64)
        return torch.gather(flat, 1, idx).reshape(shp)

    v = (at(y1c, x1c) * (1 - fx) * (1 - fy) + at(y1c, x1c + 1) * fx * (1 - fy)
         + at(y1c + 1, x1c) * (1 - fx) * fy + at(y1c + 1, x1c + 1) * fx * fy)
    return v, ok


def _int_index(px: torch.Tensor, py: torch.Tensor, h: int, w: int):
    """Flat index (clipped into the frame) and in-bounds flag of the
    integer-truncation sample at px, py."""
    xi = px.to(torch.int32)
    yi = py.to(torch.int32)
    ok = (px >= 0) & (py >= 0) & (xi < w) & (yi < h)
    return yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1), ok


def _int_sample(gray_f: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """Integer-truncation sample with bounds; indices clipped."""
    b, h, w = gray_f.shape
    idx, ok = _int_index(px, py, h, w)
    v = torch.gather(gray_f.reshape(b, -1), 1,
                     idx.reshape(b, -1).to(torch.int64))
    return v.reshape(px.shape), ok


def _bc_intr(intr, dist, ndim):
    """Broadcast per-row intrinsics (a tuple of (B,) or the columns of a
    (B, 4)) and distortion (B, 5) against sample arrays with `ndim` dims
    (leading batch axis)."""
    def bc(v):
        return v.reshape(v.shape[:1] + (1,) * (ndim - 1))

    if isinstance(intr, torch.Tensor):
        intr = intr.unbind(1)
    fx, fy, cx, cy = (bc(v) for v in intr)
    ks = [bc(dist[:, i]) for i in range(5)]
    return fx, fy, cx, cy, ks


def _undistort(px, py, intr, dist, iters=25):
    fx, fy, cx, cy, (k1, k2, p1, p2, k3) = _bc_intr(intr, dist, px.ndim)
    x0 = (px - cx) / fx
    y0 = (py - cy) / fy
    x, y = x0, y0
    for _ in range(iters):
        r2 = x * x + y * y
        rad = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x, y = (x0 - dx) / rad, (y0 - dy) / rad
    return x * fx + cx, y * fy + cy


def _distort(px, py, intr, dist):
    fx, fy, cx, cy, (k1, k2, p1, p2, k3) = _bc_intr(intr, dist, px.ndim)
    x = (px - cx) / fx
    y = (py - cy) / fy
    r2 = x * x + y * y
    rad = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd * fx + cx, yd * fy + cy


def refine_tier(corners: torch.Tensor, quad_valid: torch.Tensor,
                syncs=None) -> int:
    """Index into REFINE_ALPHA_TIERS of the smallest sample grid covering
    the longest valid edge (one host read: the JAX package's lax.switch)."""
    pb = torch.roll(corners, -1, dims=2)
    mag = torch.sqrt((pb[..., 1] - corners[..., 1]) ** 2
                     + (pb[..., 0] - corners[..., 0]) ** 2)
    longest = torch.max(torch.where(quad_valid[..., None], mag, 0.0))
    longest = syncs.item(longest) if syncs is not None else longest.item()
    # compared in f32 like the JAX predicate `longest > 8.0 * n`
    lf = np.float32(longest)
    return int(sum(lf > np.float32(8.0 * n) for n in REFINE_ALPHA_TIERS[:-1]))


def refine_edges(gray: torch.Tensor, corners: torch.Tensor,
                 quad_valid: torch.Tensor, intr=None, dist=None,
                 reversed_border: bool = False, syncs=None) -> torch.Tensor:
    """Subpixel edge refinement of corners (B, NQ, 4, 2) full-res.
    intr: (fx, fy, cx, cy), a tuple of (B,) tensors or a (B, 4) tensor
    (such as a (B, 9) intrinsics row's first four columns), and dist (B, 5)
    to refine in undistorted coordinates; None to skip undistortion. P2 on
    CUDA, the plain version on the CPU."""
    n_alpha = REFINE_ALPHA_TIERS[refine_tier(corners, quad_valid, syncs)]
    if kernel_route(corners) == "cpu":
        return refine_edges_plain(gray, corners, quad_valid, intr, dist,
                                  n_alpha, reversed_border)
    if not (isinstance(intr, torch.Tensor) and dist is not None):
        intr, dist = lens_rows(intr, dist, corners.shape[0], corners.device)
    return _refine_edges_cuda(
        gray.contiguous(), corners.to(torch.float32).contiguous(),
        quad_valid.contiguous(), intr, dist, n_alpha, reversed_border)


def lens_rows(intr, dist, b: int, device: torch.device):
    """A tuple (fx, fy, cx, cy) and dist as P2's contiguous f32 (B, 4) and
    (B, 5) rows; (None, None) without calibration."""
    if intr is None or dist is None:
        return None, None
    f32 = torch.float32
    rows = torch.stack([torch.as_tensor(v, dtype=f32, device=device)
                        .reshape(-1).expand(b) for v in intr], 1)
    d = torch.as_tensor(dist, dtype=f32, device=device).reshape(-1, 5)
    return rows, d.expand(b, 5).contiguous()


def _refine_edges_cuda(gray: torch.Tensor, corners: torch.Tensor,
                       quad_valid: torch.Tensor, intr, dist, n_alpha: int,
                       reversed_border: bool = False) -> torch.Tensor:
    """Launch csrc/refine.cu on CUDA gray (B, H, W) u8, corners (B, NQ, 4,
    2) f32, quad_valid (B, NQ) bool and f32 intr (B, 4) and dist (B, 5)
    rows with adjacent columns (a (B, 9) row's views serve), or None for
    both: one cooperative launch a call, a block an edge at a time, a
    thread a term."""
    b, nq = corners.shape[:2]
    h, w = gray.shape[1:]
    dev = corners.device
    _build.check_tensor(gray, "gray", torch.uint8, (b, h, w), dev)
    _build.check_tensor(corners, "corners", torch.float32, (b, nq, 4, 2),
                        dev)
    _build.check_tensor(quad_valid, "quad_valid", torch.bool, (b, nq), dev)
    have_dist = intr is not None
    if have_dist:
        _check_rows(intr, "intr", (b, 4), dev)
        _check_rows(dist, "dist", (b, 5), dev)
    out = torch.empty_like(corners)
    if b * nq == 0:
        return out                          # no slot to write
    lines = torch.empty((b, nq, 4, 5), dtype=torch.float32, device=dev)
    made = ctypes.c_int(0)
    _build.launch("rvt_refine_edges", dev, gray, corners, quad_valid, intr,
                  dist, out, lines, ctypes.addressof(made),
                  intr.stride(0) if have_dist else 0,
                  dist.stride(0) if have_dist else 0,
                  b, nq, h, w, int(n_alpha), int(have_dist),
                  int(reversed_border))
    launches.add(made.value)
    return out


def _check_rows(t: torch.Tensor, name: str, shape: tuple,
                device: torch.device) -> None:
    """Raise unless `t` is an f32 tensor of `shape` on `device` whose
    columns are adjacent: P2 reads its rows `t.stride(0)` floats apart."""
    if t.device != device or t.dtype != torch.float32 or \
            tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected f32 {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if t.stride(1) != 1 or not 0 <= t.stride(0) < 2 ** 31:
        raise ValueError(f"{name}: expected adjacent columns, got strides "
                         f"{t.stride()}")


def refine_terms_plain(gray_f: torch.Tensor, corners: torch.Tensor,
                       n_alpha: int, reversed_border: bool = False,
                       intr=None, dist=None) -> dict:
    """The per-sample terms of refine_edges_plain on gray_f (B, H, W) f32:
    the union of the normal rays' sample positions ux, uy (B, NQ, 4,
    n_alpha, 33), and each term's weight wgt and point xo, yo (B, NQ, 4,
    n_alpha, 25), undistorted where intr and dist are given."""
    dev = corners.device
    f32 = torch.float32
    have_dist = intr is not None and dist is not None

    pa = corners
    pb = torch.roll(corners, -1, dims=2)
    nx = pb[..., 1] - pa[..., 1]
    ny = -pb[..., 0] + pa[..., 0]
    # correctly rounded, as P2's (torch's vectorised CPU sqrt is not)
    mag = mathf.sqrt(nx * nx + ny * ny)
    mag_safe = torch.where(mag == 0, 1e-6, mag)
    nx = nx / mag_safe
    ny = ny / mag_safe

    s = torch.arange(n_alpha, dtype=f32, device=dev)
    ns = torch.floor(mag / 8.0).clamp(16, n_alpha)         # (B,NQ,4)
    alpha = (1.0 + s) / (ns[..., None] + 1)                # (B,NQ,4,S)
    s_ok = s < ns[..., None]
    x0 = alpha * pa[..., 0:1] + (1 - alpha) * pb[..., 0:1]
    y0 = alpha * pa[..., 1:2] + (1 - alpha) * pb[..., 1:2]

    rng = QUAD_DECIMATE + 1
    n_off = -rng + 0.25 * torch.arange(REFINE_NORMAL_STEPS, dtype=f32,
                                       device=dev)
    grange = 1.0
    nxb = nx[..., None, None]
    nyb = ny[..., None, None]
    x0b = x0[..., None]
    y0b = y0[..., None]
    noffb = n_off[None, None, None, None, :]

    # one gather over the 33-offset union of the n +- grange rays (all
    # offsets are dyadic, so the slices equal the two separate rays)
    gsteps = int(round(2 * grange / 0.25))                 # 8
    n_union = REFINE_NORMAL_STEPS + gsteps                 # 33
    uoff = -rng - grange + 0.25 * torch.arange(n_union, dtype=f32,
                                               device=dev)
    uoffb = uoff[None, None, None, None, :]
    ux = x0b + uoffb * nxb
    uy = y0b + uoffb * nyb
    gu, oku = _int_sample(gray_f, ux, uy)
    g1 = gu[..., gsteps:]
    ok1 = oku[..., gsteps:]
    g2 = gu[..., :REFINE_NORMAL_STEPS]
    ok2 = oku[..., :REFINE_NORMAL_STEPS]
    pol = (g2 >= g1) if reversed_border else (g1 >= g2)
    ok = ok1 & ok2 & pol & s_ok[..., None]
    wgt = torch.where(ok, (g2 - g1) * (g2 - g1), 0.0)
    xo = x0b + noffb * nxb
    yo = y0b + noffb * nyb
    if have_dist:
        xo, yo = _undistort(xo, yo, intr, dist)
    return dict(ux=ux, uy=uy, wgt=wgt, xo=xo, yo=yo)


def refine_edges_plain(gray, corners, quad_valid, intr, dist, n_alpha: int,
                       reversed_border: bool = False):
    """refine_edges on the n_alpha-sample grid in plain PyTorch (the JAX
    package's _refine_edges_core op for op): what P2 computes."""
    terms = refine_terms_plain(gray.to(torch.float32), corners, n_alpha,
                               reversed_border, intr, dist)
    have_dist = intr is not None and dist is not None
    pa = corners
    pb = torch.roll(corners, -1, dims=2)
    wgt, xo, yo = terms["wgt"], terms["xo"], terms["yo"]
    emx = 0.5 * (pa[..., 0] + pb[..., 0])[..., None, None]
    emy = 0.5 * (pa[..., 1] + pb[..., 1])[..., None, None]
    xod = xo - emx
    yod = yo - emy
    mxy = torch.stack([wgt * xod, wgt * yod, wgt * xod * xod,
                       wgt * xod * yod, wgt * yod * yod, wgt], dim=-1)
    m = mxy.sum(dim=(3, 4))                                # (B,NQ,4,6)
    n_tot = m[..., 5]
    usable = n_tot > 1e-9
    n_safe = torch.where(usable, n_tot, 1.0)
    ex = m[..., 0] / n_safe + emx[..., 0, 0]
    ey = m[..., 1] / n_safe + emy[..., 0, 0]
    cxx = m[..., 2] / n_safe - (m[..., 0] / n_safe) ** 2
    cxy = (m[..., 3] / n_safe
           - (m[..., 0] / n_safe) * (m[..., 1] / n_safe))
    cyy = m[..., 4] / n_safe - (m[..., 1] / n_safe) ** 2
    theta = 0.5 * mathf.atan2(-2 * cxy, cyy - cxx)
    lnx = mathf.cos(theta)
    lny = mathf.sin(theta)

    out = corners.clone()
    for i in range(4):
        j = (i + 1) & 3
        a00, a01 = lny[..., i], -lny[..., j]
        a10, a11 = -lnx[..., i], lnx[..., j]
        b0 = -ex[..., i] + ex[..., j]
        b1 = -ey[..., i] + ey[..., j]
        det = a00 * a11 - a10 * a01
        good = (torch.abs(det) > 1e-3) & usable[..., i] & usable[..., j] & \
            quad_valid
        l0 = (a11 * b0 - a01 * b1) / torch.where(det == 0, 1e-12, det)
        px = ex[..., i] + l0 * a00
        py = ey[..., i] + l0 * a10
        if have_dist:
            px, py = _distort(px, py, intr, dist)
        out[:, :, j, 0] = torch.where(good, px, out[:, :, j, 0])
        out[:, :, j, 1] = torch.where(good, py, out[:, :, j, 1])
    return out


def _src_basis_inv() -> np.ndarray:
    """Constant S^-1 of the projective-basis homography (f64, then f32)."""
    s = np.array([[-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]],
                 np.float64).T
    d = np.linalg.solve(s[:, :3], s[:, 3])
    S = s[:, :3] * d[None, :]
    return np.linalg.inv(S).astype(np.float32)


_SRC_BASIS_INV = _src_basis_inv()


def quad_homographies(corners: torch.Tensor,
                      basis: torch.Tensor | None = None) -> torch.Tensor:
    """Tag frame (-1,-1),(1,-1),(1,1),(-1,1) -> corners, (..., 4, 2) ->
    (..., 3, 3) normalised to H[2,2] = 1 (projective-basis closed form).
    `basis`: S^-1 on corners' device (constant_tables' `basis`, looked up
    when None)."""
    if basis is None:
        basis = constant_tables(corners.device, host_syncs(None))["basis"]
    u = corners[..., 0]
    v = corners[..., 1]
    p = torch.stack([u, v, torch.ones_like(u)], dim=-2)     # (..., 3, 4)
    m = p[..., :3]
    p4 = p[..., 3]
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    adj = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1)], -2)
    cvec = bmv3(adj, p4)
    G = m * cvec[..., None, :]
    H = bmm3(G, basis)
    h22 = H[..., 2:3, 2:3]
    h22 = torch.where(torch.abs(h22) < 1e-20,
                      torch.where(h22 < 0, -1e-20, 1e-20), h22)
    return H / h22


def project(H: torch.Tensor, tx, ty):
    """Apply H (..., 3, 3) to tag-frame points tx/ty."""
    z = H[..., 2, 0] * tx + H[..., 2, 1] * ty + H[..., 2, 2]
    px = (H[..., 0, 0] * tx + H[..., 0, 1] * ty + H[..., 0, 2]) / z
    py = (H[..., 1, 0] * tx + H[..., 1, 1] * ty + H[..., 1, 2]) / z
    return px, py


def _decode_tables(family: TagFamily):
    """Static sample-coordinate tables for a family geometry (copied from
    ros_vision_tpu/ops/decode.py, which imports jax): border sample
    coordinates with their white/black labels, data-bit coordinates, and
    the flat sharpening-grid index of each bit (None for dense layouts),
    as numpy arrays."""
    wb = family.border_size
    pats = [(-0.5, 0.5, 0, 1, 1), (0.5, 0.5, 0, 1, 0),
            (wb + 0.5, 0.5, 0, 1, 1), (wb - 0.5, 0.5, 0, 1, 0),
            (0.5, -0.5, 1, 0, 1), (0.5, 0.5, 1, 0, 0),
            (0.5, wb + 0.5, 1, 0, 1), (0.5, wb - 0.5, 1, 0, 0)]
    if family.reversed_border:
        pats = [(sx, sy, dx, dy, 1 - w) for sx, sy, dx, dy, w in pats]
    tx, ty, is_white = [], [], []
    for sx, sy, dx, dy, w in pats:
        for i in range(wb):
            tx.append(2 * ((sx + i * dx) / wb - 0.5))
            ty.append(2 * ((sy + i * dy) / wb - 0.5))
            is_white.append(w)
    border = (np.array(tx, np.float32), np.array(ty, np.float32),
              np.array(is_white, np.float32))
    bc = family.bit_coords()
    bx = bc[:, 0].astype(np.float32)
    by = bc[:, 1].astype(np.float32)
    bits = (2 * ((bx + 0.5) / wb - 0.5).astype(np.float32),
            2 * ((by + 0.5) / wb - 0.5).astype(np.float32))
    grid_idx = None
    if family.bit_xy is not None:
        total = family.total_width
        min_coord = (wb - total) // 2
        grid_idx = ((bc[:, 1] - min_coord) * total
                    + (bc[:, 0] - min_coord)).astype(np.int32)
        assert grid_idx.min() >= 0 and grid_idx.max() < total * total
    return border, bits, grid_idx


# the tag's corners in the tag frame, in the order of a detection's corners
TAG_CORNERS = [[-1, 1], [1, 1], [1, -1], [-1, -1]]


def constant_tables(device: torch.device, syncs) -> dict:
    """The family-free tables on `device` (device.device_tables):
    `basis`, the homography's S^-1 (f32 (3, 3)), and `tag_corners`,
    TAG_CORNERS as f32 (4, 2)."""
    return device_tables(device, "decode", lambda up: {
        "basis": up(_SRC_BASIS_INV),
        "tag_corners": up(TAG_CORNERS, torch.float32)}, syncs)


def family_key(family: TagFamily) -> tuple:
    """What decode_quads' tables and graphs depend on of a family."""
    return (family.name, family.nbits, family.border_size,
            family.total_width, family.reversed_border)


def decode_tables(family: TagFamily, device: torch.device, syncs) -> dict:
    """decode_quads' tables for `family` on `device`
    (device.device_tables): constant_tables' `basis`; the border samples'
    tag-frame `btx`, `bty` and white labels `bwhite`; the data bits'
    `dtx`, `dty` (f32, as _decode_tables builds them); and `grid_idx`,
    the bits' flat sharpening-grid index as int64 (None for dense
    layouts)."""
    def build(up):
        basis = constant_tables(device, syncs)["basis"]
        (btx, bty, bwhite), (dtx, dty), grid_idx = _decode_tables(family)
        return {"basis": basis, "btx": up(btx), "bty": up(bty),
                "bwhite": up(bwhite), "dtx": up(dtx), "dty": up(dty),
                "grid_idx": None if grid_idx is None
                else up(grid_idx, torch.int64)}
    return device_tables(device, ("decode",) + family_key(family), build,
                         syncs)


def detection_points(H: torch.Tensor, syncs) -> tuple:
    """A detection's corners (..., 4, 2) and centre (..., 2) in pixels:
    TAG_CORNERS and the tag frame's origin through its H (..., 3, 3)."""
    tcs = constant_tables(H.device, syncs)["tag_corners"]
    px, py = project(H[..., None, :, :], tcs[:, 0], tcs[:, 1])
    corners = torch.stack([px, py], -1)
    cx, cy = project(H, 0.0, 0.0)
    return corners, torch.stack([cx, cy], -1)


def make_code_matrix(family: TagFamily) -> np.ndarray:
    """(n_codes*4, nbits) float32 bit matrix (copied from
    ros_vision_tpu/ops/decode.py)."""
    nbits = family.nbits
    codes = family.codes.reshape(-1)           # (n*4,)
    out = np.zeros((len(codes), nbits), np.float32)
    for i, c in enumerate(codes):
        for bit in range(nbits):
            out[i, bit] = (int(c) >> (nbits - 1 - bit)) & 1
    return out


def decode_quads(gray: torch.Tensor, corners: torch.Tensor,
                 quad_valid: torch.Tensor, family: TagFamily,
                 code_matrix: torch.Tensor, syncs=None,
                 graphs: "GraphRunner | None" = None) -> dict:
    """Quad decode (apriltag quad_decode semantics): ok (B,NQ), tag_id,
    hamming, rotation (int32), margin (f32), H (B,NQ,3,3). `syncs`
    (device.HostSyncs) counts the tables' uploads on a device's first
    call. On a CUDA device the body runs through `graphs` (the calling
    thread's own GraphRunner when None), which replays it as a CUDA graph
    once its shapes recur; on the CPU it runs eagerly."""
    tabs = decode_tables(family, corners.device, host_syncs(syncs))
    if corners.device.type != "cuda":
        return _decode_quads(family, tabs, code_matrix, gray, corners,
                             quad_valid)
    if graphs is None:
        graphs = thread_runner(GraphRunner)
    return graphs.run(gray, corners, quad_valid, family, code_matrix, tabs)


class GraphRunner(Runner):
    """decode_quads on a CUDA device, replayed as a CUDA graph once its
    key recurs (ops/graphs.Runner), with outputs bit-identical to the
    eager body. The key is what the code observes: the device, the
    current stream, gray's shape and dtype, corners' shape (B, NQ) and
    dtype, quad_valid's dtype, the family (family_key) and the code
    matrix's identity (its address, shape and dtype: the graph reads it
    in place, and holds it). The graph reads gray, corners and quad_valid
    from buffers each replay copies them into. `runs` counts decode_quads
    calls by how they ran (RUNS), as the calling thread's open call
    record does under `decode`."""

    LAYER = "decode"

    def run(self, gray: torch.Tensor, corners: torch.Tensor,
            quad_valid: torch.Tensor, family: TagFamily,
            code_matrix: torch.Tensor, tabs: dict) -> dict:
        dev = corners.device
        on = (dev, stream_id(dev))
        key = (str(dev), on[1], tuple(gray.shape), gray.dtype,
               tuple(corners.shape), corners.dtype, quad_valid.dtype,
               family_key(family), code_matrix.data_ptr(),
               tuple(code_matrix.shape), code_matrix.dtype)
        how = []
        with torch.inference_mode():
            out = self._stage(
                key, on, how, (tabs, code_matrix),
                functools.partial(_decode_quads, family, tabs, code_matrix),
                {"gray": gray, "corners": corners, "quad_valid": quad_valid},
                "decode_quads:")
            out = {k: self._copy(v) for k, v in out.items()}
        self._count(how)
        return out


def _decode_quads(family: TagFamily, tabs: dict, code_matrix: torch.Tensor,
                  gray: torch.Tensor, corners: torch.Tensor,
                  quad_valid: torch.Tensor) -> dict:
    """decode_quads' body on decode_tables' `tabs`: device work alone, no
    host read and no upload."""
    b, nq = corners.shape[:2]
    dev = corners.device
    gray_f = gray.to(torch.float32)
    H = quad_homographies(corners, tabs["basis"])
    btx, bty, bwhite = tabs["btx"], tabs["bty"], tabs["bwhite"]

    # border samples -> white/black gray models
    Hb = H[:, :, None, :, :]
    pxs = Hb[..., 0, 0] * btx + Hb[..., 0, 1] * bty + Hb[..., 0, 2]
    pys = Hb[..., 1, 0] * btx + Hb[..., 1, 1] * bty + Hb[..., 1, 2]
    pzs = Hb[..., 2, 0] * btx + Hb[..., 2, 1] * bty + Hb[..., 2, 2]
    v, ok = _int_sample(gray_f, pxs / pzs, pys / pzs)      # (B, NQ, 8*wb)
    wmask = (bwhite[None, None, :] > 0.5) & ok
    kmask = (bwhite[None, None, :] < 0.5) & ok

    def gray_model(mask):
        w = mask.to(torch.float32)
        rx, ry = btx[None, None, :], bty[None, None, :]
        sxx = (w * rx * rx).sum(-1) + 1e-6
        sxy = (w * rx * ry).sum(-1)
        sx = (w * rx).sum(-1)
        syy = (w * ry * ry).sum(-1) + 1e-6
        sy = (w * ry).sum(-1)
        s1 = w.sum(-1) + 1e-6
        bx = (w * rx * v).sum(-1)
        by = (w * ry * v).sum(-1)
        b1 = (w * v).sum(-1)
        c00 = syy * s1 - sy * sy
        c01 = sx * sy - sxy * s1
        c02 = sxy * sy - syy * sx
        c11 = sxx * s1 - sx * sx
        c12 = sxy * sx - sxx * sy
        c22 = sxx * syy - sxy * sxy
        det = sxx * c00 + sxy * c01 + sx * c02
        det = torch.where(torch.abs(det) < 1e-30, 1e-30, det)
        out = torch.stack([c00 * bx + c01 * by + c02 * b1,
                           c01 * bx + c11 * by + c12 * b1,
                           c02 * bx + c12 * by + c22 * b1], -1)
        return out / det[..., None]                        # (B,NQ,3)

    cw = gray_model(wmask)
    ck = gray_model(kmask)
    ok_models = (cw[..., 2] - ck[..., 2]) >= 0

    # data bit samples
    dtxj, dtyj = tabs["dtx"], tabs["dty"]
    bx = Hb[..., 0, 0] * dtxj + Hb[..., 0, 1] * dtyj + Hb[..., 0, 2]
    by = Hb[..., 1, 0] * dtxj + Hb[..., 1, 1] * dtyj + Hb[..., 1, 2]
    bz = Hb[..., 2, 0] * dtxj + Hb[..., 2, 1] * dtyj + Hb[..., 2, 2]
    bv, bok = _bilinear(gray_f, bx / bz, by / bz)          # (B, NQ, nbits)
    thr_w = cw[..., 0:1] * dtxj + cw[..., 1:2] * dtyj + cw[..., 2:3]
    thr_k = ck[..., 0:1] * dtxj + ck[..., 1:2] * dtyj + ck[..., 2:3]
    vals = torch.where(bok, bv - (thr_w + thr_k) * 0.5, 0.0)

    # decode sharpening on the (total, total) grid
    total = family.total_width
    gi = tabs["grid_idx"]
    if gi is None:
        g = family.grid_size
        grid = torch.zeros((b, nq, total, total), dtype=torch.float32,
                           device=dev)
        grid[:, :, 2:2 + g, 2:2 + g] = vals.reshape(b, nq, g, g)
    else:
        grid = torch.zeros((b, nq, total * total), dtype=torch.float32,
                           device=dev)
        grid[:, :, gi] = vals
        grid = grid.reshape(b, nq, total, total)
    grid = grid + DECODE_SHARPENING * laplacian3(grid)
    if gi is None:
        g = family.grid_size
        vals = grid[:, :, 2:2 + g, 2:2 + g].reshape(b, nq, g * g)
    else:
        vals = grid.reshape(b, nq, total * total)[:, :, gi]

    bits = (vals > 0).to(torch.float32)                    # (B, NQ, nbits)
    white_score = torch.where(vals > 0, vals, 0.0).sum(-1)
    white_cnt = bits.sum(-1) + 1.0
    black_score = torch.where(vals <= 0, -vals, 0.0).sum(-1)
    black_cnt = (family.nbits - bits.sum(-1)) + 1.0
    margin = torch.minimum(white_score / white_cnt, black_score / black_cnt)

    # code match: one matmul against the (4*n_codes, nbits) bit matrix;
    # its inputs are 0/1 and each sum at most nbits, exact in TF32 and
    # bf16 inputs with f32 sums, so no matmul precision setting changes it
    cm = code_matrix
    code_pop = cm.sum(-1)
    bits_pop = bits.sum(-1, keepdim=True)
    ham = bits_pop + code_pop[None, None, :] - 2.0 * torch.matmul(bits, cm.T)
    best = torch.argmin(ham, dim=-1)
    best_h = torch.gather(ham, -1, best[..., None])[..., 0]
    tag_id = torch.div(best, 4, rounding_mode="floor").to(torch.int32)
    rotation = (best % 4).to(torch.int32)
    ok_all = quad_valid & ok_models & (best_h <= MAX_HAMMING)

    # canonical-orientation homography: H' = H @ Rz(-rotation * 90deg)
    theta = -rotation.to(torch.float32) * (math.pi / 2)
    c = mathf.cos(theta)
    s = mathf.sin(theta)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    R = torch.stack([
        torch.stack([c, -s, zero], -1),
        torch.stack([s, c, zero], -1),
        torch.stack([zero, zero, one], -1)], -2)
    Hdet = bmm3(H, R)
    return {"ok": ok_all, "tag_id": tag_id,
            "hamming": best_h.to(torch.int32), "rotation": rotation,
            "margin": margin, "H": Hdet}

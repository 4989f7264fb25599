"""Tag pose estimation for every quad slot (PyTorch).

Counterpart of ros_vision_tpu/ops/pose.py: homography initialisation, then
Lu-Hager-Mjolsness orthogonal iteration with the Newton polar rotation,
and the mirror-seeded second candidate of the planar ambiguity; the lower
object-space error wins. Dense (B, NQ, 3, 3) f32 algebra over all slots.

Convention (apriltag): camera z out of the lens, x right, y down; tag z
into the tag. Detection corners p[0..3] <-> tag corners
(-1,1),(1,1),(1,-1),(-1,-1) scaled by tag_size/2.

estimate_poses dispatches by device: a CPU tensor runs
estimate_poses_plain, whose loops the host drives op by op; a CUDA tensor
launches P1, csrc/pose.cu, once a call: a warp a slot runs both
orthogonal iterations, its Newton polar steps spread over the lanes, the
counterpart of the JAX function's lax.fori_loops. The two agree to f32
rounding, not bit for bit: torch's order for its multi-axis sums is its
own.
"""
from __future__ import annotations

import ctypes

import torch

from ros_vision_tpu_torch import _build
from ros_vision_tpu_torch.device import host_syncs, kernel_route
from ros_vision_tpu_torch.ops import mathf
from ros_vision_tpu_torch.ops.decode import bmm3, bmv3, project

launches = _build.counter("estimate_poses")


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _cofactor(m):
    """Cofactor matrix of (..., 3, 3) m from cross products of its rows:
    adj(m) = C^T, det(m) = row0 . C[0]. Entry for entry the same products
    and differences as the JAX package's closed-form adjugate: rows
    r1 x r2, r2 x r0, r0 x r1 as one cross of the doubled rows' windows
    (two launches in place of ~40 scalar ops)."""
    mm = torch.cat([m, m], -2)
    return _cross(mm[..., 1:4, :], mm[..., 2:5, :])


def _safe_det(m, c):
    det = (m[..., 0, :] * c[..., 0, :]).sum(-1)
    return torch.where(torch.abs(det) < 1e-20, 1e-20, det)


def _inv3(m):
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    c = _cofactor(m)
    return c.transpose(-1, -2) / _safe_det(m, c)[..., None, None]


def polar_rotation(m: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Nearest rotation by Newton polar iteration X <- (X + X^-T)/2; det<0
    results (degenerate slots only) get a z-axis reflection fix."""
    nrm = torch.sqrt((m * m).sum((-1, -2), keepdim=True) / 3.0)
    x = m / torch.where(nrm < 1e-20, 1e-20, nrm)
    for _ in range(iters):
        c = _cofactor(x)                       # X^-T = C / det
        x = 0.5 * (x + c / _safe_det(x, c)[..., None, None])
    det = (x[..., 0, :] * _cofactor(x)[..., 0, :]).sum(-1)
    neg = (det < 0)[..., None, None]
    col2 = torch.arange(3, device=m.device) == 2
    return x * torch.where(neg & col2[None, :], -1.0, 1.0)


def _orthogonal_iteration(v, obj, r0, t0, n_steps=30):
    """v (..., 4, 3) sight rays; obj (4, 3) planar tag corners; r0
    (..., 3, 3); t0 (..., 3)."""
    vv = (v[..., :, :, None] * v[..., :, None, :]) / \
        (v * v).sum(-1)[..., None, None]                  # (..., 4, 3, 3)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    G = _inv3(eye - vv.mean(-3)) / v.shape[-2]
    p_res = obj - obj.mean(0)
    vv_eye = vv - eye
    r, t = r0, t0
    for _ in range(n_steps):
        rp = bmv3(r[..., None, :, :], obj)
        # sum_n (vv_n - I) rp_n: one product, one sum over n and j
        t = bmv3(G, (vv_eye * rp[..., None, :]).sum((-3, -1)))
        q = bmv3(vv, rp + t[..., None, :])
        q_mean = q.mean(-2, keepdim=True)
        m = bmm3((q - q_mean).transpose(-1, -2), p_res)
        # planar object: m's third column is zero; complete it with the
        # cross of the two data columns (the Procrustes-optimal null
        # direction) scaled to their geometric-mean norm
        c0 = m[..., :, 0]
        c1 = m[..., :, 1]
        c2 = _cross(c0, c1)
        n0 = torch.sqrt((c0 * c0).sum(-1))
        n1 = torch.sqrt((c1 * c1).sum(-1))
        c2n = torch.sqrt((c2 * c2).sum(-1))
        scale = torch.sqrt(n0 * n1) / c2n.clamp_min(1e-30)
        m = torch.stack([c0, c1, c2 * scale[..., None]], -1)
        r = polar_rotation(m)
    rp = bmv3(r[..., None, :, :], obj) + t[..., None, :]
    res = rp - bmv3(vv, rp)
    return r, t, (res * res).sum((-1, -2))


def _homography_init(H, fx, fy, cx, cy):
    r20 = H[..., 2, 0]
    r21 = H[..., 2, 1]
    tz = H[..., 2, 2]
    r00 = (H[..., 0, 0] - cx * r20) / fx
    r01 = (H[..., 0, 1] - cx * r21) / fx
    tx = (H[..., 0, 2] - cx * tz) / fx
    r10 = (H[..., 1, 0] - cy * r20) / fy
    r11 = (H[..., 1, 1] - cy * r21) / fy
    ty = (H[..., 1, 2] - cy * tz) / fy
    l1 = torch.sqrt(r00 * r00 + r10 * r10 + r20 * r20)
    l2 = torch.sqrt(r01 * r01 + r11 * r11 + r21 * r21)
    s = 1.0 / torch.sqrt((l1 * l2).clamp_min(1e-12))
    s = torch.where(tz < 0, -s, s)
    c0 = torch.stack([r00, r10, r20], -1) * s[..., None]
    c1 = torch.stack([r01, r11, r21], -1) * s[..., None]
    c2 = _cross(c0, c1)
    r = polar_rotation(torch.stack([c0, c1, c2], -1))
    t = torch.stack([tx, ty, tz], -1) * s[..., None]
    return r, t


def _axis_rotation(axis, ang):
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = torch.zeros_like(x)
    K = torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1)], -2)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    s = mathf.sin(ang)[..., None, None]
    c = (1 - mathf.cos(ang))[..., None, None]
    return eye + s * K + c * bmm3(K, K)


def pose_candidates_plain(Hdet: torch.Tensor, tag_size: float, fx, fy, cx,
                          cy, n_steps: int = 50, syncs=None):
    """estimate_poses_plain before its choice: the homography-seeded
    candidate (R1, t1, err1), the mirror-seeded one (R2, t2, err2) and
    sin_a, the sine of the tag normal's angle to the sight line. `syncs`
    (device.HostSyncs) counts the two tables' uploads."""
    dev = Hdet.device
    syncs = host_syncs(syncs)
    fx1, fy1, cx1, cy1 = (v.reshape(-1, 1) for v in (fx, fy, cx, cy))
    s = tag_size / 2.0
    obj = syncs.upload([[-s, s, 0], [s, s, 0], [s, -s, 0], [-s, -s, 0]],
                       dev, torch.float32)
    tcs = syncs.upload([[-1, 1], [1, 1], [1, -1], [-1, -1]], dev,
                       torch.float32)
    px, py = project(Hdet[..., None, :, :], tcs[:, 0], tcs[:, 1])
    v = torch.stack([(px - cx1[..., None]) / fx1[..., None],
                     (py - cy1[..., None]) / fy1[..., None],
                     torch.ones_like(px)], -1)

    r0, t0 = _homography_init(Hdet, fx1, fy1, cx1, cy1)
    t0 = t0 * s
    r1, t1, e1 = _orthogonal_iteration(v, obj, r0, t0, n_steps)

    # planar-ambiguity second candidate: mirror tilt about the sight line
    tn = t1 / torch.linalg.norm(t1, dim=-1, keepdim=True).clamp_min(1e-9)
    normal = r1[..., :, 2]
    axis = _cross(tn, normal)
    sin_a = torch.linalg.norm(axis, dim=-1)
    cos_a = (tn * normal).sum(-1)
    ang = -2.0 * mathf.atan2(sin_a, cos_a)
    axis = axis / sin_a.clamp_min(1e-9)[..., None]
    r2_init = bmm3(_axis_rotation(axis, ang), r1)
    r2, t2, e2 = _orthogonal_iteration(v, obj, r2_init, t1, n_steps)
    return (r1, t1, e1), (r2, t2, e2), sin_a


def estimate_poses_plain(Hdet: torch.Tensor, tag_size: float, fx, fy, cx,
                         cy, n_steps: int = 50, syncs=None):
    """Plain PyTorch version (any device): Hdet (B, NQ, 3, 3) canonical
    detection homographies; per-row intrinsics fx, fy, cx, cy (B,) ->
    (R (B,NQ,3,3), t (B,NQ,3), err (B,NQ)). Dense 3x3 algebra over all
    slots, its loops on the host (~14,000 launches a call on the card)."""
    (r1, t1, e1), (r2, t2, e2), sin_a = pose_candidates_plain(
        Hdet, tag_size, fx, fy, cx, cy, n_steps, syncs)
    use2 = (e2 < e1) & (sin_a > 1e-8)
    r = torch.where(use2[..., None, None], r2, r1)
    t = torch.where(use2[..., None], t2, t1)
    err = torch.where(use2, e2, e1)
    return r, t, err


def _estimate_poses_cuda(Hdet: torch.Tensor, tag_size: float, fx, fy, cx,
                         cy, n_steps: int = 50):
    """Launch csrc/pose.cu on a CUDA (B, NQ, 3, 3) f32 tensor and (B,) f32
    intrinsics: a warp a slot, one launch a call."""
    b, nq = Hdet.shape[:2]
    dev = Hdet.device
    _build.check_tensor(Hdet, "Hdet", torch.float32, (b, nq, 3, 3), dev)
    for name, v in (("fx", fx), ("fy", fy), ("cx", cx), ("cy", cy)):
        _build.check_tensor(v, name, torch.float32, (b,), dev)
    r = torch.empty((b, nq, 3, 3), dtype=torch.float32, device=dev)
    t = torch.empty((b, nq, 3), dtype=torch.float32, device=dev)
    err = torch.empty((b, nq), dtype=torch.float32, device=dev)
    if b * nq == 0:
        return r, t, err                    # no slot to write
    made = ctypes.c_int(0)
    _build.launch("rvt_estimate_poses", dev, Hdet, fx, fy, cx, cy, r, t, err,
                  ctypes.addressof(made), b, nq, float(tag_size),
                  int(n_steps))
    launches.add(made.value)
    return r, t, err


def estimate_poses(Hdet: torch.Tensor, tag_size: float, fx, fy, cx, cy,
                   n_steps: int = 50, syncs=None):
    """Hdet (B, NQ, 3, 3) canonical detection homographies; per-row
    intrinsics fx, fy, cx, cy (B,) -> (R (B,NQ,3,3), t (B,NQ,3),
    err (B,NQ)) for every slot; kernel on CUDA, plain version on the
    CPU."""
    if kernel_route(Hdet) == "cpu":
        return estimate_poses_plain(Hdet, tag_size, fx, fy, cx, cy, n_steps,
                                    syncs)
    b = Hdet.shape[0]
    intr = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                        device=Hdet.device).reshape(-1)
                        .expand(b) for v in (fx, fy, cx, cy)])
    return _estimate_poses_cuda(Hdet.to(torch.float32).contiguous(),
                                tag_size, *intr, n_steps)

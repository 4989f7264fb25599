"""Shared double-precision geometry for AprilTag detection (host side).

The port's copy of ros_vision_tpu/apriltag/geometry.py, numpy only:
quad line fitting from moment sums, homography compute/project, pose
estimation by orthogonal iteration, and the OpenCV 5-parameter lens
distortion model of the reference's RefineEdges
(apriltags_cuda/src/apriltag_detect.cu:307-402), which ops/rectify.py
builds its undistort map from.
"""
from __future__ import annotations

import numpy as np

# --------------------------------------------------------------------------
# Line fitting from cumulative moments
# --------------------------------------------------------------------------


def fit_line_from_moments(Mx, My, Mxx, Mxy, Myy, W, N):
    """Fit a line to a point set given weighted moment sums.

    Returns (Ex, Ey, nx, ny, err, mse) where (nx, ny) is the unit NORMAL of
    the fitted line, err = N * quadratic form (sum of squared normal
    distances), mse = err / N. Matches the reference's FitLine
    (line_fit_filter.cu:798-871) semantics.
    """
    Ex = Mx / W
    Ey = My / W
    Cxx = Mxx / W - Ex * Ex
    Cxy = Mxy / W - Ex * Ey
    Cyy = Myy / W - Ey * Ey
    normal_theta = 0.5 * np.arctan2(-2 * Cxy, Cyy - Cxx)
    nx = np.cos(normal_theta)
    ny = np.sin(normal_theta)
    mse = nx * nx * Cxx + 2 * nx * ny * Cxy + ny * ny * Cyy
    err = N * mse
    return Ex, Ey, nx, ny, err, mse


def intersect_lines(e0, n0, e1, n1):
    """Intersect two lines given (point, normal) parameterizations.

    Line i passes through e_i with direction (n_i[1], -n_i[0]).
    Returns (x, y, det) — caller rejects |det| < 1e-3 as the reference does.
    """
    a00, a01 = n0[1], -n1[1]
    a10, a11 = -n0[0], n1[0]
    b0 = -e0[0] + e1[0]
    b1 = -e0[1] + e1[1]
    det = a00 * a11 - a10 * a01
    if abs(det) < 1e-12:
        return 0.0, 0.0, det
    l0 = (a11 * b0 - a01 * b1) / det
    return e0[0] + l0 * a00, e0[1] + l0 * a10, det


# --------------------------------------------------------------------------
# Homographies
# --------------------------------------------------------------------------


def homography_compute(corr: np.ndarray) -> np.ndarray:
    """DLT homography from 4 correspondences [[x, y, u, v], ...] mapping
    (x, y) -> (u, v)."""
    a = []
    b = []
    for x, y, u, v in corr:
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b += [u, v]
    h = np.linalg.solve(np.asarray(a, np.float64), np.asarray(b, np.float64))
    return np.append(h, 1.0).reshape(3, 3)


def homography_project(h: np.ndarray, x: float, y: float):
    z = h[2, 0] * x + h[2, 1] * y + h[2, 2]
    return ((h[0, 0] * x + h[0, 1] * y + h[0, 2]) / z,
            (h[1, 0] * x + h[1, 1] * y + h[1, 2]) / z)


def quad_homography(p: np.ndarray) -> np.ndarray:
    """Homography mapping tag frame (-1,-1),(1,-1),(1,1),(-1,1) to the quad
    corners p (4, 2)."""
    corr = np.array([
        [-1, -1, p[0][0], p[0][1]],
        [1, -1, p[1][0], p[1][1]],
        [1, 1, p[2][0], p[2][1]],
        [-1, 1, p[3][0], p[3][1]],
    ], np.float64)
    return homography_compute(corr)


# --------------------------------------------------------------------------
# Gray models (local white/black intensity planes used by tag decode)
# --------------------------------------------------------------------------


class GrayModel:
    """Least-squares plane v ~ Ax + By + C over accumulated samples."""

    def __init__(self):
        self.ata = np.zeros((3, 3), np.float64)
        self.atb = np.zeros(3, np.float64)
        self.coeff = np.zeros(3, np.float64)
        self.n = 0

    def add(self, x, y, v):
        row = np.array([x, y, 1.0])
        self.ata += np.outer(row, row)
        self.atb += row * v
        self.n += 1

    def solve(self):
        # lstsq handles degenerate sample geometry (reference uses matd_solve
        # and can produce NaNs there; we prefer a defined result)
        self.coeff, *_ = np.linalg.lstsq(self.ata, self.atb, rcond=None)

    def interpolate(self, x, y):
        return self.coeff[0] * x + self.coeff[1] * y + self.coeff[2]


# --------------------------------------------------------------------------
# Lens distortion (OpenCV 5-parameter model: k1, k2, p1, p2, k3)
# --------------------------------------------------------------------------


def distort_points(pts, fx, fy, cx, cy, dist):
    """Apply distortion to pixel coords. pts (..., 2)."""
    k1, k2, p1, p2, k3 = dist
    x = (pts[..., 0] - cx) / fx
    y = (pts[..., 1] - cy) / fy
    r2 = x * x + y * y
    rad = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xd * fx + cx, yd * fy + cy], -1)


def undistort_points(pts, fx, fy, cx, cy, dist, iterations=100, eps=1e-6):
    """Iterative inverse distortion (same fixed-point iteration as the
    reference's GpuDetector::UnDistort, apriltag_detect.cu:335-402, with the
    standard tangential term — the reference has a typo'd p2 term we do not
    reproduce). pts (..., 2) pixel coords -> undistorted pixel coords."""
    k1, k2, p1, p2, k3 = dist
    x0 = (pts[..., 0] - cx) / fx
    y0 = (pts[..., 1] - cy) / fy
    x, y = x0.copy(), y0.copy()
    for _ in range(iterations):
        r2 = x * x + y * y
        rad = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        xn = (x0 - dx) / rad
        yn = (y0 - dy) / rad
        if np.max(np.abs(xn - x)) < eps and np.max(np.abs(yn - y)) < eps:
            x, y = xn, yn
            break
        x, y = xn, yn
    return np.stack([x * fx + cx, y * fy + cy], -1)


# --------------------------------------------------------------------------
# Pose estimation (apriltag convention: camera frame z out of the lens,
# x right, y down; tag frame x right, y down, z into the tag)
# --------------------------------------------------------------------------


def pose_object_points(tag_size: float) -> np.ndarray:
    """Object points matching detection corner order p[0..3]
    (apriltag_pose.c estimate_tag_pose_orthogonal_iteration)."""
    s = tag_size / 2.0
    return np.array([[-s, s, 0], [s, s, 0], [s, -s, 0], [-s, -s, 0]],
                    np.float64)


def homography_to_pose(H, fx, fy, cx, cy):
    """Initial pose from homography (apriltag common/homography.c
    homography_to_pose, sign conventions of apriltag_pose.c
    estimate_pose_for_tag_homography)."""
    r20 = H[2, 0]
    r21 = H[2, 1]
    tz = H[2, 2]
    r00 = (H[0, 0] - cx * r20) / fx
    r01 = (H[0, 1] - cx * r21) / fx
    tx = (H[0, 2] - cx * tz) / fx
    r10 = (H[1, 0] - cy * r20) / fy
    r11 = (H[1, 1] - cy * r21) / fy
    ty = (H[1, 2] - cy * tz) / fy

    # remove scale
    length1 = np.sqrt(r00 * r00 + r10 * r10 + r20 * r20)
    length2 = np.sqrt(r01 * r01 + r11 * r11 + r21 * r21)
    s = 1.0 / np.sqrt(length1 * length2)
    # keep tag in front of camera
    if tz < 0:
        s = -s
    r20 *= s; r21 *= s; tz *= s
    r00 *= s; r01 *= s; tx *= s
    r10 *= s; r11 *= s; ty *= s

    c0 = np.array([r00, r10, r20])
    c1 = np.array([r01, r11, r21])
    c2 = np.cross(c0, c1)
    r = np.stack([c0, c1, c2], axis=1)
    # polar-correct to the nearest rotation matrix
    u, _, vt = np.linalg.svd(r)
    r = u @ np.diag([1, 1, np.linalg.det(u @ vt)]) @ vt
    return r, np.array([tx, ty, tz])


def orthogonal_iteration(v_rays, obj_pts, r_init, t_init, n_steps=50):
    """Object-space-error pose refinement (Lu, Hager & Mjolsness), as used by
    apriltag_pose.c orthogonal_iteration. v_rays (n,3) unnormalized
    line-of-sight vectors [(u-cx)/fx, (v-cy)/fy, 1]; obj_pts (n,3).
    Returns (R, t, obj_space_err)."""
    n = len(obj_pts)
    F = np.empty((n, 3, 3))
    for i in range(n):
        v = v_rays[i]
        F[i] = np.outer(v, v) / (v @ v)
    avg_f = F.mean(0)
    G = np.linalg.inv(np.eye(3) - avg_f) / n
    p_mean = obj_pts.mean(0)
    p_res = obj_pts - p_mean

    r, t = r_init.copy(), t_init.copy()
    err = np.inf
    for _ in range(n_steps):
        # optimal translation given R
        t = G @ ((F - np.eye(3)) @ ((obj_pts @ r.T).reshape(n, 3, 1))).sum(0).ravel()
        q = np.einsum("nij,nj->ni", F, obj_pts @ r.T + t)
        q_mean = q.mean(0)
        m = (q - q_mean).T @ p_res
        u, _, vt = np.linalg.svd(m)
        r = u @ np.diag([1, 1, np.linalg.det(u @ vt)]) @ vt
        res = np.einsum("nij,nj->ni", np.eye(3) - F, obj_pts @ r.T + t)
        err = (res * res).sum()
    return r, t, err


def estimate_tag_pose_exhaustive(corners, tag_size, fx, fy, cx, cy,
                                 n_steps=50, n_dirs=8,
                                 tilts=(0.6, 1.2, 1.9, 2.6)):
    """Independent ambiguity oracle: exhaustive multi-start orthogonal
    iteration in f64.

    The reference resolves the planar pose ambiguity with apriltag's
    fix_pose_ambiguities (apriltag_pose.c, via estimate_tag_pose at
    apriltags_cuda_detector.cu:433), which finds the SECOND local minimum
    of the object-space error analytically (a quartic in the tilt
    parameter, after Schweighofer & Pinz 2006). This oracle upper-bounds
    that computation instead of porting it: every local minimum of the
    object-space error for a planar target lies on the one-parameter
    family of tilts about axes perpendicular to the sight line, so
    seeding orthogonal iteration from a dense grid of such tilts
    (n_dirs directions x len(tilts) magnitudes, plus the homography
    init) finds the global minimum AND the second minimum that the
    quartic would return — without relying on the mirror heuristic the
    production paths use. Used by tests/test_pose_ambiguity.py to check
    both the f64 mirror oracle (estimate_tag_pose) and the f32 device
    path (ops/pose.py) against reference-algorithm semantics.

    Returns (R, t, err, second_err): the best pose and the object-space
    errors of the two best distinct minima (second_err = inf if every
    start converged to one basin)."""
    obj = pose_object_points(tag_size)
    corr = np.array([
        [-1, 1, corners[0][0], corners[0][1]],
        [1, 1, corners[1][0], corners[1][1]],
        [1, -1, corners[2][0], corners[2][1]],
        [-1, -1, corners[3][0], corners[3][1]],
    ], np.float64)
    H = homography_compute(corr)
    r0, t0 = homography_to_pose(H, fx, fy, cx, cy)
    v = np.stack([(corners[:, 0] - cx) / fx, (corners[:, 1] - cy) / fy,
                  np.ones(4)], -1)
    t0 = t0 * (tag_size / 2.0)
    r1, t1, e1 = orthogonal_iteration(v, obj, r0, t0, n_steps)

    # basis perpendicular to the sight line to the tag center
    c = t1 / np.linalg.norm(t1)
    a1 = np.cross(c, [0.0, 0.0, 1.0])
    if np.linalg.norm(a1) < 1e-9:
        a1 = np.cross(c, [0.0, 1.0, 0.0])
    a1 /= np.linalg.norm(a1)
    a2 = np.cross(c, a1)

    sols = [(e1, r1, t1)]
    for k in range(n_dirs):
        phi = 2.0 * np.pi * k / n_dirs
        axis = np.cos(phi) * a1 + np.sin(phi) * a2
        K = np.array([[0, -axis[2], axis[1]],
                      [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        for psi in tilts:
            rot = np.eye(3) + np.sin(psi) * K + (1 - np.cos(psi)) * (K @ K)
            r, t, e = orthogonal_iteration(v, obj, rot @ r1, t1, n_steps)
            sols.append((e, r, t))
    sols.sort(key=lambda s: s[0])
    best = sols[0]
    second = np.inf
    for e, r, t in sols[1:]:
        # distinct basin: tag-plane normals differ by > ~5 degrees
        if float(r[:, 2] @ best[1][:, 2]) < 0.996:
            second = e
            break
    return best[1], best[2], best[0], second


def estimate_tag_pose(corners, tag_size, fx, fy, cx, cy, n_steps=50):
    """Full pose estimate with planar-ambiguity handling: refine from the
    homography init and from the mirrored-tilt init, return the lower
    object-space-error solution (same selection rule as apriltag_pose.c
    estimate_tag_pose). Returns (R, t, err)."""
    obj = pose_object_points(tag_size)
    corr = np.array([
        [-1, 1, corners[0][0], corners[0][1]],
        [1, 1, corners[1][0], corners[1][1]],
        [1, -1, corners[2][0], corners[2][1]],
        [-1, -1, corners[3][0], corners[3][1]],
    ], np.float64)
    H = homography_compute(corr)
    r0, t0 = homography_to_pose(H, fx, fy, cx, cy)
    v = np.stack([(corners[:, 0] - cx) / fx, (corners[:, 1] - cy) / fy,
                  np.ones(4)], -1)
    # scale object points: homography maps the unit square (±1) while object
    # points are metric — rescale init translation accordingly
    t0 = t0 * (tag_size / 2.0)
    r1, t1, e1 = orthogonal_iteration(v, obj, r0, t0, n_steps)

    # second candidate: mirror the plane normal about the line of sight to
    # the tag center (the classical planar pose ambiguity)
    c = t1 / np.linalg.norm(t1)
    normal = r1[:, 2]
    axis = np.cross(c, normal)
    sin_a = np.linalg.norm(axis)
    if sin_a > 1e-8:
        axis = axis / sin_a
        cos_a = float(np.clip(c @ normal, -1, 1))
        ang = -2.0 * np.arctan2(sin_a, cos_a)
        K = np.array([[0, -axis[2], axis[1]],
                      [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        rot = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)
        r2, t2, e2 = orthogonal_iteration(v, obj, rot @ r1, t1, n_steps)
        if e2 < e1:
            return r2, t2, e2
    return r1, t1, e1

# Frozen copy of ros_vision_tpu_torch/apriltag/oracle.py
# at commit 5b978635277ede7c3d2dd15eeb95ccc7be8ca268,
# kept for the benchmark alone, so that the yardstick does not move
# when the port does. Only the imports were changed.
"""CPU reference AprilTag detector (NumPy, double precision).

The port's own copy of ros_vision_tpu/apriltag/oracle.py, on the port's
families and geometry copies. This is the parity oracle for the detector
pipeline, playing the role the CPU apriltag C library plays in the
reference's tests (gpu_detector_test.cu:85-120: the GPU detector must agree
with the CPU detector on golden images).

It implements the AprilTag-3 detection algorithm the reference's CUDA chain is
derived from, with the frc971 pipeline's behavioral choices where they differ:
  - fixed quad_decimate = 2 (apriltag_gpu.cu:166)
  - adaptive threshold exactly as threshold.cu:60-147 (4x4 tile min/max,
    3x3 min/max dilation, min_white_black_diff, {0,127,255} output)
  - atan2-based point angles (apriltag_gpu.cu:396-412 uses atan2f fixed-point)
  - undistortion-aware RefineEdges (apriltag_detect.cu:307-402)

Every pipeline intermediate is retained on the result object, mirroring the
reference's GpuDetector::Copy*To debug taps (apriltag_gpu.h:98-183) so the
device implementation can be compared stage by stage.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import scipy.ndimage as ndi

from benchmark.reference.families import TagFamily, get_family
from benchmark.reference import geometry as geo

# Detector defaults (apriltag_detector_create defaults, as used by the
# reference's setup_apriltags, apriltags_cuda_detector.cu:137-193)
QUAD_DECIMATE = 2
MIN_WHITE_BLACK_DIFF = 5
MAX_NMAXIMA = 10
MAX_LINE_FIT_MSE = 10.0
COS_CRITICAL_RAD = math.cos(10 * math.pi / 180)
DECODE_SHARPENING = 0.25
MAX_HAMMING = 2
MIN_BLOB_PIXELS = 25       # gradient_clusters set-size gate
MIN_CLUSTER_POINTS = 24    # fit_quad minimum boundary points


@dataclasses.dataclass
class Detection:
    tag_id: int
    hamming: int
    decision_margin: float
    center: np.ndarray       # (2,)
    corners: np.ndarray      # (4,2) full-res pixel coords; p[0] <-> tag (-1,+1)
    H: np.ndarray            # (3,3) tag->image homography
    pose_R: np.ndarray | None = None
    pose_t: np.ndarray | None = None
    pose_err: float | None = None


@dataclasses.dataclass
class DetectResult:
    detections: list
    # stage taps (decimated-resolution unless noted):
    gray: np.ndarray | None = None            # full-res grayscale
    decimated: np.ndarray | None = None
    minmax_unfiltered: np.ndarray | None = None  # (th, tw, 2)
    minmax: np.ndarray | None = None             # (th, tw, 2)
    thresholded: np.ndarray | None = None
    labels: np.ndarray | None = None
    blob_sizes: dict | None = None
    clusters: dict | None = None              # (rep0,rep1) -> (n,4) [x,y,gx,gy]
    quads: list | None = None                 # decimated-frame quads pre-adjust
    quads_fullres: list | None = None


def adaptive_threshold(decim: np.ndarray,
                       min_white_black_diff: int = MIN_WHITE_BLACK_DIFF):
    """Tile-based adaptive threshold (threshold.cu:60-147).

    Returns (thresholded, minmax_unfiltered, minmax) where thresholded is
    uint8 in {0, 127, 255}."""
    h, w = decim.shape
    assert w % 4 == 0 and h % 4 == 0
    th, tw = h // 4, w // 4
    tiles = decim.reshape(th, 4, tw, 4)
    tmin = tiles.min(axis=(1, 3))
    tmax = tiles.max(axis=(1, 3))
    unfiltered = np.stack([tmin, tmax], -1)
    # 3x3 min/max dilation with edge clamping (out-of-bounds excluded)
    fmin = ndi.minimum_filter(tmin, size=3, mode="nearest")
    fmax = ndi.maximum_filter(tmax, size=3, mode="nearest")
    minmax = np.stack([fmin, fmax], -1)
    pmin = np.repeat(np.repeat(fmin, 4, 0), 4, 1)
    pmax = np.repeat(np.repeat(fmax, 4, 0), 4, 1)
    spread_ok = (pmax.astype(np.int32) - pmin) >= min_white_black_diff
    thresh = pmin + (pmax.astype(np.int32) - pmin) // 2
    out = np.where(decim > thresh, np.uint8(255), np.uint8(0))
    out = np.where(spread_ok, out, np.uint8(127)).astype(np.uint8)
    return out, unfiltered, minmax


_S4 = ndi.generate_binary_structure(2, 1)   # 4-connectivity
_S8 = ndi.generate_binary_structure(2, 2)   # 8-connectivity


def connected_components(threshim: np.ndarray):
    """Same-value connected components: 4-way for black, 8-way for white
    (apriltag unionfind semantics; frc971 BKE labeling N3). Returns int32
    label image (0 = unlabeled/127) and a size array indexed by label."""
    black, nb = ndi.label(threshim == 0, structure=_S4)
    white, nw = ndi.label(threshim == 255, structure=_S8)
    labels = np.where(threshim == 255, white + nb, black).astype(np.int32)
    sizes = np.bincount(labels.ravel(), minlength=nb + nw + 1)
    sizes[0] = 0
    return labels, sizes


def gradient_clusters(threshim: np.ndarray, labels: np.ndarray,
                      sizes: np.ndarray):
    """Boundary points between black/white blob pairs (quad_thresh
    gradient_clusters; BlobDiff kernel apriltag_gpu.cu:226-360).

    Returns dict (rep_small, rep_big) -> (n, 4) int arrays [x, y, gx, gy]
    with x = 2*px + dx, y = 2*py + dy in double-resolution decimated coords.
    """
    h, w = threshim.shape
    v = threshim.astype(np.int16)
    big = sizes >= MIN_BLOB_PIXELS

    keys = []
    pts = []
    # connections from pixel (x,y), x in [1, w-2], y in [0, h-2] (apriltag
    # loops y from 1; the first row generates no valid up-connections anyway)
    for dx, dy in ((1, 0), (0, 1), (-1, 1), (1, 1)):
        x0, x1 = 1, w - 1          # x range of source pixels
        y0, y1 = 1, h - 1
        sl_src = (slice(y0, y1), slice(x0, x1))
        sl_dst = (slice(y0 + dy, y1 + dy), slice(x0 + dx, x1 + dx))
        v0 = v[sl_src]
        v1 = v[sl_dst]
        mask = (v0 + v1) == 255
        r0 = labels[sl_src]
        r1 = labels[sl_dst]
        mask &= big[r0] & big[r1]
        yy, xx = np.nonzero(mask)
        if len(yy) == 0:
            continue
        px = xx + x0
        py = yy + y0
        g = (v1[yy, xx] - v0[yy, xx])  # ±255
        rep0 = r0[yy, xx]
        rep1 = r1[yy, xx]
        lo = np.minimum(rep0, rep1)
        hi = np.maximum(rep0, rep1)
        keys.append(np.stack([lo, hi], -1))
        pts.append(np.stack([
            2 * px + dx, 2 * py + dy,
            dx * g, dy * g], -1))
    if not keys:
        return {}
    keys = np.concatenate(keys)
    pts = np.concatenate(pts)
    # group by key
    order = np.lexsort((keys[:, 1], keys[:, 0]))
    keys = keys[order]
    pts = pts[order]
    change = np.ones(len(keys), bool)
    change[1:] = np.any(keys[1:] != keys[:-1], axis=1)
    starts = np.nonzero(change)[0]
    ends = np.append(starts[1:], len(keys))
    out = {}
    for s, e in zip(starts, ends):
        out[(int(keys[s, 0]), int(keys[s, 1]))] = pts[s:e]
    return out


def compute_lfps(pts_sorted: np.ndarray, decim: np.ndarray):
    """Cumulative weighted line-fit moments (compute_lfps; frc971
    TransformLineFitPoint apriltag_gpu.cu:631-672). pts_sorted (n,4) in
    double-res coords. Returns (n, 6) prefix sums [Mx,My,Mxx,Mxy,Myy,W]."""
    h, w = decim.shape
    x = pts_sorted[:, 0] * 0.5 + 0.5
    y = pts_sorted[:, 1] * 0.5 + 0.5
    ix = x.astype(np.int64)
    iy = y.astype(np.int64)
    W = np.ones(len(x))
    ok = (ix > 0) & (ix + 1 < w) & (iy > 0) & (iy + 1 < h)
    ixs = np.clip(ix, 1, w - 2)
    iys = np.clip(iy, 1, h - 2)
    gx = decim[iys, ixs + 1].astype(np.float64) - decim[iys, ixs - 1]
    gy = decim[iys + 1, ixs].astype(np.float64) - decim[iys - 1, ixs]
    W = np.where(ok, np.sqrt(gx * gx + gy * gy) + 1, 1.0)
    m = np.stack([W * x, W * y, W * x * x, W * x * y, W * y * y, W], -1)
    return np.cumsum(m, axis=0)


def _fit_line(lfps: np.ndarray, i0: int, i1: int):
    """fit_line over cluster indices [i0..i1] (inclusive, circular)."""
    sz = len(lfps)
    if i0 < i1:
        m = lfps[i1] - (lfps[i0 - 1] if i0 > 0 else 0)
        n = i1 - i0 + 1
    else:
        m = lfps[sz - 1] - lfps[i0 - 1] + lfps[i1]
        n = sz - i0 + i1 + 1
    return geo.fit_line_from_moments(m[0], m[1], m[2], m[3], m[4], m[5], n)


def quad_segment_maxima(lfps: np.ndarray):
    """Corner-candidate search (quad_segment_maxima; frc971 DoFitLines +
    DoFitQuads). Returns indices[4] or None."""
    sz = len(lfps)
    ksz = min(20, sz // 12)
    if ksz < 2:
        return None

    # windowed line-fit error per point (circular window of 2*ksz+1),
    # vectorized over all points via prefix-sum differences
    idx = np.arange(sz)
    i0s = (idx - ksz) % sz
    i1s = (idx + ksz) % sz
    zero = np.zeros((1, 6))
    pref_m1 = np.concatenate([zero, lfps[:-1]], axis=0)  # prefix before i
    direct = i0s <= i1s
    total = lfps[-1]
    m = np.where(direct[:, None],
                 lfps[i1s] - pref_m1[i0s],
                 total - (pref_m1[i0s] - lfps[i1s]))
    n = np.where(direct, i1s - i0s + 1, sz - i0s + i1s + 1)
    errs = geo.fit_line_from_moments(
        m[:, 0], m[:, 1], m[:, 2], m[:, 3], m[:, 4], m[:, 5], n)[4]

    # 7-tap unnormalized gaussian smoothing, circular (sigma = 1)
    f = np.exp(-np.arange(-3, 4) ** 2 / 2.0)
    errs = sum(f[j + 3] * errs[(idx + j) % sz] for j in range(-3, 4))

    nxt = np.roll(errs, -1)
    prv = np.roll(errs, 1)
    maxima = np.nonzero((errs > nxt) & (errs > prv))[0]
    if len(maxima) < 4:
        return None
    merrs = errs[maxima]
    if len(maxima) > MAX_NMAXIMA:
        thresh = np.sort(merrs)[::-1][MAX_NMAXIMA]
        keep = merrs > thresh
        maxima = maxima[keep]
        if len(maxima) < 4:
            return None

    # exhaustive 4-combination search
    nm = len(maxima)
    best_err = np.inf
    best = None
    for m0 in range(nm - 3):
        i0 = int(maxima[m0])
        for m1 in range(m0 + 1, nm - 2):
            i1 = int(maxima[m1])
            _, _, nx01, ny01, err01, mse01 = _fit_line(lfps, i0, i1)
            if mse01 > MAX_LINE_FIT_MSE:
                continue
            for m2 in range(m1 + 1, nm - 1):
                i2 = int(maxima[m2])
                _, _, nx12, ny12, err12, mse12 = _fit_line(lfps, i1, i2)
                if mse12 > MAX_LINE_FIT_MSE:
                    continue
                dot = nx01 * nx12 + ny01 * ny12
                if abs(dot) > COS_CRITICAL_RAD:
                    continue
                for m3 in range(m2 + 1, nm):
                    i3 = int(maxima[m3])
                    err23, mse23 = _fit_line(lfps, i2, i3)[4:6]
                    if mse23 > MAX_LINE_FIT_MSE:
                        continue
                    err30, mse30 = _fit_line(lfps, i3, i0)[4:6]
                    if mse30 > MAX_LINE_FIT_MSE:
                        continue
                    err = err01 + err12 + err23 + err30
                    if err < best_err:
                        best_err = err
                        best = (i0, i1, i2, i3)
    if best is None or best_err / sz > MAX_LINE_FIT_MSE:
        return None
    return best


def fit_quad(pts: np.ndarray, decim: np.ndarray, tag_width: int = 4,
             normal_border: bool = True, reversed_border: bool = False):
    """Fit one quad to a boundary cluster (fit_quad). Returns (4,2) corners
    in decimated pixel coords or None."""
    sz = len(pts)
    if sz < MIN_CLUSTER_POINTS:
        return None
    xmax, ymax = pts[:, 0].max(), pts[:, 1].max()
    xmin, ymin = pts[:, 0].min(), pts[:, 1].min()
    if (xmax - xmin) * (ymax - ymin) < tag_width:
        return None
    cx = (xmin + xmax) * 0.5 + 0.05118
    cy = (ymin + ymax) * 0.5 - 0.028581
    dx = pts[:, 0] - cx
    dy = pts[:, 1] - cy
    dot = np.sum(dx * pts[:, 2] + dy * pts[:, 3])
    rev = dot < 0
    if not reversed_border and rev:
        return None
    if not normal_border and not rev:
        return None
    # sort by angle about the (biased) center — atan2, as frc971 does
    # (AddThetaToIndexPoint, apriltag_gpu.cu:396-412)
    theta = np.arctan2(dy, dx)
    order = np.argsort(theta, kind="stable")
    pts = pts[order]

    lfps = compute_lfps(pts, decim)
    indices = quad_segment_maxima(lfps)
    if indices is None:
        return None

    lines = []
    for i in range(4):
        i0, i1 = indices[i], indices[(i + 1) & 3]
        ex, ey, nx, ny, err, mse = _fit_line(lfps, i0, i1)
        if mse > MAX_LINE_FIT_MSE:
            return None
        lines.append((ex, ey, nx, ny))

    corners = np.empty((4, 2))
    for i in range(4):
        e0 = lines[i][:2]
        n0 = lines[i][2:]
        e1 = lines[(i + 1) & 3][:2]
        n1 = lines[(i + 1) & 3][2:]
        x, y, det = geo.intersect_lines(e0, n0, e1, n1)
        if abs(det) < 1e-3:
            return None
        corners[(i + 1) & 3] = (x, y)

    # area (two triangles), reject too-small quads
    def tri_area(p0, p1, p2):
        return 0.5 * abs((p1[0] - p0[0]) * (p2[1] - p0[1]) -
                         (p2[0] - p0[0]) * (p1[1] - p0[1]))
    area = tri_area(corners[0], corners[1], corners[2]) + \
        tri_area(corners[2], corners[3], corners[0])
    if area < 0.95 * tag_width * tag_width:
        return None

    # cumulative angle / winding check
    for i in range(4):
        p0, p1, p2 = corners[i], corners[(i + 1) & 3], corners[(i + 2) & 3]
        dx1, dy1 = p1 - p0
        dx2, dy2 = p2 - p1
        cos_dt = (dx1 * dx2 + dy1 * dy2) / math.sqrt(
            (dx1 * dx1 + dy1 * dy1) * (dx2 * dx2 + dy2 * dy2))
        if abs(cos_dt) > COS_CRITICAL_RAD or dx1 * dy2 < dy1 * dx2:
            return None
    return corners


def refine_edges(gray: np.ndarray, corners: np.ndarray,
                 intrinsics=None, dist=None, reversed_border: bool = False):
    """Subpixel edge refinement on the full-res gray image (apriltag
    refine_edges; frc971 variant fits in undistorted space when calibration
    is provided, apriltag_detect.cu:404-...)."""
    h, w = gray.shape
    undistort = intrinsics is not None and dist is not None and np.any(dist)
    lines = []
    for edge in range(4):
        a, b = edge, (edge + 1) & 3
        nx = corners[b][1] - corners[a][1]
        ny = -corners[b][0] + corners[a][0]
        mag = math.hypot(nx, ny)
        nx /= mag
        ny /= mag
        nsamples = max(16, int(mag / 8))
        Mx = My = Mxx = Mxy = Myy = N = 0.0
        for s in range(nsamples):
            alpha = (1.0 + s) / (nsamples + 1)
            x0 = alpha * corners[a][0] + (1 - alpha) * corners[b][0]
            y0 = alpha * corners[a][1] + (1 - alpha) * corners[b][1]
            rng = QUAD_DECIMATE + 1
            n = -rng
            while n <= rng:
                grange = 1.0
                x1 = int(x0 + (n + grange) * nx)
                y1 = int(y0 + (n + grange) * ny)
                x2 = int(x0 + (n - grange) * nx)
                y2 = int(y0 + (n - grange) * ny)
                if (0 <= x1 < w and 0 <= y1 < h and 0 <= x2 < w
                        and 0 <= y2 < h):
                    g1 = int(gray[y1, x1])
                    g2 = int(gray[y2, x2])
                    # normal tags: darker inside (g1 outside >= g2
                    # inside); reversed-border families invert
                    if (g2 >= g1) if reversed_border else (g1 >= g2):
                        weight = (g2 - g1) * (g2 - g1)
                        xo = x0 + n * nx
                        yo = y0 + n * ny
                        if undistort:
                            fx, fy, cxx, cyy = intrinsics
                            u = geo.undistort_points(
                                np.array([xo, yo]), fx, fy, cxx, cyy, dist)
                            xo, yo = float(u[0]), float(u[1])
                        Mx += weight * xo
                        My += weight * yo
                        Mxx += weight * xo * xo
                        Mxy += weight * xo * yo
                        Myy += weight * yo * yo
                        N += weight
                n += 0.25
        if N < 1e-12:
            return corners  # couldn't refine; keep original
        Ex, Ey = Mx / N, My / N
        Cxx = Mxx / N - Ex * Ex
        Cxy = Mxy / N - Ex * Ey
        Cyy = Myy / N - Ey * Ey
        normal_theta = 0.5 * math.atan2(-2 * Cxy, Cyy - Cxx)
        lines.append((Ex, Ey, math.cos(normal_theta), math.sin(normal_theta)))

    out = corners.copy()
    if undistort:
        fx, fy, cxx, cyy = intrinsics
    for i in range(4):
        e0, n0 = lines[i][:2], lines[i][2:]
        e1, n1 = lines[(i + 1) & 3][:2], lines[(i + 1) & 3][2:]
        x, y, det = geo.intersect_lines(e0, n0, e1, n1)
        if abs(det) > 1e-3:
            if undistort:
                p = geo.distort_points(np.array([x, y]), fx, fy, cxx, cyy, dist)
                x, y = float(p[0]), float(p[1])
            out[(i + 1) & 3] = (x, y)
    return out


def _value_for_pixel(gray: np.ndarray, px: float, py: float):
    """Bilinear sample with apriltag's half-pixel convention."""
    h, w = gray.shape
    x1 = math.floor(px - 0.5)
    x2 = math.ceil(px - 0.5)
    x = px - 0.5 - x1
    y1 = math.floor(py - 0.5)
    y2 = math.ceil(py - 0.5)
    y = py - 0.5 - y1
    if x1 < 0 or x2 >= w or y1 < 0 or y2 >= h:
        return -1.0
    return (gray[y1, x1] * (1 - x) * (1 - y) + gray[y1, x2] * x * (1 - y) +
            gray[y2, x1] * (1 - x) * y + gray[y2, x2] * x * y)


def quad_decode(gray: np.ndarray, corners: np.ndarray, family: TagFamily):
    """Decode a quad against the family (apriltag.c quad_decode).

    Returns (tag_id, hamming, rotation, decision_margin) or None."""
    h, w = gray.shape
    H = geo.quad_homography(corners)
    wb = family.border_size      # width_at_border (8 for 36h11)
    total = family.total_width   # total_width (10; larger for layouts
    # whose data bits sit outside the border, e.g. tagStandard41h12)

    white = geo.GrayModel()
    black = geo.GrayModel()
    patterns = [
        (-0.5, 0.5, 0, 1, True), (0.5, 0.5, 0, 1, False),
        (wb + 0.5, 0.5, 0, 1, True), (wb - 0.5, 0.5, 0, 1, False),
        (0.5, -0.5, 1, 0, True), (0.5, 0.5, 1, 0, False),
        (0.5, wb + 0.5, 1, 0, True), (0.5, wb - 0.5, 1, 0, False),
    ]
    if family.reversed_border:
        # white ring INSIDE the quad edge, black surround outside
        patterns = [(sx, sy, dx, dy, not w) for sx, sy, dx, dy, w in patterns]
    for sx, sy, dx, dy, is_white in patterns:
        for i in range(wb):
            tagx = 2 * ((sx + i * dx) / wb - 0.5)
            tagy = 2 * ((sy + i * dy) / wb - 0.5)
            px, py = geo.homography_project(H, tagx, tagy)
            ix, iy = int(px), int(py)
            if ix < 0 or iy < 0 or ix >= w or iy >= h:
                continue
            v = float(gray[iy, ix])
            (white if is_white else black).add(tagx, tagy, v)
    white.solve()
    black.solve()
    if white.interpolate(0, 0) - black.interpolate(0, 0) < 0:
        return None

    # sample data bits into a (total, total) field for sharpening
    bit_coords = family.bit_coords()
    min_coord = (wb - total) // 2  # -1 for classic dense
    values = np.zeros((total, total))
    for i in range(family.nbits):
        bitx, bity = int(bit_coords[i, 0]), int(bit_coords[i, 1])
        tagx = 2 * ((bitx + 0.5) / wb - 0.5)
        tagy = 2 * ((bity + 0.5) / wb - 0.5)
        px, py = geo.homography_project(H, tagx, tagy)
        v = _value_for_pixel(gray, px, py)
        if v == -1.0:
            continue
        thresh = (black.interpolate(tagx, tagy) +
                  white.interpolate(tagx, tagy)) / 2.0
        values[bity - min_coord, bitx - min_coord] = v - thresh

    # decode sharpening (apriltag.c sharpen)
    k = np.array([[0, -1, 0], [-1, 4, -1], [0, -1, 0]], np.float64)
    sharpened = ndi.convolve(values, k, mode="constant", cval=0.0)
    values = values + DECODE_SHARPENING * sharpened

    rcode = np.uint64(0)
    white_score = black_score = 0.0
    white_cnt = black_cnt = 1.0
    for i in range(family.nbits):
        bitx, bity = int(bit_coords[i, 0]), int(bit_coords[i, 1])
        v = values[bity - min_coord, bitx - min_coord]
        rcode = np.uint64(rcode << np.uint64(1))
        if v > 0:
            white_score += v
            white_cnt += 1
            rcode |= np.uint64(1)
        else:
            black_score -= v
            black_cnt += 1

    # match against all codes, all rotations
    xor = family.codes ^ rcode
    ham = np.zeros(xor.shape, np.int64)
    x = xor.copy()
    for _ in range(family.nbits):
        ham += (x & np.uint64(1)).astype(np.int64)
        x >>= np.uint64(1)
    best = np.unravel_index(np.argmin(ham), ham.shape)
    best_h = int(ham[best])
    if best_h > MAX_HAMMING:
        return None
    margin = min(white_score / white_cnt, black_score / black_cnt)
    return int(best[0]), best_h, int(best[1]), float(margin)


def reconcile_detections(dets: list) -> list:
    """Prune duplicate detections of the same tag (reconcile_detections):
    keep lower hamming, then higher decision margin."""
    out = []
    for d in dets:
        dup = None
        for o in out:
            if o.tag_id == d.tag_id and \
                    np.linalg.norm(o.center - d.center) < \
                    0.5 * np.linalg.norm(o.corners[0] - o.corners[2]):
                dup = o
                break
        if dup is None:
            out.append(d)
        elif (d.hamming, -d.decision_margin) < (dup.hamming,
                                                -dup.decision_margin):
            out[out.index(dup)] = d
    return out


class OracleDetector:
    """Full-pipeline CPU detector: gray frame -> Detections (+ stage taps)."""

    def __init__(self, family: str | TagFamily = "tag36h11",
                 tag_size: float = 0.1651,
                 fx: float | None = None, fy: float | None = None,
                 cx: float | None = None, cy: float | None = None,
                 dist: np.ndarray | None = None,
                 refine: bool = True, estimate_pose: bool = False,
                 keep_taps: bool = True):
        self.family = family if isinstance(family, TagFamily) \
            else get_family(family)
        self.tag_size = tag_size
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.dist = dist if dist is not None else np.zeros(5)
        self.refine = refine
        self.estimate_pose = estimate_pose
        self.keep_taps = keep_taps

    def detect(self, gray: np.ndarray) -> DetectResult:
        gray = np.asarray(gray)
        assert gray.ndim == 2 and gray.dtype == np.uint8
        h, w = gray.shape
        assert w % 8 == 0 and h % 8 == 0, "width/height must be %8==0"
        decim = gray[::2, ::2]

        threshim, unfiltered, minmax = adaptive_threshold(decim)
        labels, sizes = connected_components(threshim)
        clusters = gradient_clusters(threshim, labels, sizes)

        # min tag width in decimated pixels (apriltag: width_at_border /
        # quad_decimate, floor 3) — 36h11: 8/2 = 4
        tag_width = max(3, self.family.border_size // QUAD_DECIMATE)

        max_perimeter = 3 * (2 * decim.shape[1] + 2 * decim.shape[0])
        quads = []
        for key, pts in clusters.items():
            if len(pts) > max_perimeter:
                continue
            q = fit_quad(pts.astype(np.float64), decim, tag_width=tag_width,
                         normal_border=not self.family.reversed_border,
                         reversed_border=self.family.reversed_border)
            if q is not None:
                quads.append(q)

        # decimation un-scale to full-res coords (AdjustPixelCenters,
        # apriltag_detect.cu:260-282)
        quads_full = [(q - 0.5) * QUAD_DECIMATE + 0.5 for q in quads]

        intr = None
        if self.fx is not None:
            intr = (self.fx, self.fy, self.cx, self.cy)
        if self.refine:
            quads_full = [refine_edges(gray, q, intr, self.dist,
                                       self.family.reversed_border)
                          for q in quads_full]

        dets = []
        for q in quads_full:
            r = quad_decode(gray, q, self.family)
            if r is None:
                continue
            tag_id, hamming, rotation, margin = r
            # rotate the homography to canonical orientation
            theta = -rotation * math.pi / 2.0
            c, s = math.cos(theta), math.sin(theta)
            R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)
            Hdet = geo.quad_homography(q) @ R
            center = np.array(geo.homography_project(Hdet, 0, 0))
            corners = np.empty((4, 2))
            for i in range(4):
                tcx = 1 if i in (1, 2) else -1
                tcy = 1 if i < 2 else -1
                corners[i] = geo.homography_project(Hdet, tcx, tcy)
            det = Detection(tag_id, hamming, margin, center, corners, Hdet)
            dets.append(det)

        dets = reconcile_detections(dets)
        dets.sort(key=lambda d: d.tag_id)

        if self.estimate_pose and intr is not None:
            for d in dets:
                corners = d.corners
                if np.any(self.dist):
                    corners = geo.undistort_points(
                        corners, *intr, self.dist)
                R, t, err = geo.estimate_tag_pose(
                    corners, self.tag_size, *intr)
                d.pose_R, d.pose_t, d.pose_err = R, t, err

        res = DetectResult(detections=dets)
        if self.keep_taps:
            res.gray = gray
            res.decimated = decim
            res.minmax_unfiltered = unfiltered
            res.minmax = minmax
            res.thresholded = threshim
            res.labels = labels
            res.blob_sizes = sizes
            res.clusters = clusters
            res.quads = quads
            res.quads_fullres = quads_full
        return res

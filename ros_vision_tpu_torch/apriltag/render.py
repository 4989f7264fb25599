"""Synthetic AprilTag scene rendering for tests and benchmarks.

The reference validates its GPU detector against photos containing known tags
(gpu_detector_test.cu:85-120). We additionally generate synthetic scenes with
exactly-known tag ids/corners/poses so parity tests don't depend on external
binary assets.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ros_vision_tpu_torch.apriltag.families import TagFamily, get_family


@dataclasses.dataclass
class PlacedTag:
    tag_id: int
    corners: np.ndarray  # (4, 2) float64, outer black-border corners, pixel
    # coords, order: (-1,-1),(1,-1),(1,1),(-1,1) in tag frame (tl,tr,br,bl of
    # the canonical upright tag)


def _homography_from_corners(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """DLT homography mapping src (4,2) -> dst (4,2)."""
    a = []
    b = []
    for (x, y), (u, v) in zip(src, dst):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b += [u, v]
    h = np.linalg.solve(np.asarray(a, np.float64), np.asarray(b, np.float64))
    return np.append(h, 1.0).reshape(3, 3)


def render_scene(
    tag_ids: list[int],
    corners_list: list[np.ndarray],
    width: int = 1280,
    height: int = 800,
    family: TagFamily | None = None,
    background: int = 180,
    noise_sigma: float = 0.0,
    supersample: int = 3,
    seed: int = 0,
) -> tuple[np.ndarray, list[PlacedTag]]:
    """Render grayscale scene with tags warped to the given corner quads.

    corners_list[i] is (4,2): destination pixel coords of the OUTER black
    border corners of tag_ids[i], in tag-frame order tl,tr,br,bl.
    Inverse-warp sampling with supersampling for clean anti-aliased edges.
    """
    fam = family or get_family()
    img = np.full((height, width), background, np.float64)
    placed = []
    wb = fam.border_size
    side, off = fam.pattern_geometry()
    for tag_id, dst in zip(tag_ids, corners_list):
        dst = np.asarray(dst, np.float64)
        # Tag-frame source square: outer border-square corners span
        # [0, wb] modules; the full pattern (incl. quiet zone and any
        # outside-the-border data bits) covers [-off, side - off).
        src = np.array([[0, 0], [wb, 0], [wb, wb], [0, wb]], np.float64)
        hmat = _homography_from_corners(src, dst)
        hinv = np.linalg.inv(hmat)
        timg = fam.module_image(tag_id).astype(np.float64)

        # Bounding box of the full pattern quad in the image
        lo, hi = -off, side - off
        qz = np.array([[lo, lo], [hi, lo], [hi, hi], [lo, hi]], np.float64)
        qz_h = np.concatenate([qz, np.ones((4, 1))], 1) @ hmat.T
        qz_px = qz_h[:, :2] / qz_h[:, 2:3]
        x0 = max(0, int(np.floor(qz_px[:, 0].min())))
        x1 = min(width, int(np.ceil(qz_px[:, 0].max())) + 1)
        y0 = max(0, int(np.floor(qz_px[:, 1].min())))
        y1 = min(height, int(np.ceil(qz_px[:, 1].max())) + 1)
        if x1 <= x0 or y1 <= y0:
            continue

        ss = supersample
        ys, xs = np.mgrid[y0:y1, x0:x1]
        acc = np.zeros((y1 - y0, x1 - x0), np.float64)
        for sy in range(ss):
            for sx in range(ss):
                # apriltag pixel convention: pixel (i,j) covers [i,i+1)^2,
                # center at (i+0.5, j+0.5)
                px = xs + (sx + 0.5) / ss
                py = ys + (sy + 0.5) / ss
                ones = np.ones_like(px, np.float64)
                pts = np.stack([px, py, ones], -1) @ hinv.T
                tx = pts[..., 0] / pts[..., 2]
                ty = pts[..., 1] / pts[..., 2]
                # Per-module lookup in tag frame (module_image encodes
                # quiet zone, border ring polarity, and data bits at the
                # family's layout coordinates)
                mx = np.floor(tx).astype(int) + off
                my = np.floor(ty).astype(int) + off
                inside = (mx >= 0) & (mx < side) & (my >= 0) & (my < side)
                mod_val = timg[np.clip(my, 0, side - 1),
                               np.clip(mx, 0, side - 1)]
                acc += np.where(inside, mod_val, background)
        img[y0:y1, x0:x1] = acc / (ss * ss)

        border = np.array(
            [[0, 0], [wb, 0], [wb, wb], [0, wb]], np.float64)
        bh = np.concatenate([border, np.ones((4, 1))], 1) @ hmat.T
        placed.append(PlacedTag(tag_id, bh[:, :2] / bh[:, 2:3]))

    if noise_sigma > 0:
        rng = np.random.default_rng(seed)
        img = img + rng.normal(0, noise_sigma, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8), placed


def simple_square_corners(cx: float, cy: float, half: float,
                          angle_deg: float = 0.0) -> np.ndarray:
    """Axis-aligned (or rotated) square corner helper, order tl,tr,br,bl."""
    a = np.deg2rad(angle_deg)
    r = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    base = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64) * half
    return base @ r.T + np.array([cx, cy])


def project_tag_corners(
    pose_r: np.ndarray, pose_t: np.ndarray, tag_size: float,
    fx: float, fy: float, cx: float, cy: float,
    dist: np.ndarray | None = None,
) -> np.ndarray:
    """Project the 4 outer tag corners for a given camera-frame pose.

    Tag frame: corners at (±s/2, ±s/2, 0), order tl(-,-) tr(+,-) br(+,+)
    bl(-,+) matching the apriltag convention where +y is down in the image.
    """
    s = tag_size / 2
    obj = np.array([[-s, -s, 0], [s, -s, 0], [s, s, 0], [-s, s, 0]], np.float64)
    cam = obj @ pose_r.T + pose_t
    x = cam[:, 0] / cam[:, 2]
    y = cam[:, 1] / cam[:, 2]
    if dist is not None and np.any(dist):
        k1, k2, p1, p2, k3 = dist
        r2 = x * x + y * y
        rad = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
        xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x, y = xd, yd
    return np.stack([x * fx + cx, y * fy + cy], -1)

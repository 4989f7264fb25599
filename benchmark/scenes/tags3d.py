"""Scene generator "tags3d": frames of whole tags placed by 3-D pose.

Each tag gets a camera-frame pose: a depth drawn from `distance_m`, a
centre drawn in the frame, a tilt up to `tilt_deg` about an axis in the
tag's plane and any roll. Its corners are projected with the
configuration's intrinsics (the frozen render.project_tag_corners) and
the frame is rendered by the frozen render.render_scene, so the truth
holds ids, corners and poses. Tags, with their white quiet zone and a
margin, never overlap and stay inside the frame.

Every seed gives the same number of tags a frame (the multiset
`tags_per_frame`, in a seeded order) and distinct ids across the pool, so
seeds change where the work lies and not how much of it there is.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.reference.families import get_family
from benchmark.reference.render import project_tag_corners, render_scene

# the whole pattern (quiet zone included) over the black border, 36h11:
# 10 modules over 8
PATTERN_SCALE = 10 / 8


@dataclasses.dataclass
class Truth:
    tag_id: int
    corners: np.ndarray     # (4, 2) px, the outer black border, tl tr br bl
    R: np.ndarray           # (3, 3) tag -> camera
    t: np.ndarray           # (3,) m, the tag's centre in the camera frame


@dataclasses.dataclass
class Pool:
    frames: list            # (H, W) uint8 each
    truth: list             # list of Truth per frame


def _rotation(axis_angle: float, tilt: float, roll: float) -> np.ndarray:
    ax = np.array([np.cos(axis_angle), np.sin(axis_angle), 0.0])
    k = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]],
                  [-ax[1], ax[0], 0]])
    r_tilt = np.eye(3) + np.sin(tilt) * k + (1 - np.cos(tilt)) * (k @ k)
    c, s = np.cos(roll), np.sin(roll)
    r_roll = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    return r_tilt @ r_roll


def _place(rng, cfg: dict, p: dict, boxes: list):
    w, h = cfg["width"], cfg["height"]
    fx, fy, cx, cy = cfg["fx"], cfg["fy"], cfg["cx"], cfg["cy"]
    size = cfg["tag_size"]
    margin = p.get("margin_px", 16)
    dmin, dmax = p["distance_m"]
    for _ in range(1000):
        d = rng.uniform(dmin, dmax)
        u = rng.uniform(0, w)
        v = rng.uniform(0, h)
        t = d * np.array([(u - cx) / fx, (v - cy) / fy, 1.0])
        R = _rotation(rng.uniform(0, 2 * np.pi),
                      np.deg2rad(rng.uniform(0, p["tilt_deg"])),
                      rng.uniform(0, 2 * np.pi))
        corners = project_tag_corners(R, t, size, fx, fy, cx, cy)
        centre = corners.mean(0)
        pattern = centre + (corners - centre) * PATTERN_SCALE
        lo = pattern.min(0) - margin
        hi = pattern.max(0) + margin
        if lo[0] < 0 or lo[1] < 0 or hi[0] > w or hi[1] > h:
            continue
        if any(lo[0] < b[2] and b[0] < hi[0] and lo[1] < b[3]
               and b[1] < hi[1] for b in boxes):
            continue
        boxes.append((lo[0], lo[1], hi[0], hi[1]))
        return corners, R, t
    raise RuntimeError("could not place a tag: the scene parameters leave "
                       "no room")


def make(seed: int, cfg: dict, params: dict) -> Pool:
    """The run's pool of distinct frames from `seed`."""
    rng = np.random.default_rng([seed, 0x7a95])
    counts = list(params["tags_per_frame"])
    rng.shuffle(counts)
    family = get_family(cfg["family"])
    ids = rng.choice(len(family.codes), size=sum(counts), replace=False)
    frames, truth = [], []
    at = 0
    for i, n in enumerate(counts):
        boxes, placed = [], []
        for tag_id in ids[at:at + n]:
            corners, R, t = _place(rng, cfg, params, boxes)
            placed.append(Truth(int(tag_id), corners, R, t))
        at += n
        img, _ = render_scene(
            [q.tag_id for q in placed], [q.corners for q in placed],
            cfg["width"], cfg["height"], family=family,
            background=params.get("background", 180),
            noise_sigma=params["noise_sigma"],
            seed=int(rng.integers(0, 2 ** 63)))
        frames.append(img)
        truth.append(placed)
    return Pool(frames, truth)

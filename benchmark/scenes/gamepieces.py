"""Scene generator "gamepieces": camera frames of orange balls on a grey
field, and the seeded weights of the detector that looks at them.

Each frame is (height, width, 3) uint8 BGR, as a camera hands it over: a
grey field (`background`), `balls_per_frame` shaded orange balls (the
multiset in a seeded order) `diameter_px` across at seeded places, never
overlapping and inside the frame, and Gaussian sensor noise of
`noise_sigma` grey levels. A ball is lit from the upper left (a Lambert
term over an ambient one) and its rim is antialiased by its coverage of
each pixel.

The pool also carries the detector's weights, drawn from the seed by the
frozen reference (benchmark/reference/yolo11.seeded_state_dict) in the
Ultralytics state-dict layout: a run converts them as a team converts its
checkpoint.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.reference import yolo11

# the ball's colour, BGR, fully lit (an FRC game piece's orange)
ORANGE = np.array([20.0, 110.0, 240.0])
LIGHT = np.array([-0.45, -0.55, 0.70])      # towards the light: x, y, z
AMBIENT = 0.35


@dataclasses.dataclass
class Ball:
    cx: float
    cy: float
    r: float


@dataclasses.dataclass
class Pool:
    frames: list            # (H, W, 3) uint8 BGR each
    truth: list             # list of Ball per frame
    state_dict: dict        # the detector's weights, Ultralytics layout


def _place(rng, w: int, h: int, dmin: float, dmax: float,
           balls: list) -> Ball:
    for _ in range(1000):
        r = rng.uniform(dmin, dmax) / 2
        cx = rng.uniform(r + 2, w - r - 2)
        cy = rng.uniform(r + 2, h - r - 2)
        if all((cx - b.cx) ** 2 + (cy - b.cy) ** 2 > (r + b.r + 4) ** 2
               for b in balls):
            return Ball(float(cx), float(cy), float(r))
    raise RuntimeError("could not place a ball: the scene parameters leave "
                       "no room")


def _draw(img: np.ndarray, b: Ball) -> None:
    """Shade ball `b` into the float image, in its bounding box."""
    h, w = img.shape[:2]
    x0, x1 = max(0, int(b.cx - b.r) - 1), min(w, int(b.cx + b.r) + 2)
    y0, y1 = max(0, int(b.cy - b.r) - 1), min(h, int(b.cy + b.r) + 2)
    yy, xx = np.mgrid[y0:y1, x0:x1]
    dx = (xx + 0.5 - b.cx) / b.r
    dy = (yy + 0.5 - b.cy) / b.r
    d = np.sqrt(dx * dx + dy * dy)
    cover = np.clip((1.0 - d) * b.r + 0.5, 0.0, 1.0)[..., None]
    dz = np.sqrt(np.clip(1.0 - d * d, 0.0, 1.0))
    light = LIGHT / np.linalg.norm(LIGHT)
    lam = np.clip(dx * light[0] + dy * light[1] + dz * light[2], 0.0, 1.0)
    shade = (AMBIENT + (1.0 - AMBIENT) * lam)[..., None] * ORANGE
    img[y0:y1, x0:x1] = img[y0:y1, x0:x1] * (1.0 - cover) + shade * cover


def make(seed: int, cfg: dict, params: dict) -> Pool:
    """The run's pool of distinct frames and the detector's weights from
    `seed`."""
    rng = np.random.default_rng([seed, 0x6a11])
    w, h = cfg["width"], cfg["height"]
    counts = list(params["balls_per_frame"])
    rng.shuffle(counts)
    dmin, dmax = params["diameter_px"]
    frames, truth = [], []
    for n in counts:
        balls = []
        for _ in range(n):
            balls.append(_place(rng, w, h, dmin, dmax, balls))
        img = np.full((h, w, 3), float(params.get("background", 150)))
        for b in balls:
            _draw(img, b)
        img += rng.normal(0.0, params["noise_sigma"], img.shape)
        frames.append(np.clip(np.rint(img), 0, 255).astype(np.uint8))
        truth.append(balls)
    state = yolo11.seeded_state_dict(seed, cfg["num_classes"], cfg["scale"])
    return Pool(frames, truth, state)

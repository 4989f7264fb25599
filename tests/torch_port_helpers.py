"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

Every input is made with numpy (from a seed or render_scene) and handed to
both the JAX package and the port as numpy arrays. Torch runs one CPU
thread: the tier-1 suite already runs several pytest workers.
"""
import numpy as np
import torch

from ros_vision_tpu.apriltag.render import render_scene, simple_square_corners

torch.set_num_threads(1)

BENCH_IDS = [0, 42, 311, 100]


def bench_layout(scale: float, angles=(0, 20, -35, 50)):
    """The bench.py 4-tag layout (1280x800 coordinates) scaled by `scale`."""
    s = scale
    return [simple_square_corners(300 * s, 250 * s, 90 * s, angle_deg=angles[0]),
            simple_square_corners(800 * s, 400 * s, 110 * s,
                                  angle_deg=angles[1]),
            simple_square_corners(450 * s, 600 * s, 70 * s,
                                  angle_deg=angles[2]),
            simple_square_corners(1000 * s, 600 * s, 60 * s,
                                  angle_deg=angles[3])]


def bench_frames(width: int, height: int, seeds, noise_sigma=1.0,
                 angles=(0, 20, -35, 50)):
    """(B, H, W) uint8 bench scenes, one noise seed per row, and the
    rendered (placed) tags of the first row."""
    scale = width / 1280
    rows = [render_scene(BENCH_IDS, bench_layout(scale, angles), width,
                         height, noise_sigma=noise_sigma, seed=s)
            for s in seeds]
    return np.stack([img for img, _ in rows]), rows[0][1]


def small_scene(seed: int = 0, noise_sigma: float = 2.0):
    """(1, 128, 256) uint8 gray frame with two tags (the scene of
    tests/test_frontend_pallas.py)."""
    img, _ = render_scene(
        [0, 42], [simple_square_corners(60, 60, 40),
                  simple_square_corners(180, 70, 45, angle_deg=25)],
        256, 128, noise_sigma=noise_sigma, seed=seed)
    return img[None]


def checkerboard(h: int, w: int, block: int, flip: float, seed: int):
    """(1, H, W) uint8 black/white block checkerboard with a fraction
    `flip` of its blocks inverted, plus mild noise: many separate black
    blobs and boundary everywhere (overflows ranks and boundary caps)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h // block + 1, :w // block + 1]
    blocks = ((yy + xx) % 2) ^ (rng.random(yy.shape) < flip)
    img = np.kron(blocks * 200 + 20, np.ones((block, block)))[:h, :w]
    img = img + rng.normal(0, 2.0, img.shape)
    return img.clip(0, 255).astype(np.uint8)[None]


def random_threshim(b: int, h: int, w: int, seed: int, p127: float = 0.1):
    """(B, H, W) uint8 {0, 127, 255} image of smooth random blobs."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((b, h // 4 + 1, w // 4 + 1))
    field = np.kron(coarse, np.ones((4, 4)))[:, :h, :w]
    field = field + 0.15 * rng.random((b, h, w))
    out = np.where(field > 0.55, 255, 0).astype(np.uint8)
    out[rng.random((b, h, w)) < p127] = 127
    return out


def t(x) -> torch.Tensor:
    """numpy / JAX array -> CPU torch tensor."""
    return torch.from_numpy(np.array(x))


def n(x) -> np.ndarray:
    """torch tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)

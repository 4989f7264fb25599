"""Device-side frame preprocessing: debayer + precomputed undistort/rectify.

The port of ros_vision_tpu/ops/rectify.py (BASELINE config 2). The
undistort map, one (H, W, 2) float32 source-coordinate field per camera
(the cv2.initUndistortRectifyMap equivalent), is built once on the host
from the camera intrinsics; per frame the device does a bilinear gather
remap. Debayer turns RGGB/BGGR/GRBG/GBRG 2x2 mosaics into gray (or RGB)
with bilinear channel interpolation, for cameras that deliver the raw
mosaic.

Everything here is plain torch elementwise work and gathers; the JAX
module reaches no Pallas kernel either.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ros_vision_tpu_torch.apriltag import geometry as geo
from ros_vision_tpu_torch.device import require_cuda


def build_undistort_map(width: int, height: int, fx: float, fy: float,
                        cx: float, cy: float, dist,
                        new_intrinsics=None) -> np.ndarray:
    """(H, W, 2) float32 map: for each RECTIFIED pixel, the source pixel in
    the distorted image (initUndistortRectifyMap semantics: forward-distort
    the ideal ray of each output pixel)."""
    nfx, nfy, ncx, ncy = new_intrinsics or (fx, fy, cx, cy)
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    # ideal (rectified) pixel -> normalized ray under the NEW intrinsics,
    # then distort under the ORIGINAL model
    pts = np.stack([(xs + 0.5 - ncx) / nfx * fx + cx,
                    (ys + 0.5 - ncy) / nfy * fy + cy], -1)
    src = geo.distort_points(pts.reshape(-1, 2), fx, fy, cx, cy,
                             np.asarray(dist, np.float64))
    return src.reshape(height, width, 2).astype(np.float32)


def remap_bilinear(img: torch.Tensor, smap: torch.Tensor) -> torch.Tensor:
    """img (B, H, W) uint8/float; smap (H, W, 2) float32 source coords
    (pixel centers at +0.5, matching the detector's convention), on the
    same device. Out-of-bounds samples clamp to the edge
    (cv2.BORDER_REPLICATE behavior)."""
    b, h, w = img.shape
    x = smap[..., 0] - 0.5
    y = smap[..., 1] - 0.5
    x0 = torch.floor(x).to(torch.int32).clamp(0, w - 2)
    y0 = torch.floor(y).to(torch.int32).clamp(0, h - 2)
    fx = (x - x0).clamp(0.0, 1.0)
    fy = (y - y0).clamp(0.0, 1.0)
    flat = img.reshape(b, -1).to(torch.float32)
    base = (y0 * w + x0).reshape(-1).to(torch.int64)

    def at(offset: int):
        return flat.index_select(1, base + offset).reshape(b, h, w)

    out = (at(0) * (1 - fx) * (1 - fy) + at(1) * fx * (1 - fy)
           + at(w) * (1 - fx) * fy + at(w + 1) * fx * fy)
    return (out + 0.5).clamp(0, 255).to(img.dtype)


_BAYER_OFFSETS = {
    # pattern -> (row, col) of the R sample within each 2x2 cell
    "RGGB": (0, 0), "GRBG": (0, 1), "GBRG": (1, 0), "BGGR": (1, 1),
}
_KERN = ((0.25, 0.5, 0.25), (0.5, 1.0, 0.5), (0.25, 0.5, 0.25))


def _window_sum(x: torch.Tensor) -> torch.Tensor:
    """The 3x3 window of _KERN over the last two axes with zero padding
    ("SAME"), as nine shifted adds. Every term is an integer <= 255 times
    1/4, 1/2 or 1, so f32 sums them exactly in any order; a cuDNN conv
    would round its inputs to TF32 on the card."""
    h, w = x.shape[-2:]
    p = F.pad(x, (1, 1, 1, 1))
    out = None
    for dy in range(3):
        for dx in range(3):
            term = p[..., dy:dy + h, dx:dx + w] * _KERN[dy][dx]
            out = term if out is None else out + term
    return out


def debayer(mosaic: torch.Tensor, pattern: str = "RGGB",
            to_gray: bool = True) -> torch.Tensor:
    """mosaic (B, H, W) uint8 -> gray (B, H, W) or rgb (B, H, W, 3) uint8.

    Bilinear demosaic: each channel's samples (the mosaic times the
    channel's mask), summed over a 3x3 window and divided by the mask's
    window sum."""
    if pattern not in _BAYER_OFFSETS:
        raise ValueError(f"unknown bayer pattern {pattern!r}")
    _, h, w = mosaic.shape
    m = mosaic.to(torch.float32)
    ys = torch.arange(h, device=m.device) % 2
    xs = torch.arange(w, device=m.device) % 2
    ry, rx = _BAYER_OFFSETS[pattern]
    r_mask = ((ys == ry)[:, None] & (xs == rx)[None, :]).to(torch.float32)
    b_mask = ((ys == 1 - ry)[:, None]
              & (xs == 1 - rx)[None, :]).to(torch.float32)
    g_mask = 1.0 - r_mask - b_mask
    masks = torch.stack([r_mask, g_mask, b_mask])            # (3, H, W)
    num = _window_sum(m[:, None] * masks)                    # (B, 3, H, W)
    den = _window_sum(masks)                                 # (3, H, W)
    r, g, bl = (num / den.clamp_min(1e-6)).unbind(1)
    if to_gray:
        # ITU-R BT.601 luma
        gray = 0.299 * r + 0.587 * g + 0.114 * bl
        return (gray + 0.5).clamp(0, 255).to(torch.uint8)
    rgb = torch.stack([r, g, bl], -1)
    return (rgb + 0.5).clamp(0, 255).to(torch.uint8)


class Rectifier:
    """Per-camera preprocessing: (optional debayer) + precomputed remap.
    Compose in front of the detector for lenses whose distortion exceeds
    what the detector's undistortion-aware refine absorbs. The map lives
    on `device` (the first CUDA card when None; the CPU only on request),
    built once."""

    def __init__(self, width, height, fx, fy, cx, cy, dist,
                 bayer_pattern: str | None = None, device=None):
        self.device = (require_cuda() if device is None
                       else torch.device(device))
        self.map = torch.from_numpy(build_undistort_map(
            width, height, fx, fy, cx, cy, dist)).to(self.device)
        self.bayer_pattern = bayer_pattern

    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        if self.bayer_pattern:
            frames = debayer(frames, self.bayer_pattern, to_gray=True)
        return remap_bilinear(frames, self.map)

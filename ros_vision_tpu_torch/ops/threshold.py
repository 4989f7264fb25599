"""Grayscale decimation + tile-based adaptive threshold (plain PyTorch).

Counterpart of ros_vision_tpu/ops/threshold.py (the reference's
threshold.cu:151-201 chain): gray/decimate, 4x4 tile min/max, 3x3
edge-clamped min/max dilation and the {0, 127, 255} threshold rule, in
integer arithmetic. Batch-first (B, H, W) uint8; H and W multiples of 8 at
full resolution. The hand-written kernel for the whole stage is
ops/threshold_kernel.py.
"""
from __future__ import annotations

import torch


def yuyv_to_gray(yuyv: torch.Tensor) -> torch.Tensor:
    """YUYV422 frames (B, H, W*2) uint8 -> gray (B, H, W): every other
    byte (threshold.cu:21)."""
    return yuyv[..., ::2].contiguous()


def decimate2(gray: torch.Tensor) -> torch.Tensor:
    """2x decimation by point sampling even rows/cols (threshold.cu:27-31)."""
    return gray[..., ::2, ::2].contiguous()


def tile_minmax(decim: torch.Tensor):
    """Per-4x4-tile min and max: (B, H2, W2) -> two (B, H2/4, W2/4)."""
    b, h, w = decim.shape
    t = decim.reshape(b, h // 4, 4, w // 4, 4)
    return t.amin(dim=(2, 4)), t.amax(dim=(2, 4))


def dilate_minmax(tmin: torch.Tensor, tmax: torch.Tensor):
    """3x3 min/max dilation with border clamping (out-of-bounds neighbours
    are skipped, which equals edge-replicated padding for min/max)."""
    _, th, tw = tmin.shape
    dev = tmin.device
    ys = torch.arange(th, device=dev)
    xs = torch.arange(tw, device=dev)
    fmin, fmax = tmin, tmax
    for dy in (-1, 0, 1):
        yi = (ys + dy).clamp(0, th - 1)
        for dx in (-1, 0, 1):
            xi = (xs + dx).clamp(0, tw - 1)
            fmin = torch.minimum(fmin, tmin[:, yi][:, :, xi])
            fmax = torch.maximum(fmax, tmax[:, yi][:, :, xi])
    return fmin, fmax


def threshold(decim: torch.Tensor, fmin: torch.Tensor, fmax: torch.Tensor,
              min_white_black_diff: int = 5) -> torch.Tensor:
    """Adaptive threshold to {0, 127, 255} (InternalThreshold,
    threshold.cu:121-147)."""
    pmin = fmin.repeat_interleave(4, dim=1).repeat_interleave(4, dim=2)
    pmax = fmax.repeat_interleave(4, dim=1).repeat_interleave(4, dim=2)
    pmin = pmin.to(torch.int32)
    spread = pmax.to(torch.int32) - pmin
    thresh = pmin + torch.div(spread, 2, rounding_mode="floor")
    out = torch.where(decim.to(torch.int32) > thresh, 255, 0)
    out = torch.where(spread < min_white_black_diff, 127, out)
    return out.to(torch.uint8)


def adaptive_threshold(decim: torch.Tensor, min_white_black_diff: int = 5):
    """Full stage: decimated gray -> (threshim, (tmin, tmax, fmin, fmax))."""
    tmin, tmax = tile_minmax(decim)
    fmin, fmax = dilate_minmax(tmin, tmax)
    return threshold(decim, fmin, fmax, min_white_black_diff), \
        (tmin, tmax, fmin, fmax)

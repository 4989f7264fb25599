"""K1: the fused threshold stage, gray -> (decim, threshim).

Replaces ros_vision_tpu/ops/threshold_pallas.py adaptive_threshold_fused.
A CUDA tensor launches csrc/threshold.cu; a CPU tensor runs the plain
PyTorch chain of ops/threshold.py. Bit-exact either way.
"""
from __future__ import annotations

import torch

from ros_vision_tpu_torch import _build
from ros_vision_tpu_torch.device import kernel_route
from ros_vision_tpu_torch.ops import threshold as thr

MIN_WHITE_BLACK_DIFF = 5

launches = _build.counter("adaptive_threshold")


def adaptive_threshold_plain(gray: torch.Tensor,
                             min_white_black_diff: int = MIN_WHITE_BLACK_DIFF):
    """Plain PyTorch version (any device)."""
    decim = thr.decimate2(gray)
    return decim, thr.adaptive_threshold(decim, min_white_black_diff)[0]


def adaptive_threshold_cuda(gray: torch.Tensor,
                            min_white_black_diff: int = MIN_WHITE_BLACK_DIFF):
    """Launch csrc/threshold.cu on a CUDA tensor."""
    b, h, w = gray.shape
    if h % 8 or w % 8:
        raise ValueError(f"frame {h}x{w}: height and width must be "
                         "multiples of 8")
    dev = gray.device
    _build.check_tensor(gray, "gray", torch.uint8, (b, h, w), dev)
    decim = torch.empty((b, h // 2, w // 2), dtype=torch.uint8, device=dev)
    threshim = torch.empty_like(decim)
    tmin = torch.empty((b, h // 8, w // 8), dtype=torch.uint8, device=dev)
    tmax = torch.empty_like(tmin)
    _build.launch("rvt_adaptive_threshold", dev, gray, decim, threshim,
                  tmin, tmax, b, h, w, min_white_black_diff)
    launches.count += 1
    return decim, threshim


def adaptive_threshold_fused(gray: torch.Tensor,
                             min_white_black_diff: int = MIN_WHITE_BLACK_DIFF):
    """(B, H, W) uint8 -> (decim (B,H/2,W/2), threshim (B,H/2,W/2))."""
    if kernel_route(gray) == "cpu":
        return adaptive_threshold_plain(gray, min_white_black_diff)
    return adaptive_threshold_cuda(gray, min_white_black_diff)

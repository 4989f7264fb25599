"""K1: the fused threshold stage, gray -> (decim, threshim).

Replaces ros_vision_tpu/ops/threshold_pallas.py adaptive_threshold_fused.
A CUDA tensor launches csrc/threshold.cu; a CPU tensor runs the plain
PyTorch chain of ops/threshold.py. Bit-exact either way.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ros_vision_tpu_torch import _build
from ros_vision_tpu_torch.device import kernel_route
from ros_vision_tpu_torch.ops import threshold as thr

MIN_WHITE_BLACK_DIFF = 5
LAUNCHES = 1               # device launches per K1 call (csrc/threshold.cu)
THRESHOLD_THREADS = 256
SMEM_DEFAULT = 48 * 1024   # a block's shared memory without opting in
MAX_GRID_Y = 65535

launches = _build.counter("adaptive_threshold")


def adaptive_threshold_plain(gray: torch.Tensor,
                             min_white_black_diff: int = MIN_WHITE_BLACK_DIFF):
    """Plain PyTorch version (any device)."""
    decim = thr.decimate2(gray)
    return decim, thr.adaptive_threshold(decim, min_white_black_diff)[0]


@dataclass(frozen=True)
class ThresholdPlan:
    """How csrc/threshold.cu cuts a (B, H, W) batch: grid (bands, B), one
    block a band of `band` tile rows (a tile is 8x8 full-res pixels)."""
    band: int
    bands: int
    threads: int
    smem_bytes: int

    def args(self) -> tuple:
        """The launcher's plan arguments, in their order."""
        return self.band, self.bands, self.threads, self.smem_bytes


def threshold_smem(band: int, tw: int) -> int:
    """Shared bytes of a band (csrc/threshold.cu smem_need): the tile
    min/max of band + 2 rows of tw + 2 tiles, 16-byte aligned, then one
    word per tile and decimated row of the band."""
    return -(-2 * (band + 2) * (tw + 2) // 16) * 16 + 16 * band * tw


def threshold_plan(b: int, h: int, w: int, sms: int) -> ThresholdPlan:
    """Bands of floor(th * B / sms) tile rows (at least 1), so that a batch
    gives each of the card's `sms` SMs at least one block where it has
    that many tile rows, and no more than 48 KB of shared memory a block.
    256 threads a block."""
    if h < 8 or w < 8 or h % 8 or w % 8:
        raise ValueError(f"frame {h}x{w}: height and width must be "
                         "nonzero multiples of 8")
    if not 1 <= b <= MAX_GRID_Y:
        raise ValueError(f"batch of {b} frames (1 to {MAX_GRID_Y})")
    th, tw = h // 8, w // 8
    band = max(1, min(th, th * b // max(sms, 1)))
    while band > 1 and threshold_smem(band, tw) > SMEM_DEFAULT:
        band -= 1
    smem = threshold_smem(band, tw)
    if smem > SMEM_DEFAULT:
        raise ValueError(f"frame width {w}: one tile row needs {smem} "
                         f"bytes of shared memory, more than "
                         f"{SMEM_DEFAULT}")
    return ThresholdPlan(band=band, bands=-(-th // band),
                         threads=THRESHOLD_THREADS, smem_bytes=smem)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def adaptive_threshold_cuda(gray: torch.Tensor,
                            min_white_black_diff: int = MIN_WHITE_BLACK_DIFF):
    """Launch csrc/threshold.cu on a CUDA tensor."""
    b, h, w = gray.shape
    dev = gray.device
    _build.check_tensor(gray, "gray", torch.uint8, (b, h, w), dev)
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    plan = threshold_plan(b, h, w, _sm_count(index))
    decim = torch.empty((b, h // 2, w // 2), dtype=torch.uint8, device=dev)
    threshim = torch.empty_like(decim)
    made = ctypes.c_int(0)
    _build.launch("rvt_adaptive_threshold", dev, gray, decim, threshim,
                  ctypes.addressof(made), b, h, w, min_white_black_diff,
                  *plan.args())
    launches.add(made.value)
    return decim, threshim


def adaptive_threshold_fused(gray: torch.Tensor,
                             min_white_black_diff: int = MIN_WHITE_BLACK_DIFF):
    """(B, H, W) uint8 -> (decim (B,H/2,W/2), threshim (B,H/2,W/2))."""
    if kernel_route(gray) == "cpu":
        return adaptive_threshold_plain(gray, min_white_black_diff)
    return adaptive_threshold_cuda(gray, min_white_black_diff)

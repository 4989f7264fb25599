"""Blocked f32 prefix sums (plain PyTorch).

Counterpart of ros_vision_tpu/ops/scan.py. The port keeps the same block
structure (512 for cumsum_mxu, 128 for blocked_cumsum_parts, 128+40 for
overlapped_cumsum) in f32, so each in-block prefix is a sum over at most
one block's content — the f32 conditioning property
tests/test_numeric_envelopes.py pins for giant segments. Integer-valued
data below 2^24 is exact.

The JAX package formed the in-block prefix as a matmul against a
lower-triangular ones matrix on the MXU. A matmul's summation order is the
library's choice and differs between the CPU and the card, and the
windowed line-fit errors of cluster_and_fit amplify last-bit prefix
differences ~1e5 times (prefix cancellation) — enough to flip corner peaks
on a saturated frame. The port therefore scans with a fixed association
(log-step Hillis-Steele adds, one elementwise f32 add per step), which
gives bit-identical prefixes on every device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_BLK = 512


def _inblock_prefix(xb: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix along the last (block) axis, fixed association."""
    n = xb.shape[-1]
    s = 1
    while s < n:
        xb = xb + F.pad(xb[..., :-s], (s, 0))
        s *= 2
    return xb


def _exclusive_prefix(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix along the last axis, fixed association."""
    return F.pad(_inblock_prefix(x)[..., :-1], (1, 0))


def cumsum_mxu(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inclusive f32 cumsum along `axis`, blocked by 512."""
    if axis not in (-1, x.ndim - 1):
        x = torch.movedim(x, axis, -1)
    orig_shape = x.shape
    n = x.shape[-1]
    blk = _BLK if n >= _BLK else max(128, 1 << (n - 1).bit_length())
    pad = (-n) % blk
    x = x.to(torch.float32)
    if pad:
        x = F.pad(x, (0, pad))
    nb = x.shape[-1] // blk
    xb = x.reshape(x.shape[:-1] + (nb, blk))
    inblock = _inblock_prefix(xb)
    offs = _exclusive_prefix(inblock[..., -1])         # block offsets
    out = (inblock + offs[..., None]).reshape(x.shape)
    if pad:
        out = out[..., :n]
    out = out.reshape(orig_shape)
    if axis not in (-1, len(orig_shape) - 1):
        out = torch.movedim(out, -1, axis)
    return out


def blocked_cumsum_parts(data: torch.Tensor, blk: int = 128):
    """Blocked prefix-sum parts along axis 1 of (B, K, C): (local, totals,
    blk) with local the block-inclusive prefix (resets every `blk`
    elements) and totals (B, NB, C) the per-block sums."""
    b, k, c = data.shape
    if k < blk:
        blk = max(8, 1 << (k - 1).bit_length())
    pad = (-k) % blk
    dm = torch.movedim(data, -1, 1).to(torch.float32)        # (B, C, K)
    if pad:
        dm = F.pad(dm, (0, pad))
    nb = dm.shape[-1] // blk
    xb = dm.reshape(b, c, nb, blk)
    inblock = _inblock_prefix(xb)
    totals = inblock[..., -1]                                # (B, C, NB)
    local = torch.movedim(inblock.reshape(b, c, nb * blk)[..., :k], 1, -1)
    return local, torch.movedim(totals, 1, -1), blk


def overlapped_cumsum(data: torch.Tensor, blk: int = 128, ov: int = 40):
    """Overlapped-block inclusive prefix along axis 1 of (B, K, C):
    (opref, blk, ov) with opref (B, NB*(blk+ov), C); block j's row covers
    global elements [j*blk - ov, (j+1)*blk) and restarts its prefix at
    j*blk - ov (zeros before element 0)."""
    b, k, c = data.shape
    if k < blk:
        blk = max(8, 1 << (k - 1).bit_length())
    pad = (-k) % blk
    dm = torch.movedim(data, -1, 1).to(torch.float32)        # (B, C, K)
    if pad:
        dm = F.pad(dm, (0, pad))
    nb = dm.shape[-1] // blk
    xb = dm.reshape(b, c, nb, blk)
    prev_tail = F.pad(xb[:, :, :-1, blk - ov:], (0, 0, 1, 0))
    obk = torch.cat([prev_tail, xb], dim=-1)                 # (B,C,NB,blk+ov)
    opref = _inblock_prefix(obk)
    opref = torch.movedim(opref.reshape(b, c, nb * (blk + ov)), 1, -1)
    return opref, blk, ov


def segmented_cumsum_from_starts(data: torch.Tensor,
                                 start_idx: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented cumsum along axis 1 of (B, K[, C]) given each
    element's segment start index (B, K): cum[i] - cum[start(i) - 1]."""
    if data.ndim == 3:
        cum = torch.movedim(cumsum_mxu(torch.movedim(data, -1, 1)), 1, -1)
        idx = (start_idx - 1).clamp_min(0)[..., None].expand(-1, -1,
                                                             data.shape[2])
        base = torch.gather(cum, 1, idx)
        base = torch.where((start_idx - 1 >= 0)[..., None], base, 0.0)
        return cum - base
    cum = cumsum_mxu(data)
    base = torch.gather(cum, 1, (start_idx - 1).clamp_min(0))
    base = torch.where(start_idx - 1 >= 0, base, 0.0)
    return cum - base

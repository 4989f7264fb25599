"""Fixed-shape segment utilities (plain PyTorch).

Counterpart of ros_vision_tpu/ops/segments.py: masked stream compaction,
uniform thinning to a capacity, segment ids from sorted keys, segmented
scans and batched gathers. compact_route and compact_monotone are TPU
formulations of compact with bit-identical results and are not ported.
"""
from __future__ import annotations

import torch

from ros_vision_tpu_torch.ops.scan import cumsum_mxu


def compact(valid: torch.Tensor, payload: dict, k: int, fill: dict):
    """Keep the first K valid elements in order: (dict of (B, K), counts).

    valid (B, M) bool; payload dict of (B, M) tensors; fill per key."""
    b, m = valid.shape
    counts = valid.sum(dim=1).clamp_max(k).to(torch.int32)
    order = torch.sort((~valid).to(torch.int32), dim=1, stable=True)[1]
    slot_ok = (torch.arange(k, device=valid.device)[None, :]
               < counts[:, None])
    out = {}
    for kk, arr in payload.items():
        arr = torch.gather(arr, 1, order)[:, :k]
        if m < k:
            arr = torch.nn.functional.pad(arr, (0, k - m), value=fill[kk])
        out[kk] = torch.where(slot_ok, arr, fill[kk])
    return out, counts


def thin_uniform(valid: torch.Tensor, k: int):
    """Uniform stream thinning to capacity k: (keep, slot2). keep selects
    <= k-2 valid elements spread evenly over the valid stream; slot2 is a
    kept element's compacted slot. Closed-form f32 rule, identical to the
    JAX package and to csrc/boundary.cu: with slot = exclusive count of
    valid and r = min(1, (k-2)/max(T, 1)), keep iff floor((slot+1) r) >
    floor(slot r), landing at floor(slot r).

    The ratio is an IEEE f32 division of two tensors on purpose: Python's
    `scalar / tensor` goes through Tensor.__rtruediv__, which multiplies
    by a rounded reciprocal — one extra rounding that changes which
    points survive on overflowing frames."""
    cnt = cumsum_mxu(valid.to(torch.float32))
    total = cnt[:, -1:]
    num = torch.full_like(total, float(k - 2))
    r = torch.clamp_max(torch.div(num, torch.clamp_min(total, 1.0)), 1.0)
    slot = cnt - 1.0
    t_next = torch.floor((slot + 1.0) * r)
    t_here = torch.floor(slot * r)
    keep = valid & (t_next > t_here)
    return keep, t_here.to(torch.int32)


def segment_ids_from_sorted_keys(*keys: torch.Tensor, valid: torch.Tensor,
                                 max_segments: int) -> torch.Tensor:
    """Segment ids (B, K) int32 in [0, max_segments] for a key-sorted
    array; max_segments is the overflow/invalid bucket."""
    change = torch.zeros_like(valid)
    change[:, 0] = True
    for kk in keys:
        change = change | torch.cat(
            [torch.ones_like(kk[:, :1], dtype=torch.bool),
             kk[:, 1:] != kk[:, :-1]], dim=1)
    change = change & valid
    seg = cumsum_mxu(change.to(torch.float32)).to(torch.int32) - 1
    return torch.where(valid & (seg < max_segments), seg,
                       max_segments).to(torch.int32)


def segmented_cumsum(data: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented cumsum along axis 1; starts (B, K) bool marks
    each segment's first element (log-step scan with reset flags)."""
    flags = starts.to(data.dtype)
    if data.ndim == 3:
        flags = flags[..., None].expand(data.shape)
    v, f = data, flags
    k = data.shape[1]
    s = 1
    while s < k:
        pv = torch.nn.functional.pad(v[:, :-s], (0, 0, s, 0)
                                     if v.ndim == 3 else (s, 0))
        pf = torch.nn.functional.pad(f[:, :-s], (0, 0, s, 0)
                                     if f.ndim == 3 else (s, 0))
        v = pv * (1 - f) + v
        f = torch.maximum(pf, f)
        s *= 2
    return v


def take1(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather along axis 1: arr (B, K[, C]), idx (B, K') ->
    (B, K'[, C]). Callers clip idx into range, as torch.gather does not
    clamp (it raises on the CPU and is undefined on CUDA)."""
    idx = idx.to(torch.int64)
    if arr.ndim == 3:
        return torch.gather(arr, 1, idx[..., None].expand(-1, -1,
                                                          arr.shape[2]))
    return torch.gather(arr, 1, idx)

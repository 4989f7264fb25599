"""K4 value histogram and K12 rank gather.

K4, out[b, s] = #(values[b] == s), replaces
ros_vision_tpu/ops/gather_pallas.py value_histogram (the per-segment
counts of cluster_and_fit); values outside [0, num_values) are not
counted. K12, out[b, i] = rank_v[b, labels[b, i]] (0 for a label outside
[0, N)), replaces gather_pallas.py rank_gather (the rank broadcast of
ccl.flood_ranks). A CUDA tensor launches csrc/histogram.cu /
csrc/gather.cu; a CPU tensor runs the plain version. Bit-exact either
way.
"""
from __future__ import annotations

import torch

from ros_vision_tpu_torch import _build
from ros_vision_tpu_torch.device import kernel_route

launches = _build.counter("value_histogram")
rank_gather_launches = _build.counter("rank_gather")


def value_histogram_plain(values: torch.Tensor,
                          num_values: int) -> torch.Tensor:
    """Plain PyTorch version (any device): (B, K) -> (B, num_values)."""
    b, _ = values.shape
    inside = (values >= 0) & (values < num_values)
    idx = torch.where(inside, values, num_values).to(torch.int64)
    out = torch.zeros((b, num_values + 1), dtype=torch.int32,
                      device=values.device)
    out.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
    return out[:, :num_values]


def value_histogram_cuda(values: torch.Tensor,
                         num_values: int) -> torch.Tensor:
    """Launch csrc/histogram.cu on a CUDA (B, K) int32 tensor."""
    b, k = values.shape
    dev = values.device
    _build.check_tensor(values, "values", torch.int32, (b, k), dev)
    out = torch.empty((b, num_values), dtype=torch.int32, device=dev)
    _build.launch("rvt_value_histogram", dev, values, out, b, k, num_values)
    launches.count += 1
    return out


def histogram(values: torch.Tensor, num_values: int) -> torch.Tensor:
    """(B, K) int32 -> (B, num_values) int32 counts; kernel on CUDA,
    plain version on the CPU."""
    if kernel_route(values) == "cpu":
        return value_histogram_plain(values, num_values)
    return value_histogram_cuda(values.contiguous(), num_values)


def rank_gather_plain(labels: torch.Tensor,
                      rank_v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (any device): (B, N) labels, (B, N) table ->
    (B, N) rank_v[labels], 0 where a label lies outside [0, N)."""
    n = labels.shape[1]
    inside = (labels >= 0) & (labels < n)
    got = torch.gather(rank_v, 1, torch.where(inside, labels, 0).to(
        torch.int64))
    return torch.where(inside, got, 0)


def _rank_gather_cuda(labels: torch.Tensor,
                      rank_v: torch.Tensor) -> torch.Tensor:
    b, n = labels.shape
    dev = labels.device
    _build.check_tensor(labels, "labels", torch.int32, (b, n), dev)
    _build.check_tensor(rank_v, "rank_v", torch.int32, (b, n), dev)
    out = torch.empty((b, n), dtype=torch.int32, device=dev)
    _build.launch("rvt_rank_gather", dev, labels, rank_v, out, b, n)
    rank_gather_launches.count += 1
    return out


def rank_gather(labels: torch.Tensor, rank_v: torch.Tensor) -> torch.Tensor:
    """(B, N) int32 labels + (B, N) int32 table -> (B, N) int32
    rank_v[labels] (0 outside [0, N)); kernel on CUDA, plain version on
    the CPU."""
    if kernel_route(labels) == "cpu":
        return rank_gather_plain(labels, rank_v)
    return _rank_gather_cuda(labels.contiguous(), rank_v.contiguous())

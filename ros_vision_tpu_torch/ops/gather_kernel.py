"""K4: value histogram, out[b, s] = #(values[b] == s).

Replaces ros_vision_tpu/ops/gather_pallas.py value_histogram (the
per-segment counts of cluster_and_fit). A CUDA tensor launches
csrc/histogram.cu; a CPU tensor runs the plain scatter-add. Values
outside [0, num_values) are not counted. Bit-exact either way.
"""
from __future__ import annotations

import torch

from ros_vision_tpu_torch import _build
from ros_vision_tpu_torch.device import kernel_route

launches = _build.counter("value_histogram")


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

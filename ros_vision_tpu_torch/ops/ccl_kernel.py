"""K6 (propagate_fixpoint), K7 (label_histogram) and K8 (propagate): the
flood CCL's kernels.

Replace ros_vision_tpu/ops/ccl_pallas.py propagate_fixpoint,
label_histogram and propagate. A CUDA tensor launches csrc/flood.cu; a
CPU tensor runs the plain versions of ops/ccl.py. Outputs are bit-identical
either way.
"""
from __future__ import annotations

import torch

from ros_vision_tpu_torch import _build
from ros_vision_tpu_torch.device import kernel_route
from ros_vision_tpu_torch.ops import ccl

fixpoint_launches = _build.counter("propagate_fixpoint")
histogram_launches = _build.counter("label_histogram")
propagate_launches = _build.counter("propagate")


def _propagate_fixpoint_cuda(threshim: torch.Tensor,
                             values: torch.Tensor) -> torch.Tensor:
    b, h, w = threshim.shape
    dev = threshim.device
    _build.check_tensor(threshim, "threshim", torch.uint8, (b, h, w), dev)
    _build.check_tensor(values, "values", torch.int32, (b, h, w), dev)
    i32 = dict(dtype=torch.int32, device=dev)
    labels = torch.empty((b, h * w), **i32)
    rootmin = torch.empty((b, h * w), **i32)
    out = torch.empty((b, h, w), **i32)
    _build.launch("rvt_propagate_fixpoint", dev, threshim, values, labels,
                  rootmin, out, b, h, w)
    fixpoint_launches.count += 1
    return out


def propagate_fixpoint(threshim: torch.Tensor,
                       values: torch.Tensor) -> torch.Tensor:
    """(B, H, W) uint8 threshold + (B, H, W) int32 values -> (B, H, W)
    int32: min(the minimum of `values` over each pixel's component, 2^30)."""
    if kernel_route(threshim) == "cpu":
        return ccl.propagate_fixpoint(threshim, values)
    return _propagate_fixpoint_cuda(threshim.contiguous(),
                                    values.contiguous())


def _label_histogram_cuda(labels_flat: torch.Tensor) -> torch.Tensor:
    b, n = labels_flat.shape
    dev = labels_flat.device
    _build.check_tensor(labels_flat, "labels_flat", torch.int32, (b, n), dev)
    counts = torch.empty((b, n), dtype=torch.int32, device=dev)
    _build.launch("rvt_label_histogram", dev, labels_flat, counts, b, n)
    histogram_launches.count += 1
    return counts


def label_histogram(labels_flat: torch.Tensor) -> torch.Tensor:
    """(B, N) int32 -> (B, N) int32 counts over the label space [0, N);
    labels outside it are not counted."""
    if kernel_route(labels_flat) == "cpu":
        return ccl.label_histogram(labels_flat)
    return _label_histogram_cuda(labels_flat.contiguous())


def _propagate_cuda(threshim: torch.Tensor, labels: torch.Tensor,
                    n_sweeps: int) -> torch.Tensor:
    b, h, w = threshim.shape
    dev = threshim.device
    _build.check_tensor(threshim, "threshim", torch.uint8, (b, h, w), dev)
    _build.check_tensor(labels, "labels", torch.int32, (b, h, w), dev)
    mask = torch.empty((b, h, w), dtype=torch.uint8, device=dev)
    scratch = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    out = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    _build.launch("rvt_propagate", dev, threshim, labels, mask, scratch, out,
                  b, h, w, n_sweeps)
    propagate_launches.count += 1
    return out


def propagate(threshim: torch.Tensor, labels: torch.Tensor,
              n_sweeps: int) -> torch.Tensor:
    """(B, H, W) uint8 threshold + (B, H, W) int32 labels -> the labels
    after exactly `n_sweeps` Jacobi masked 8-neighbour min sweeps."""
    if kernel_route(threshim) == "cpu":
        return ccl.propagate(threshim, labels, n_sweeps)
    if n_sweeps < 0:
        raise ValueError(f"n_sweeps must be >= 0, got {n_sweeps}")
    return _propagate_cuda(threshim.contiguous(), labels.contiguous(),
                           int(n_sweeps))

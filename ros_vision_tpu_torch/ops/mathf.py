"""f32 atan2, cos, sin and sqrt that give the same bits on the CPU and the
card.

PyTorch's f32 atan2, cos and sin differ in the last place between the CPU
and CUDA on about 30% of inputs (measured on an NVIDIA H100 80GB HBM3,
700.00 W), and cluster_and_fit's peak selection turns such differences into
0.1 px corner moves on a saturated 1920x1080 frame. Each function here
evaluates in f64 and rounds to the input's type: the two f64 results differ
by at most one f64 ulp, so the rounded values agree unless the f64 value
lies within that ulp of an f32 rounding boundary (about 2^-29 of inputs).

PyTorch's vectorised f32 sqrt on the CPU is not correctly rounded on every
operand (tests/test_torch_refine_kernel.py counts the ulps it misses), while
the card's and P2's are. sqrt here rounds the f64 square root, which is the
correctly rounded f32 one on either device.
"""
from __future__ import annotations

import torch


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.atan2(y.double(), x.double()).to(y.dtype)


def cos(x: torch.Tensor) -> torch.Tensor:
    return torch.cos(x.double()).to(x.dtype)


def sin(x: torch.Tensor) -> torch.Tensor:
    return torch.sin(x.double()).to(x.dtype)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.double()).to(x.dtype)

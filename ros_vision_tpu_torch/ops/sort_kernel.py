"""K9: lexicographic sort of (B, K) int32 rows (csrc/sort.cu).

Replaces ros_vision_tpu/ops/sort_pallas.py sort_tpu, whose name and
contract the wrapper keeps: 1 to 3 (B, K) int32 operands, ascending,
lexicographic over the first `num_keys` with signed int32 comparison, the
rest riding along as payload; NOT stable. Rows are padded to
N = max(256, next power of two >= K) with INT32_MAX in the key planes and
0 in the payload planes, so the first key must stay below INT32_MAX for
the padding to sort last (keys after the first may be anything, negative
included: the peak sort of cluster_and_fit passes -errbits).

A CUDA tensor launches the bitonic network of csrc/sort.cu, the TPU
kernel's network with its swap rule, so its output equals sort_tpu's bit
for bit. A CPU tensor runs the plain version, stable torch.sorts from the
last key to the first: where every operand is a key (every call of
cluster_and_fit), ties are identical tuples and the two agree bit for
bit; with payload planes they agree on the keys and, within each run of
equal keys, on the payload as a multiset.
"""
from __future__ import annotations

import torch

from ros_vision_tpu_torch import _build
from ros_vision_tpu_torch.device import kernel_route

_MAX_OPS = 3
_TILE = 4096          # elements of a shared-memory tile in csrc/sort.cu

launches = _build.counter("sort_tpu")


def padded_length(k: int) -> int:
    """The network size N for rows of K elements."""
    return max(256, 1 << (k - 1).bit_length())


def sort_plain(operands, num_keys: int = 1) -> list:
    """Plain PyTorch version (any device): stable sorts from the last key
    to the first, carrying every plane."""
    ops = list(operands)
    b, k = ops[0].shape
    perm = torch.arange(k, device=ops[0].device).expand(b, k)
    for q in reversed(range(num_keys)):
        order = torch.sort(torch.gather(ops[q], 1, perm), dim=1,
                           stable=True)[1]
        perm = torch.gather(perm, 1, order)
    return [torch.gather(o, 1, perm) for o in ops]


def _sort_cuda(ops: list, num_keys: int) -> list:
    b, k = ops[0].shape
    dev = ops[0].device
    for i, o in enumerate(ops):
        _build.check_tensor(o, f"operands[{i}]", torch.int32, (b, k), dev)
    n = padded_length(k)
    outs = [torch.empty((b, k), dtype=torch.int32, device=dev) for _ in ops]
    work = [torch.empty((b, n), dtype=torch.int32, device=dev)
            for _ in ops] if n > _TILE else []

    def three(planes):
        return list(planes) + [None] * (_MAX_OPS - len(planes))

    _build.launch("rvt_sort", dev, *three(ops), *three(work), *three(outs),
                  b, k, n, len(ops), num_keys)
    launches.count += 1
    return outs


def sort_tpu(operands, num_keys: int = 1) -> list:
    """1-3 (B, K) int32 operands -> the same, sorted along K
    lexicographically by the first num_keys (not stable); kernel on CUDA,
    plain version on the CPU."""
    ops = list(operands)
    if not 1 <= len(ops) <= _MAX_OPS:
        raise ValueError(f"1 to {_MAX_OPS} operands, got {len(ops)}")
    if not 1 <= num_keys <= len(ops):
        raise ValueError(f"num_keys must be in [1, {len(ops)}], "
                         f"got {num_keys}")
    shape = ops[0].shape
    if len(shape) != 2 or shape[1] == 0:
        raise ValueError(f"operands must be (B, K) rows, got {tuple(shape)}")
    for o in ops:
        if o.shape != shape or o.dtype != torch.int32:
            raise ValueError("operands must all be int32 of one shape, got "
                             f"{[(tuple(x.shape), x.dtype) for x in ops]}")
    if kernel_route(ops[0]) == "cpu":
        return sort_plain(ops, num_keys)
    return _sort_cuda([o.contiguous() for o in ops], num_keys)

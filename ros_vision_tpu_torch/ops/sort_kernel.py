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
for bit: one thread-block cluster per row for N <= 131,072, in one launch
(sort_plan). A CPU tensor runs the plain version, stable torch.sorts from
the last key to the first: where every operand is a key (every call of
cluster_and_fit), ties are identical tuples and the two agree bit for
bit; with payload planes they agree on the keys and, within each run of
equal keys, on the payload as a multiset. sort_network_plain is the
network itself in plain PyTorch (one vectorised step per stage and
stride) and gives sort_tpu's payload order too.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ros_vision_tpu_torch import _build
from ros_vision_tpu_torch.device import kernel_route

_MAX_OPS = 3
_I32_MAX = 2 ** 31 - 1
BLOCK_TILE = 16384     # T: elements of a row one block holds (csrc/sort.cu)
MAX_CLUSTER = 8        # the portable thread-block cluster maximum
ELEMS = 16             # E: elements per thread per plane

launches = _build.counter("sort_tpu")


def padded_length(k: int) -> int:
    """The network size N for rows of K elements."""
    return max(256, 1 << (k - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class SortPlan:
    """How csrc/sort.cu runs rows of K elements with `nops` planes."""
    n: int              # padded row length N
    tile: int           # T, elements of a row per block
    cluster: int        # C, blocks per thread-block cluster
    threads: int        # per block, T / E
    smem_bytes: int     # dynamic shared memory per block
    launches: int       # kernel launches per call


def sort_plan(k: int, nops: int) -> SortPlan:
    """The launch plan for (B, K) rows of `nops` planes: a block holds
    T = min(N, 16384) padded elements of each plane (one int of padding
    per 32), a cluster of C = min(N / T, 8) blocks holds C * T; one launch
    when N <= 8 T = 131,072, else one more cluster launch and one
    device-memory launch per stride >= 8 T for each stage above 8 T."""
    n = padded_length(k)
    tile = min(n, BLOCK_TILE)
    cluster = min(n // tile, MAX_CLUSTER)
    stages_above = (n // (tile * cluster)).bit_length() - 1
    return SortPlan(n=n, tile=tile, cluster=cluster,
                    threads=tile // ELEMS,
                    smem_bytes=4 * nops * (tile + tile // 32),
                    launches=1 + sum(i + 1
                                     for i in range(1, stages_above + 1)))


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


def _lex_less(a: list, b: list, num_keys: int) -> torch.Tensor:
    lt = a[num_keys - 1] < b[num_keys - 1]
    for q in reversed(range(num_keys - 1)):
        lt = (a[q] < b[q]) | ((a[q] == b[q]) & lt)
    return lt


def sort_network_plain(operands, num_keys: int = 1) -> list:
    """Plain PyTorch version (any device) of the TPU kernel's network:
    pad to N, then for each stage size = 2..N and stride = size/2..1 one
    vectorised compare-exchange of every pair (i, i + stride), ascending
    where bit `size` of i is 0, exchanged only on strict less-than. Equals
    sort_tpu bit for bit, payload order included."""
    ops = list(operands)
    b, k = ops[0].shape
    n = padded_length(k)
    planes = [torch.cat([o, torch.full((b, n - k),
                                       _I32_MAX if q < num_keys else 0,
                                       dtype=o.dtype, device=o.device)], 1)
              for q, o in enumerate(ops)]
    idx = torch.arange(n, device=ops[0].device)
    size = 2
    while size <= n:
        stride = size // 2
        while stride >= 1:
            shape = (b, n // (2 * stride), 2, stride)
            lo = [p.view(shape)[:, :, 0] for p in planes]
            hi = [p.view(shape)[:, :, 1] for p in planes]
            asc = (idx.view(shape[1:])[:, 0] & size) == 0
            sw = torch.where(asc, _lex_less(hi, lo, num_keys),
                             _lex_less(lo, hi, num_keys))
            planes = [torch.stack([torch.where(sw, h, lw),
                                   torch.where(sw, lw, h)], 2).view(b, n)
                      for lw, h in zip(lo, hi)]
            stride //= 2
        size *= 2
    return [p[:, :k].contiguous() for p in planes]


def _sort_cuda(ops: list, num_keys: int) -> list:
    b, k = ops[0].shape
    dev = ops[0].device
    for i, o in enumerate(ops):
        _build.check_tensor(o, f"operands[{i}]", torch.int32, (b, k), dev)
    plan = sort_plan(k, len(ops))
    outs = [torch.empty((b, k), dtype=torch.int32, device=dev) for _ in ops]
    work = [torch.empty((b, plan.n), dtype=torch.int32, device=dev)
            for _ in ops] if plan.launches > 1 else []

    def three(planes):
        return list(planes) + [None] * (_MAX_OPS - len(planes))

    made = ctypes.c_int(0)
    _build.launch("rvt_sort", dev, *three(ops), *three(work), *three(outs),
                  ctypes.addressof(made), b, k, plan.n, len(ops), num_keys,
                  plan.tile, plan.cluster, plan.threads, plan.smem_bytes)
    launches.add(made.value)
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

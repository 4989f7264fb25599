"""Connected-components labelling of a threshold image.

Counterpart of ros_vision_tpu/ops/ccl.py and ops/ccl_pallas.py. Contract
of label_components: same-value components of a {0, 127, 255} image with
4-way connectivity for 0, 8-way for 255 (diagonals join only 255 pixels)
and 127 pixels as singletons; each label is the minimum flat pixel index
of its component; ranks run 1..MAX_BLOBS over components of >= min_blob
pixels in root order (0 elsewhere). label_components and
label_components_hybrid return the 2048th blob's rank as -2048, as their
JAX counterparts do (see packed_rank); the flood entry points and K2
return 2048.

The plain PyTorch versions here (label_components, propagate_fixpoint,
label_histogram, propagate) use one algorithm: min-label hooking plus
pointer jumping to a fixpoint (hook_labels). Their hand-written kernels
are K2 in ops/frontend_kernel.py, K6-K8 in ops/ccl_kernel.py and K12 in
ops/gather_kernel.py. The entry points label_components_flood,
flood_ranks and label_components_hybrid go through those kernel wrappers,
so a CUDA tensor runs the kernels and a CPU tensor the plain versions.
The JAX functions' schedule arguments (strides, levels, chunk,
diag_strides, unit_passes, sparse_diag, interpret) change the TPU's speed,
never the output, and are dropped.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ros_vision_tpu_torch.device import HostSyncs
from ros_vision_tpu_torch.ops import ccl_kernel, gather_kernel

MAX_BLOBS = 2048          # dense big-blob id space (points.h:171 kMaxBlobs)
_BIG = 2 ** 30            # what a masked-out neighbour offers a sweep
_INT32_MAX = 2 ** 31 - 1
_FLOOD_SIZE_BITS = 19     # label_components_flood packs rank << 19 | size

# (dy, dx, diagonal?)
_OFFSETS = [
    (0, -1, False), (0, 1, False), (-1, 0, False), (1, 0, False),
    (-1, -1, True), (-1, 1, True), (1, -1, True), (1, 1, True),
]


def _shift2d(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[y, x] = in[y+dy, x+dx], `fill` outside the frame."""
    _, h, w = x.shape
    pad = F.pad(x, (1, 1, 1, 1), value=fill)
    return pad[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def _neighbor_min(labels_img: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Min label over connectivity-eligible neighbours (and self)."""
    m = labels_img
    not127 = v != 127
    white = v == 255
    for dy, dx, diag in _OFFSETS:
        nv = _shift2d(v, dy, dx, 127)
        nl = _shift2d(labels_img, dy, dx, _BIG)
        ok = not127 & (nv == v)
        if diag:
            ok = ok & white
        m = torch.minimum(m, torch.where(ok, nl, _BIG))
    return m


def dense_ranks(is_big: torch.Tensor) -> torch.Tensor:
    """1..MAX_BLOBS over the set entries of is_big (B, N) in flat order, 0
    elsewhere and past MAX_BLOBS."""
    rank = torch.cumsum(is_big.to(torch.int32), dim=1, dtype=torch.int32)
    return torch.where(is_big & (rank <= MAX_BLOBS), rank, 0)


def finish(p: torch.Tensor, min_blob: int):
    """Per-pixel (sizes, ranks) from converged labels p (B, N)."""
    b, n = p.shape
    idx = p.to(torch.int64)
    sizes_at_root = torch.zeros((b, n), dtype=torch.int32, device=p.device)
    sizes_at_root.scatter_add_(1, idx, torch.ones_like(p))
    root = p == torch.arange(n, dtype=torch.int32, device=p.device)[None]
    rank = dense_ranks(root & (sizes_at_root >= min_blob))
    return torch.gather(sizes_at_root, 1, idx), torch.gather(rank, 1, idx)


def hook_labels(threshim: torch.Tensor) -> torch.Tensor:
    """(B, H, W) uint8 -> (B, H*W) int32 min-index component labels."""
    b, h, w = threshim.shape
    n = h * w
    p = torch.arange(n, dtype=torch.int32,
                     device=threshim.device).expand(b, n).contiguous()
    while True:
        m = _neighbor_min(p.view(b, h, w), threshim).reshape(b, n)
        # hook: p[p[i]] <- min(p[p[i]], m[i]) over i sharing the parent
        pn = p.clone().scatter_reduce_(1, p.to(torch.int64), m,
                                       reduce="amin", include_self=True)
        # pointer jumping, twice
        pn = torch.gather(pn, 1, pn.to(torch.int64))
        pn = torch.gather(pn, 1, pn.to(torch.int64))
        if torch.equal(pn, p):
            return p
        p = pn


def packed_rank(ranks: torch.Tensor) -> torch.Tensor:
    """Ranks as the JAX package's _finish epilogue returns them: it packs
    rank << 20 | size into one int32 (ros_vision_tpu/ops/ccl.py:54) and
    unpacks with an arithmetic shift, so rank MAX_BLOBS = 2^11 lands on
    the sign bit and comes back as -MAX_BLOBS."""
    return torch.where(ranks == MAX_BLOBS, -MAX_BLOBS, ranks)


def label_components(threshim: torch.Tensor, min_blob: int = 25):
    """(B, H, W) uint8 -> (labels, sizes, ranks), each (B, H*W) int32, as
    ros_vision_tpu/ops/ccl.py label_components (rank -2048 for the 2048th
    blob, see packed_rank)."""
    p = hook_labels(threshim)
    sizes, ranks = finish(p, min_blob)
    return p, sizes, packed_rank(ranks)


def propagate_fixpoint(threshim: torch.Tensor,
                       values: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: (B, H, W) int32 `values` min-flooded over the
    connectivity of `threshim` to fixpoint, i.e. min(the minimum of
    `values` over each pixel's component, 2^30) at every pixel (a sweep
    offers 2^30 for every masked-out neighbour, and every component has
    one)."""
    b, h, w = threshim.shape
    idx = hook_labels(threshim).to(torch.int64)
    rootmin = torch.full((b, h * w), _INT32_MAX, dtype=torch.int32,
                         device=values.device)
    rootmin.scatter_reduce_(1, idx, values.reshape(b, h * w), reduce="amin")
    return torch.gather(rootmin, 1, idx).clamp_max_(_BIG).view(b, h, w)


def label_histogram(labels_flat: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: (B, N) int32 -> (B, N) int32 counts over the
    label space, counts[b, v] = #(labels_flat[b] == v); labels outside
    [0, N) are not counted."""
    return gather_kernel.value_histogram_plain(labels_flat,
                                               labels_flat.shape[1])


def propagate(threshim: torch.Tensor, labels: torch.Tensor,
              n_sweeps: int) -> torch.Tensor:
    """Plain version of K8: exactly `n_sweeps` Jacobi sweeps of the masked
    8-neighbour min over (B, H, W) int32 `labels` (0 returns the input)."""
    if n_sweeps < 0:
        raise ValueError(f"n_sweeps must be >= 0, got {n_sweeps}")
    for _ in range(n_sweeps):
        labels = _neighbor_min(labels, threshim)
    return labels


def _flood_labels(threshim: torch.Tensor) -> torch.Tensor:
    """(B, H, W) uint8 -> (B, H*W) labels by flooding flat pixel indices
    (K6); the flood CCL's packing needs H*W < 2^19."""
    b, h, w = threshim.shape
    n = h * w
    if n >= 1 << _FLOOD_SIZE_BITS:
        raise ValueError(f"flood CCL size packing needs h*w < 2^19 ({n}); "
                         "use label_components")
    init = torch.arange(n, dtype=torch.int32, device=threshim.device)
    init = init.expand(b, n).reshape(b, h, w)
    return ccl_kernel.propagate_fixpoint(threshim, init).reshape(b, n)


def packed_root_table(counts: torch.Tensor, min_blob: int) -> torch.Tensor:
    """(B, N) label-space counts -> the flood CCL's per-root table,
    rank << 19 | size at every root (counts > 0), INT32_MAX elsewhere."""
    rank_v = dense_ranks(counts >= min_blob)
    return torch.where(counts > 0, (rank_v << _FLOOD_SIZE_BITS) | counts,
                       _INT32_MAX)


def label_components_flood(threshim: torch.Tensor, min_blob: int = 25,
                           broadcast: str = "gather"):
    """(B, H, W) uint8 -> (labels, sizes, ranks), each (B, H*W) int32, as
    ros_vision_tpu/ops/ccl.py label_components_flood: labels by the K6
    flood, sizes by the K7 histogram over the label space, and the packed
    rank << 19 | size table broadcast back by a gather (or, with
    broadcast="flood", a second K6 flood of the table, INT32_MAX off the
    roots). H*W < 2^19."""
    if broadcast not in ("gather", "flood"):
        raise ValueError(f"broadcast must be 'gather' or 'flood', "
                         f"got {broadcast!r}")
    b, h, w = threshim.shape
    p = _flood_labels(threshim)
    counts = ccl_kernel.label_histogram(p)
    packed_v = packed_root_table(counts, min_blob)
    if broadcast == "flood":
        packed = ccl_kernel.propagate_fixpoint(
            threshim, packed_v.view(b, h, w)).reshape(b, h * w)
    else:
        packed = torch.gather(packed_v, 1, p.to(torch.int64))
    return (p, packed & ((1 << _FLOOD_SIZE_BITS) - 1),
            packed >> _FLOOD_SIZE_BITS)


def flood_ranks(threshim: torch.Tensor, min_blob: int = 25) -> torch.Tensor:
    """(B, H, W) uint8 -> (B, H*W) int32 dense blob ranks only, as
    ros_vision_tpu/ops/ccl.py flood_ranks: K6 labels, K7 counts, the rank
    table, then the K12 rank gather. H*W < 2^19."""
    p = _flood_labels(threshim)
    counts = ccl_kernel.label_histogram(p)
    return gather_kernel.rank_gather(p, dense_ranks(counts >= min_blob))


def label_components_hybrid(threshim: torch.Tensor, max_iters: int = 16,
                            pallas_sweeps: int = 448,
                            verify_sweeps: int = 64, min_blob: int = 25,
                            syncs: HostSyncs | None = None):
    """(B, H, W) uint8 -> (labels, sizes, ranks), each (B, H*W) int32, as
    ros_vision_tpu/ops/ccl.py label_components_hybrid: rounds of K8 sweeps
    (pallas_sweeps in the first round, verify_sweeps after), one
    scatter-min hook and one pointer jump each, until a round changes
    nothing or max_iters rounds ran (rank -2048 for the 2048th blob, see
    packed_rank). The loop runs on the host; each round's `changed` read
    is counted in `syncs`."""
    if syncs is None:
        syncs = HostSyncs()
    b, h, w = threshim.shape
    n = h * w
    p = torch.arange(n, dtype=torch.int32,
                     device=threshim.device).expand(b, n).contiguous()
    for it in range(max_iters):
        sweeps = pallas_sweeps if it == 0 else verify_sweeps
        m = ccl_kernel.propagate(threshim, p.view(b, h, w),
                                 sweeps).reshape(b, n)
        pn = p.clone().scatter_reduce_(1, p.to(torch.int64), m,
                                       reduce="amin", include_self=True)
        pn = torch.gather(pn, 1, pn.to(torch.int64))
        changed = syncs.item((pn != p).any())
        p = pn
        if not changed:
            break
    sizes, ranks = finish(p, min_blob)
    return p, sizes, packed_rank(ranks)

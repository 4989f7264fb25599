"""K2 (CCL ranks) and K3 (boundary compaction): the detector's front half.

Replace ros_vision_tpu/ops/frontend_pallas.py rank_image and
boundary_compact. A CUDA tensor launches csrc/ccl.cu / csrc/boundary.cu;
a CPU tensor runs the plain versions (label_components_plain here, the
hook CCL of ops/ccl.py, and ops/quadfit.py boundary_points_capped).
Outputs are bit-identical either way, including overflow at both boundary
caps. K2 returns rank 2048 for the 2048th blob, as rank_image does (the
XLA ccl.label_components returns -2048 there).

frontend() takes its ranks from the CCL the JAX detector's TPU path picks
for the frame size (frontend_route): K2 for lane-aligned frames up to 2^18
decimated pixels and for frames of 2^19 and above, the flood CCL (K6 + K7,
ops/ccl.py label_components_flood) in between, 1920x1080 among them. K3
compacts the boundary points in every case: the JAX package used the XLA
sort compaction for the flood branch only because its Pallas routing
needs lane-aligned planes, and both compute one contract.
"""
from __future__ import annotations

import torch

from ros_vision_tpu_torch import _build
from ros_vision_tpu_torch.device import kernel_route
from ros_vision_tpu_torch.ops import ccl, quadfit

MIN_BLOB_PIXELS = 25
_SCAN_TILE = 1024          # elements per scan block in csrc/scan.cuh

rank_launches = _build.counter("rank_image")
boundary_launches = _build.counter("boundary_compact")


def _label_components_cuda(threshim: torch.Tensor, min_blob: int,
                           with_sizes: bool):
    b, h, w = threshim.shape
    n = h * w
    dev = threshim.device
    _build.check_tensor(threshim, "threshim", torch.uint8, (b, h, w), dev)
    i32 = dict(dtype=torch.int32, device=dev)
    labels = torch.empty((b, n), **i32)
    size_root = torch.empty((b, n), **i32)
    rank_root = torch.empty((b, n), **i32)
    nblk = -(-n // _SCAN_TILE)
    block_counts = torch.empty((b, nblk + 1), **i32)
    ranks = torch.empty((b, n), **i32)
    sizes = torch.empty((b, n), **i32) if with_sizes else None
    _build.launch("rvt_rank_image", dev, threshim, labels, size_root,
                  rank_root, block_counts, ranks, sizes, b, h, w, min_blob,
                  ccl.MAX_BLOBS)
    rank_launches.count += 1
    return labels, sizes, ranks


def label_components_plain(threshim: torch.Tensor,
                           min_blob: int = MIN_BLOB_PIXELS):
    """Plain version of K2 (any device): (B, H, W) uint8 -> (labels,
    sizes, ranks), each (B, H*W) int32, ranks 1..2048."""
    p = ccl.hook_labels(threshim)
    sizes, ranks = ccl.finish(p, min_blob)
    return p, sizes, ranks


def label_components(threshim: torch.Tensor,
                     min_blob: int = MIN_BLOB_PIXELS):
    """(B, H, W) uint8 -> (labels, sizes, ranks), each (B, H*W) int32;
    kernel on CUDA, plain version on the CPU."""
    if kernel_route(threshim) == "cpu":
        return label_components_plain(threshim, min_blob)
    return _label_components_cuda(threshim, min_blob, with_sizes=True)


def rank_image(threshim: torch.Tensor,
               min_blob: int = MIN_BLOB_PIXELS) -> torch.Tensor:
    """(B, H, W) uint8 -> (B, H, W) int32 dense blob ranks (1..2048 over
    components of >= min_blob pixels in root order, 0 elsewhere)."""
    if kernel_route(threshim) == "cpu":
        ranks = label_components_plain(threshim, min_blob)[2]
    else:
        ranks = _label_components_cuda(threshim, min_blob,
                                       with_sizes=False)[2]
    return ranks.view(threshim.shape)


def boundary_compact_cuda(threshim: torch.Tensor, ranks: torch.Tensor,
                          p_cap: int, k_cap: int):
    """Launch csrc/boundary.cu: ((B, k_cap) key, (B, k_cap) pack2,
    (B,) counts)."""
    b, h, w = threshim.shape
    n = h * w
    dev = threshim.device
    _build.check_tensor(threshim, "threshim", torch.uint8, (b, h, w), dev)
    _build.check_tensor(ranks, "ranks", torch.int32, (b, h, w), dev)
    if 2 * w >= 2048 or 2 * h >= 2048:
        raise ValueError("image too large for 11-bit coordinates")
    pc = quadfit.boundary_block_rows(p_cap, w) * w
    i32 = dict(dtype=torch.int32, device=dev)
    maskbits = torch.empty((b, n), dtype=torch.uint8, device=dev)
    pm = torch.empty((b, pc), **i32)
    blk_a = torch.empty((b, -(-n // _SCAN_TILE) + 1), **i32)
    blk_b = torch.empty((b, -(-4 * pc // _SCAN_TILE) + 1), **i32)
    key = torch.empty((b, k_cap), **i32)
    pack2 = torch.empty((b, k_cap), **i32)
    counts = torch.empty((b,), **i32)
    _build.launch("rvt_boundary_compact", dev, threshim, ranks, maskbits, pm,
                  blk_a, blk_b, key, pack2, counts, b, h, w, pc, k_cap)
    boundary_launches.count += 1
    return key, pack2, counts


def boundary_compact(threshim: torch.Tensor, ranks: torch.Tensor,
                     p_cap: int, k_cap: int):
    """(B, H, W) threshold + (B, H, W) int32 rank planes -> (key, pack2)
    (B, k_cap) point words and counts (B,). The stage-A pixel cap is
    boundary_block_rows(p_cap, W) whole rows, as in the JAX package."""
    if kernel_route(threshim) == "cpu":
        pts, counts = quadfit.boundary_points_capped(
            threshim, ranks.reshape(ranks.shape[0], -1), p_cap, k_cap)
        return pts["key"], pts["pack2"], counts
    return boundary_compact_cuda(threshim.contiguous(), ranks.contiguous(),
                                 p_cap, k_cap)


def frontend_route(h: int, w: int) -> str:
    """The front end the JAX detector's TPU path takes for an (h, w)
    decimated frame (ros_vision_tpu/apriltag/detector.py:256-258,
    :396-398): "fused" (lane-aligned, <= 2^18 px), "flood" (< 2^19 px) or
    "large"."""
    n = h * w
    if w % 128 == 0 and h % 8 == 0 and n <= 1 << 18:
        return "fused"
    return "flood" if n < 1 << 19 else "large"


def frontend(threshim: torch.Tensor, max_points: int,
             max_boundary_pixels: int):
    """Threshold image -> ({key, pack2} (B, max_points), counts (B,)),
    ranks from the CCL that frontend_route picks."""
    if frontend_route(*threshim.shape[1:]) == "flood":
        ranks = ccl.label_components_flood(threshim)[2].view(threshim.shape)
    else:
        ranks = rank_image(threshim)
    key, pack2, counts = boundary_compact(threshim, ranks,
                                          max_boundary_pixels, max_points)
    return {"key": key, "pack2": pack2}, counts

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

import ctypes
from dataclasses import dataclass

import torch

from ros_vision_tpu_torch import _build
from ros_vision_tpu_torch.device import kernel_route
from ros_vision_tpu_torch.ops import ccl, ccl_kernel, quadfit

MIN_BLOB_PIXELS = 25
_SCAN_TILE = 1024          # elements per scan block in csrc/scan.cuh
RANK_LAUNCHES = 6          # device launches per K2 call (csrc/ccl.cu)
BOUNDARY_LAUNCHES = 1      # device launches per K3 call (csrc/boundary.cu)
# blocks per frame: past the portable 8, a non-portable cluster size the
# H100 places (the launcher opts in); 16 keeps two staged byte planes of
# the largest legal frame within a block's shared memory and halves the
# per-block pixel work of 8
BOUNDARY_CLUSTER = 16
BOUNDARY_THREADS = 1024
BOUNDARY_ITEMS = 4         # consecutive elements a thread takes
STAGE_HALO = 1056          # staged threshold bytes past a block's pixels
# dynamic shared memory a block may opt in to: the H100's 232,448 bytes
# less 1 KB kept for the kernel's static shared memory (csrc/boundary.cu)
SMEM_LIMIT = 232_448 - 1024

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
    # the rows of block counts, then one counter per frame
    block_counts = torch.empty((b * (nblk + 1) + b,), **i32)
    ranks = torch.empty((b, n), **i32)
    sizes = torch.empty((b, n), **i32) if with_sizes else None
    made = ctypes.c_int(0)
    _build.launch("rvt_rank_image", dev, threshim, labels, size_root,
                  rank_root, block_counts, ranks, sizes,
                  ctypes.addressof(made), b, h, w, min_blob, ccl.MAX_BLOBS,
                  *ccl_kernel.ccl_plan(h, w).args())
    rank_launches.add(made.value)
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


@dataclass(frozen=True)
class BoundaryPlan:
    """How csrc/boundary.cu cuts a (B, h, w) batch: one cluster of
    `cluster` blocks per frame, grid (cluster, B)."""
    cluster: int
    threads: int       # per block
    span: int          # pixels a block owns (its bits in shared memory)
    slice: int         # stage-A slots (pm) a block holds
    smem_bytes: int    # dynamic shared memory per block

    def args(self) -> tuple:
        """The launcher's plan arguments, in their order."""
        return (self.cluster, self.threads, self.span, self.slice,
                self.smem_bytes)


def boundary_plan(h: int, w: int, pc: int) -> BoundaryPlan:
    """Clusters of BOUNDARY_CLUSTER blocks of 1024 threads; block r owns
    pixels [r*span, (r+1)*span) and stage-A slots [r*slice, (r+1)*slice)
    of its frame. Shared memory (csrc/boundary.cu smem_need): the pm
    slice, one count per warp and chunk of threads * 4 elements for each
    stage (four directions in stage B, whose share of the slots is at most
    slice + 4), 8 totals, and the staged threshold bytes and (rank > 0)
    bytes of the owned pixels and of the row below them (STAGE_HALO
    more)."""
    if h < 1 or w < 1 or 2 * w >= 2048 or 2 * h >= 2048:
        raise ValueError(f"frame {h}x{w}: needs 1 to 1023 pixels a side "
                         "(11-bit coordinates)")
    if pc < 1:
        raise ValueError(f"stage-A cap of {pc} slots")
    c, threads = BOUNDARY_CLUSTER, BOUNDARY_THREADS
    span = -(-(-(-h * w // c)) // 16) * 16
    slc = -(-(-(-pc // c)) // 4) * 4
    chunk, warps = threads * BOUNDARY_ITEMS, threads // 32
    smem = 4 * (slc + -(-span // chunk) * warps
                + 4 * -(-(slc + 4) // chunk) * warps + 8) \
        + 2 * (span + STAGE_HALO)
    if smem > SMEM_LIMIT:
        raise ValueError(f"frame {h}x{w} with {pc} stage-A slots needs "
                         f"{smem} bytes of shared memory a block, more "
                         f"than {SMEM_LIMIT}")
    return BoundaryPlan(cluster=c, threads=threads, span=span, slice=slc,
                        smem_bytes=smem)


def boundary_compact_cuda(threshim: torch.Tensor, ranks: torch.Tensor,
                          p_cap: int, k_cap: int):
    """Launch csrc/boundary.cu: ((B, k_cap) key, (B, k_cap) pack2,
    (B,) counts)."""
    b, h, w = threshim.shape
    dev = threshim.device
    _build.check_tensor(threshim, "threshim", torch.uint8, (b, h, w), dev)
    _build.check_tensor(ranks, "ranks", torch.int32, (b, h, w), dev)
    pc = quadfit.boundary_block_rows(p_cap, w) * w
    plan = boundary_plan(h, w, pc)
    i32 = dict(dtype=torch.int32, device=dev)
    key = torch.empty((b, k_cap), **i32)
    pack2 = torch.empty((b, k_cap), **i32)
    counts = torch.empty((b,), **i32)
    made = ctypes.c_int(0)
    _build.launch("rvt_boundary_compact", dev, threshim, ranks, key, pack2,
                  counts, ctypes.addressof(made), b, h, w, pc, k_cap,
                  *plan.args())
    boundary_launches.add(made.value)
    return key, pack2, counts


def boundary_compact(threshim: torch.Tensor, ranks: torch.Tensor,
                     p_cap: int, k_cap: int, syncs=None):
    """(B, H, W) threshold + (B, H, W) int32 rank planes -> (key, pack2)
    (B, k_cap) point words and counts (B,). The stage-A pixel cap is
    boundary_block_rows(p_cap, W) whole rows, as in the JAX package."""
    if kernel_route(threshim) == "cpu":
        pts, counts = quadfit.boundary_points_capped(
            threshim, ranks.reshape(ranks.shape[0], -1), p_cap, k_cap,
            syncs)
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
             max_boundary_pixels: int, syncs=None):
    """Threshold image -> ({key, pack2} (B, max_points), counts (B,)),
    ranks from the CCL that frontend_route picks. `syncs`
    (device.HostSyncs) counts the plain version's table upload."""
    if frontend_route(*threshim.shape[1:]) == "flood":
        ranks = ccl.label_components_flood(threshim)[2].view(threshim.shape)
    else:
        ranks = rank_image(threshim)
    key, pack2, counts = boundary_compact(threshim, ranks,
                                          max_boundary_pixels, max_points,
                                          syncs)
    return {"key": key, "pack2": pack2}, counts

"""K6 (propagate_fixpoint), K7 (label_histogram) and K8 (propagate): the
flood CCL's kernels, and the launch plan of the tiled union-find that K6
and K2 (ops/frontend_kernel.py) label with.

Replace ros_vision_tpu/ops/ccl_pallas.py propagate_fixpoint,
label_histogram and propagate. A CUDA tensor launches csrc/flood.cu; a
CPU tensor runs the plain versions of ops/ccl.py. Outputs are bit-identical
either way.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ros_vision_tpu_torch import _build
from ros_vision_tpu_torch.device import kernel_route
from ros_vision_tpu_torch.ops import ccl

fixpoint_launches = _build.counter("propagate_fixpoint")
histogram_launches = _build.counter("label_histogram")
propagate_launches = _build.counter("propagate")

TILE_H = 32                # rows of a tile (csrc/unionfind.cuh)
TILE_W = 128               # columns of a tile, compiled into the kernels
TILE_ITEMS = 8             # a tile's pixels per thread in phases A and C
TILE_SMEM_PER_PIXEL = 8    # phase C: a slot total and a final root
SMEM_LIMIT = 48 * 1024     # a block's shared memory without opting in
MAX_GRID_YZ = 65535
MAX_FRAME_PIXELS = 1 << 24  # phase C divides flat indices by w in float
FIXPOINT_LAUNCHES = 4      # device launches per K6 call (csrc/flood.cu)
HISTOGRAM_LAUNCHES = 1     # device launches per K7 call (csrc/flood.cu)
PROPAGATE_TILE_H = 80      # K8: rows of a tile's interior
PROPAGATE_TILE_W = 112     # K8: columns of a tile's interior
PROPAGATE_HALO = 8         # K8: sweeps a launch, and the halo on each side
PROPAGATE_ROWS = 12        # K8: rows a thread, compiled into csrc/flood.cu
PROPAGATE_THREADS = 1024   # K8: threads a block, compiled in as well


@dataclasses.dataclass(frozen=True)
class CclPlan:
    """How csrc/unionfind.cuh cuts (B, h, w) frames into tiles, one block
    a tile; grid (tiles_x, tiles_y, B)."""
    tile_h: int
    tile_w: int
    tiles_x: int
    tiles_y: int
    threads: int         # per block in phases A (tile) and C (finalize)
    border_threads: int  # per block in phase B (border merge)
    smem_bytes: int      # dynamic shared memory per block in A and C

    def args(self) -> tuple:
        """The launchers' plan arguments, in their order."""
        return (self.tile_h, self.tile_w, self.tiles_x, self.tiles_y,
                self.threads, self.border_threads, self.smem_bytes)


def ccl_plan(h: int, w: int) -> CclPlan:
    """Tiles of 32 rows by 128 columns (the last row and column of tiles
    ragged), 512 threads (8 pixels each) in phases A and C, and in phase B
    one thread per pixel of a tile's top row and left and right columns.
    Shared memory: phase C's slot totals and final roots, 8 bytes a pixel
    (phase A's labels and image bytes take 5)."""
    if h < 1 or w < 1 or h * w > MAX_FRAME_PIXELS:
        raise ValueError(f"frames of {h}x{w} pixels cannot be labelled "
                         f"(1 to {MAX_FRAME_PIXELS} pixels)")
    tiles_y = -(-h // TILE_H)
    if tiles_y > MAX_GRID_YZ:
        raise ValueError(f"{h} rows need {tiles_y} tile rows, more than "
                         f"the grid's {MAX_GRID_YZ}")
    return CclPlan(tile_h=TILE_H, tile_w=TILE_W, tiles_x=-(-w // TILE_W),
                   tiles_y=tiles_y, threads=TILE_H * TILE_W // TILE_ITEMS,
                   border_threads=-(-(TILE_W + 2 * TILE_H) // 32) * 32,
                   smem_bytes=TILE_SMEM_PER_PIXEL * TILE_H * TILE_W)


@dataclasses.dataclass(frozen=True)
class PropagatePlan:
    """How csrc/flood.cu runs K8 on (B, h, w) frames: `rounds` launches of
    at most `halo` sweeps (the copy for 0 sweeps), each over a grid
    (tiles_x, tiles_y, B) of blocks, one a tile of tile_h x tile_w pixels
    kept in shared memory with a halo of `halo` pixels on each side."""
    tile_h: int
    tile_w: int
    halo: int
    tiles_x: int
    tiles_y: int
    rounds: int
    threads: int
    smem_bytes: int   # two buffers of 8 B a cell and the threshold

    @property
    def launches(self) -> int:
        """Device launches a call (the copy for 0 sweeps counts one)."""
        return max(1, self.rounds)

    def args(self) -> tuple:
        """The launcher's plan arguments, in their order."""
        return (self.tile_h, self.tile_w, self.halo, self.tiles_x,
                self.tiles_y, self.threads, self.smem_bytes)


def propagate_cells(tile_h: int, tile_w: int, halo: int) -> int:
    """Cells a block keeps in shared memory (csrc/flood.cu Region): the
    tile, the halo and a ring of one cell."""
    return (tile_h + 2 * halo + 2) * (tile_w + 2 * halo + 2)


def propagate_plan(h: int, w: int, n_sweeps: int) -> PropagatePlan:
    """Tiles of 80 x 112 pixels (the last row and column of tiles ragged)
    with a halo of 8: a region of 96 x 128, 1024 threads of 12 rows of one
    column each, and 8 sweeps a launch. The halo's cost grows with the
    sweeps a launch (1.37x the tile's pixels here) and the launches
    shrink with them; at 640x400 B=4 the frames are 120 tiles, one wave
    on 132 SMs (a block's 216,592 bytes of shared memory leave one an
    SM)."""
    if h < 1 or w < 1:
        raise ValueError(f"frames of {h}x{w} pixels cannot be swept")
    if n_sweeps < 0:
        raise ValueError(f"n_sweeps must be >= 0, got {n_sweeps}")
    tiles_y = -(-h // PROPAGATE_TILE_H)
    if tiles_y > MAX_GRID_YZ:
        raise ValueError(f"{h} rows need {tiles_y} tile rows, more than "
                         f"the grid's {MAX_GRID_YZ}")
    halo = PROPAGATE_HALO
    cells = propagate_cells(PROPAGATE_TILE_H, PROPAGATE_TILE_W, halo)
    return PropagatePlan(
        tile_h=PROPAGATE_TILE_H, tile_w=PROPAGATE_TILE_W, halo=halo,
        tiles_x=-(-w // PROPAGATE_TILE_W), tiles_y=tiles_y,
        rounds=-(-n_sweeps // halo), threads=PROPAGATE_THREADS,
        smem_bytes=2 * 8 * cells + -(-cells // 16) * 16)


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
    made = ctypes.c_int(0)
    _build.launch("rvt_propagate_fixpoint", dev, threshim, values, labels,
                  rootmin, out, ctypes.addressof(made), b, h, w,
                  *ccl_plan(h, w).args())
    fixpoint_launches.add(made.value)
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
    made = ctypes.c_int(0)
    _build.launch("rvt_label_histogram", dev, labels_flat, counts,
                  ctypes.addressof(made), b, n)
    histogram_launches.add(made.value)
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
    plan = propagate_plan(h, w, n_sweeps)
    out = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    scratch = torch.empty_like(out) if plan.rounds > 1 else None
    made = ctypes.c_int(0)
    _build.launch("rvt_propagate", dev, threshim, labels, scratch, out,
                  ctypes.addressof(made), b, h, w, n_sweeps, *plan.args())
    propagate_launches.add(made.value)
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

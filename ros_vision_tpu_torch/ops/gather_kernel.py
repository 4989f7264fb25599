"""K4 value histogram, K10 table gather, K11 segment min/max and K12 rank
gather.

K4, out[b, s] = #(values[b] == s), replaces
ros_vision_tpu/ops/gather_pallas.py value_histogram (the per-segment
counts of cluster_and_fit); values outside [0, num_values) are not
counted. It runs one thread-block cluster per row in one launch
(histogram_plan), for num_values up to 8,192. K10, out[b, c, k] =
table[b, idx[b, k], c] (0 for an index outside [0, S)), replaces
gather_pallas.py table_take_cm, with take_cm its dispatcher: one launch,
a thread per 4 consecutive k with 16-byte index loads and stores (a
float4 table row at C = 4). K11, the per-segment min and max of (B, K)
values, replaces gather_pallas.py segment_min_max: one launch of a
thread-block cluster per (row, slice of segments) (segment_plan), each
block's tables in shared memory merged by their owners over distributed
shared memory, with no fill pass and no global atomic. K12, out[b, i] =
rank_v[b, labels[b, i]] (0 for a label outside [0, N)), replaces
gather_pallas.py rank_gather (the rank broadcast of ccl.flood_ranks). A
CUDA tensor launches csrc/histogram.cu, csrc/gather.cu (K10, K12) or
csrc/segment.cu (K11); a CPU tensor runs the plain version. Bit-exact
either way. scripts/mb_torch_gather_phases.py times K10's and K11's
device launches beside the launch floor.

K10 follows table_take_cm_ref's contract, not the TPU kernel's arithmetic:
the TPU kernel gathers by a one-hot f32 matmul, which turns -0.0 into
+0.0 and spreads an inf or NaN of the table over the whole 256-row chunk
(0 * inf), so the two differ on non-finite tables and on -0.0. Here the
value is copied.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ros_vision_tpu_torch import _build
from ros_vision_tpu_torch.device import kernel_route

launches = _build.counter("value_histogram")
take_launches = _build.counter("table_take_cm")
minmax_launches = _build.counter("segment_min_max")
rank_gather_launches = _build.counter("rank_gather")
_BIG = 2 ** 30             # segment_min_max's empty-segment min (-max)
HIST_CLUSTER = 8           # blocks per row in csrc/histogram.cu
HIST_THREADS = 1024
HIST_MAX_BINS = 8192       # one shared-memory table of int32 bins
SEG_MAX_CLUSTER = 16       # the H100's non-portable cluster size
SEG_ITEMS = 8              # consecutive points a thread of segment.cu loads
SEG_MAX_SLICE = 4096       # segments a cluster's tables hold (32 KB a block)
SEG_SMS = 132              # the H100's SMs, which B x slices x R should fill
SEG_MAX_THREADS = 1024


@dataclasses.dataclass(frozen=True)
class HistogramPlan:
    """How csrc/histogram.cu runs (B, K) rows into S bins."""
    cluster: int        # C, blocks per row (one cluster)
    threads: int        # per block
    bins_per_rank: int  # output bins each block sums and writes
    smem_bytes: int     # the block's S-bin table


def histogram_plan(num_values: int) -> HistogramPlan:
    """One cluster of 8 blocks per row; block rank r merges bins
    [r * ceil(S / 8), (r + 1) * ceil(S / 8))."""
    if not 0 < num_values <= HIST_MAX_BINS:
        raise ValueError(f"value_histogram takes 1 to {HIST_MAX_BINS} "
                         f"bins, got {num_values}")
    return HistogramPlan(cluster=HIST_CLUSTER, threads=HIST_THREADS,
                         bins_per_rank=-(-num_values // HIST_CLUSTER),
                         smem_bytes=4 * num_values)


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """How csrc/segment.cu reduces (B, K) points into S segments."""
    cluster: int         # R, blocks per (row, slice): one cluster
    threads: int         # per block
    chunk: int           # consecutive points of the row each block takes
    slices: int          # slices of segments, one cluster each
    segs_per_slice: int  # segments each slice's tables hold
    segs_per_rank: int   # segments of its slice each block owns, writes
    smem_bytes: int      # the block's two tables of its slice


def segment_plan(b: int, k: int, s: int) -> SegmentPlan:
    """Slices of at most SEG_MAX_SLICE segments; R the largest power of
    two up to 16 with B x slices x R <= 132 SMs (and no more blocks than
    warps of SEG_ITEMS points); block rank r takes points [r * chunk,
    (r + 1) * chunk) of its row (chunk a multiple of 4, for 16-byte
    loads), with threads enough for its chunk in one step where a block
    holds that many, and owns segments [r * per_rank, (r + 1) * per_rank)
    of its slice: the other blocks push their entries there into its
    tables, and it writes them."""
    if b < 1 or k < 0 or s < 1:
        raise ValueError(f"segment_min_max takes B >= 1, K >= 0 and S >= 1,"
                         f" got ({b}, {k}, {s})")
    slices = -(-s // SEG_MAX_SLICE)
    per_slice = -(-s // slices)
    fit = max(1, min(SEG_SMS // (b * slices), -(-k // (32 * SEG_ITEMS))))
    cluster = min(SEG_MAX_CLUSTER, 1 << (fit.bit_length() - 1))
    chunk = -(-k // cluster)
    chunk += -chunk % 4
    threads = min(SEG_MAX_THREADS, max(32, -(-chunk // SEG_ITEMS)))
    threads += -threads % 32
    return SegmentPlan(cluster=cluster, threads=threads, chunk=chunk,
                       slices=slices, segs_per_slice=per_slice,
                       segs_per_rank=-(-per_slice // cluster),
                       smem_bytes=8 * per_slice)


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
    plan = histogram_plan(num_values)
    out = torch.empty((b, num_values), dtype=torch.int32, device=dev)
    made = ctypes.c_int(0)
    _build.launch("rvt_value_histogram", dev, values, out,
                  ctypes.addressof(made), b, k, num_values, plan.cluster,
                  plan.threads, plan.bins_per_rank, plan.smem_bytes)
    launches.add(made.value)
    return out


def histogram(values: torch.Tensor, num_values: int) -> torch.Tensor:
    """(B, K) int32 -> (B, num_values) int32 counts; kernel on CUDA,
    plain version on the CPU."""
    if kernel_route(values) == "cpu":
        return value_histogram_plain(values, num_values)
    return value_histogram_cuda(values.contiguous(), num_values)


def table_take_cm_plain(table: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (any device) of table_take_cm_ref: (B, S, C)
    table, (B, K) indices -> (B, C, K) f32, 0 where an index lies outside
    [0, S)."""
    _, s, c = table.shape
    inside = (idx >= 0) & (idx < s)
    safe = idx.clamp(0, s - 1).to(torch.int64)
    g = torch.gather(table.to(torch.float32), 1,
                     safe[..., None].expand(-1, -1, c))
    return torch.where(inside[..., None], g, 0.0).movedim(-1, 1)


def _table_take_cm_cuda(table: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    b, s, c = table.shape
    k = idx.shape[1]
    dev = table.device
    _build.check_tensor(table, "table", torch.float32, (b, s, c), dev)
    _build.check_tensor(idx, "idx", torch.int32, (b, k), dev)
    out = torch.empty((b, c, k), dtype=torch.float32, device=dev)
    made = ctypes.c_int(0)
    _build.launch("rvt_table_take_cm", dev, table, idx, out,
                  ctypes.addressof(made), b, s, c, k)
    take_launches.add(made.value)
    return out


def take_cm(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, S, C) table + (B, K) int32 indices -> (B, C, K) f32
    channel-major gather (0 outside [0, S)); kernel on CUDA, plain
    version on the CPU."""
    if kernel_route(table) == "cpu":
        return table_take_cm_plain(table, idx)
    return _table_take_cm_cuda(table.to(torch.float32).contiguous(),
                               idx.contiguous())


def segment_min_max_plain(seg: torch.Tensor, val: torch.Tensor,
                          num_segments: int):
    """Plain PyTorch version (any device) of segment_min_max_ref: (B, K)
    segment ids and values -> ((B, S) min, (B, S) max), starting from
    2^30 / -2^30 (so empty segments read those); ids outside [0, S) are
    dropped."""
    b = seg.shape[0]
    inside = (seg >= 0) & (seg < num_segments)
    idx = torch.where(inside, seg, num_segments).to(torch.int64)
    mn = torch.full((b, num_segments + 1), _BIG, dtype=torch.int32,
                    device=seg.device)
    mx = torch.full_like(mn, -_BIG)
    v = val.to(torch.int32)
    mn.scatter_reduce_(1, idx, v, reduce="amin")
    mx.scatter_reduce_(1, idx, v, reduce="amax")
    return mn[:, :num_segments], mx[:, :num_segments]


def _segment_min_max_cuda(seg: torch.Tensor, val: torch.Tensor,
                          num_segments: int):
    b, k = seg.shape
    dev = seg.device
    _build.check_tensor(seg, "seg", torch.int32, (b, k), dev)
    _build.check_tensor(val, "val", torch.int32, (b, k), dev)
    mn = torch.empty((b, num_segments), dtype=torch.int32, device=dev)
    mx = torch.empty((b, num_segments), dtype=torch.int32, device=dev)
    if b == 0 or num_segments == 0:
        return mn, mx                       # no entry to write
    plan = segment_plan(b, k, num_segments)
    made = ctypes.c_int(0)
    _build.launch("rvt_segment_min_max", dev, seg, val, mn, mx,
                  ctypes.addressof(made), b, k, num_segments, plan.cluster,
                  plan.threads, plan.chunk, plan.slices, plan.segs_per_slice,
                  plan.segs_per_rank, plan.smem_bytes)
    minmax_launches.add(made.value)
    return mn, mx


def segment_min_max(seg: torch.Tensor, val: torch.Tensor,
                    num_segments: int):
    """(B, K) int32 segment ids and values -> ((B, S) min, (B, S) max),
    min(2^30, .) and max(-2^30, .) of each segment's values, ids outside
    [0, S) dropped; kernel on CUDA, plain version on the CPU."""
    if kernel_route(seg) == "cpu":
        return segment_min_max_plain(seg, val, num_segments)
    return _segment_min_max_cuda(seg.contiguous(), val.contiguous(),
                                 num_segments)


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
    rank_gather_launches.add()
    return out


def rank_gather(labels: torch.Tensor, rank_v: torch.Tensor) -> torch.Tensor:
    """(B, N) int32 labels + (B, N) int32 table -> (B, N) int32
    rank_v[labels] (0 outside [0, N)); kernel on CUDA, plain version on
    the CPU."""
    if kernel_route(labels) == "cpu":
        return rank_gather_plain(labels, rank_v)
    return _rank_gather_cuda(labels.contiguous(), rank_v.contiguous())

// K11: per-segment min and max, mn[b, s] = min(2^30, min{val[b, i] :
// seg[b, i] == s}) and mx[b, s] = max(-2^30, max{...}) for s in [0, S);
// an empty segment reads 2^30 / -2^30 and a segment id outside [0, S) is
// dropped.
//
// Replaces ros_vision_tpu/ops/gather_pallas.py segment_min_max
// (pallas_call at :251, kernel body _make_minmax_kernel:201). The TPU
// masks a one-hot (K_TILE, 256) plane per S-chunk and reduces it, because
// it has no scatter-min. Bound on the H100: bytes, seg and val read once
// (1 MB per 131,072-point row) and the two (B, S) tables written once; a
// row's points go to one cluster, so the rate one SM pulls from L2
// (at most ~19 B a clock in its points phase, PERF.md §6, PR 8) and the
// launch weigh more.
// Design: one launch, one thread-block cluster of R blocks (R <= 16, a
// non-portable size above 8) per (row, slice of at most 4,096 segments),
// grid (R, B, slices):
//   - each block takes one contiguous chunk of the row; each thread loads
//     `kItems` consecutive points (16-byte loads of seg and of val, all
//     issued before any reduction; scalar loads at a ragged edge), its
//     first step's before the block starts both tables of its slice at
//     +-2^30 in shared memory and arrives at a split cluster barrier;
//   - a thread folds runs of equal ids into one (min, max) in registers;
//     every run but its last goes straight to the block's tables with
//     shared atomicMin / atomicMax; the last runs of a warp's lanes are
//     reduced over each group of neighbouring lanes that hold the same id
//     (a segmented shuffle scan) and one lane a group updates the tables,
//     so that sorted ids cost about one shared atomic per run and warp,
//     and random ids at most one per point (__match_any_sync in its place
//     made a block of the path's ids ~2,200 cycles slower on average, and
//     the points phase on random ids 2.2x as long: PERF.md §6, PR 8);
//   - block rank r owns segments [r * per_rank, (r + 1) * per_rank) of the
//     slice: every entry a block changed outside its own segments goes to
//     its owner's tables with atomics on distributed shared memory. Before
//     that push a block waits at the split barrier for every peer's
//     arrival: a push into a peer that has not started, or one that its
//     start would overwrite with +-2^30, would be lost. Between the arrive
//     and the wait lies the points phase, so the wait costs little. A
//     release arrive on every thread cost ~1,230 cycles a block (its
//     fence) and 0.0006 ms a call; one thread's fence before a relaxed
//     arrive, behind the first loads, costs nothing measurable (PERF.md
//     §6, PR 8);
//   - after one cluster.sync() each owner writes its segments from its own
//     tables with plain coalesced stores and exits: every output entry is
//     written exactly once, so there is no fill pass and no global atomic,
//     and no block reads another's shared memory after the barrier.
// Min and max are order-independent, so the result is bit-exact whatever
// the order.
//
// The launch plan (R, threads, chunk, slices, segments per slice and per
// rank, shared bytes) is ops/gather_kernel.py segment_plan's;
// rvt_segment_min_max takes it as given and checks only what the device
// and the kernel's layout require.
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster.cuh"

namespace cg = cooperative_groups;

// -DRVT_SEGMENT_PHASE_CLOCKS (a timing build, off by default; see
// scripts/mb_torch_gather_phases.py): thread 0 of each block adds the
// clock cycles of the kernel's five phases and counts the blocks;
// rvt_segment_clocks(out) returns the five sums, the blocks, and the
// first start and the last end on the global timer (ns) since the last
// read. The phases: the tables' start; the points (loads, runs and
// shared atomics); the wait for the peers' starts and the push to the
// owners; the cluster.sync(); the owners' stores (each up to a
// __syncthreads of this build).
#ifdef RVT_SEGMENT_PHASE_CLOCKS
constexpr int kPhases = 5;
__device__ unsigned long long g_segment_clocks[kPhases + 3];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// phase 0 starts the block's clock; phases 1-5 add the cycles since the
// last call to sum phase - 1, and phase 5 ends the block
__device__ __forceinline__ void phase_clock(int phase, long long& since) {
  if (threadIdx.x != 0) return;
  const long long now = clock64();
  unsigned long long* c = g_segment_clocks;
  if (phase == 0) {
    atomicMin(&c[kPhases + 1], global_ns());
  } else {
    atomicAdd(&c[phase - 1], (unsigned long long)(now - since));
  }
  if (phase == kPhases) {
    atomicAdd(&c[kPhases], 1ull);
    atomicMax(&c[kPhases + 2], global_ns());
  }
  since = now;
}
extern "C" int rvt_segment_clocks(unsigned long long* out) {
  unsigned long long zero[kPhases + 3] = {};
  zero[kPhases + 1] = ~0ull;
  cudaError_t e = cudaMemcpyFromSymbol(out, g_segment_clocks, sizeof(zero));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(g_segment_clocks, zero, sizeof(zero));
}
#define RVT_PHASE_SYNC() __syncthreads()
#else
__device__ __forceinline__ void phase_clock(int, long long&) {}
#define RVT_PHASE_SYNC()
#endif

namespace {

constexpr int kItems = 8;          // consecutive points a thread loads
constexpr int kMaxThreads = 1024;
constexpr int kSmemLimit = 48 * 1024;  // a block's shared memory, no opt-in
constexpr int kBig = 1 << 30;

// The halves of a cluster barrier (barrier.cluster, acquire on wait);
// every thread of the cluster calls each once, in order, before the next
// cluster.sync(). The arrive is relaxed: the block's thread 0 alone fences
// (fence.acq_rel.cluster, cumulative over the writes the block's
// __syncthreads() made visible to it) before it arrives, so that one warp,
// not every warp, waits out the fence.
__device__ __forceinline__ void cluster_arrive() {
  if (threadIdx.x == 0) asm volatile("fence.acq_rel.cluster;" ::: "memory");
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Loads kItems consecutive points from p0: 16-byte loads of seg and of val
// where the group lies before `end` (and kVec), else scalar loads; past
// `end` an id of -1, which lies outside every slice, so nothing is added.
template <bool kVec>
__device__ __forceinline__ void load_points(const int* __restrict__ sg,
                                            const int* __restrict__ vl,
                                            int p0, int end, int* id,
                                            int* v) {
  if (kVec && p0 + kItems <= end) {
    const int4* s4 = reinterpret_cast<const int4*>(sg + p0);
    const int4* v4 = reinterpret_cast<const int4*>(vl + p0);
    int4 a[kItems / 4], b[kItems / 4];
#pragma unroll
    for (int j = 0; j < kItems / 4; ++j) {
      a[j] = __ldg(s4 + j);
      b[j] = __ldg(v4 + j);
    }
#pragma unroll
    for (int j = 0; j < kItems / 4; ++j) {
      id[4 * j] = a[j].x;
      id[4 * j + 1] = a[j].y;
      id[4 * j + 2] = a[j].z;
      id[4 * j + 3] = a[j].w;
      v[4 * j] = b[j].x;
      v[4 * j + 1] = b[j].y;
      v[4 * j + 2] = b[j].z;
      v[4 * j + 3] = b[j].w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const bool in = p0 + j < end;
      id[j] = in ? __ldg(sg + p0 + j) : -1;
      v[j] = in ? __ldg(vl + p0 + j) : 0;
    }
  }
}

// Folds n consecutive points (id, v) into runs of equal ids: every run but
// the last goes to the tables with shared atomics; the last is returned.
template <int n>
__device__ __forceinline__ void fold_runs(const int* id, const int* v,
                                          int* tmin, int* tmax, int s0,
                                          unsigned ns_u, int& cur, int& lo,
                                          int& hi) {
  cur = id[0];
  lo = v[0];
  hi = v[0];
#pragma unroll
  for (int j = 1; j < n; ++j) {
    if (id[j] != cur) {
      const unsigned local = (unsigned)cur - (unsigned)s0;
      if (local < ns_u) {
        atomicMin(tmin + local, lo);
        atomicMax(tmax + local, hi);
      }
      cur = id[j];
      lo = v[j];
      hi = v[j];
    } else {
      lo = min(lo, v[j]);
      hi = max(hi, v[j]);
    }
  }
}

// The lanes' last runs: each group of neighbouring lanes that hold the
// same in-slice id reduces its runs by a segmented scan over shuffles, and
// the group's last lane updates the tables. Every lane must call it.
__device__ __forceinline__ void merge_last_runs(int cur, int lo, int hi,
                                                int* tmin, int* tmax, int s0,
                                                unsigned ns_u, int lane) {
  const unsigned local = (unsigned)cur - (unsigned)s0;
  const bool in = local < ns_u;
  const int key = in ? (int)local : -1;
  const int before = __shfl_up_sync(0xffffffffu, key, 1);
  const unsigned heads =
      __ballot_sync(0xffffffffu, lane == 0 || before != key);
  // the group's first lane: the last head at or below this lane
  const int head = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int olo = __shfl_up_sync(0xffffffffu, lo, off);
    const int ohi = __shfl_up_sync(0xffffffffu, hi, off);
    if (lane - off >= head) {
      lo = min(lo, olo);
      hi = max(hi, ohi);
    }
  }
  if (in && (lane == 31 || ((heads >> (lane + 1)) & 1u))) {
    atomicMin(tmin + local, lo);
    atomicMax(tmax + local, hi);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
    segment_minmax_kernel(const int* __restrict__ seg,
                          const int* __restrict__ val, int* __restrict__ mn,
                          int* __restrict__ mx, int k, int s, int chunk,
                          int per_slice, int per_rank) {
  extern __shared__ int tables[];
  long long since = 0;
  phase_clock(0, since);
  int* tmin = tables;
  int* tmax = tables + per_slice;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.y;
  const int s0 = blockIdx.z * per_slice;
  const int ns = min(per_slice, s - s0);
  const unsigned ns_u = (unsigned)ns;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int* sg = seg + (size_t)row * k;
  const int* vl = val + (size_t)row * k;
  const int lo_pt = min(k, rank * chunk);
  const int hi_pt = min(k, lo_pt + chunk);
  const int step = blockDim.x * kItems;
  // the first step's loads go out before the tables' start: their latency
  // hides the release fence of the cluster barrier's arrive
  int id[kItems], v[kItems];
  load_points<kVec>(sg, vl, lo_pt + tid * kItems, hi_pt, id, v);
  for (int i = tid; i < ns; i += blockDim.x) {
    tmin[i] = kBig;
    tmax[i] = -kBig;
  }
  __syncthreads();
  cluster_arrive();
  phase_clock(1, since);
  // the loop bound is uniform over the block, so every lane of every warp
  // reaches the shuffles together
  for (int base = lo_pt; base < hi_pt; base += step) {
    if (base != lo_pt)
      load_points<kVec>(sg, vl, base + tid * kItems, hi_pt, id, v);
    int cur, lo, hi;
    fold_runs<kItems>(id, v, tmin, tmax, s0, ns_u, cur, lo, hi);
    merge_last_runs(cur, lo, hi, tmin, tmax, s0, ns_u, lane);
  }
  __syncthreads();
  phase_clock(2, since);
  // every peer's tables have started; every entry this block changed
  // outside its own segments goes to the owner's tables; after the
  // cluster.sync() each owner's tables hold its segments' results
  cluster_wait();
  const int own0 = min(ns, rank * per_rank);
  const int own1 = min(ns, own0 + per_rank);
  for (int i = tid; i < ns; i += blockDim.x) {
    if (i >= own0 && i < own1) continue;
    const int q = i / per_rank;
    if (tmin[i] != kBig)
      atomicMin(cluster.map_shared_rank(tmin + i, q), tmin[i]);
    if (tmax[i] != -kBig)
      atomicMax(cluster.map_shared_rank(tmax + i, q), tmax[i]);
  }
  RVT_PHASE_SYNC();
  phase_clock(3, since);
  cluster.sync();
  phase_clock(4, since);
  int* om = mn + (size_t)row * s + s0;
  int* ox = mx + (size_t)row * s + s0;
  for (int i = own0 + tid; i < own1; i += blockDim.x) {
    om[i] = tmin[i];
    ox[i] = tmax[i];
  }
  RVT_PHASE_SYNC();
  phase_clock(5, since);
}

}  // namespace

// seg, val (B, K); mn, mx (B, S); cluster, threads, chunk, slices,
// per_slice, per_rank and smem the plan of ops/gather_kernel.py
// segment_plan. *launches receives the number of kernel launches made.
// Returns a cudaError_t, or -1 when the device cannot place the cluster.
extern "C" int rvt_segment_min_max(const int* seg, const int* val, int* mn,
                                   int* mx, int* launches, int b, int k,
                                   int s, int cluster, int threads, int chunk,
                                   int slices, int per_slice, int per_rank,
                                   int smem, int device,
                                   cudaStream_t stream) {
  *launches = 0;
  cudaSetDevice(device);
  if (b == 0 || s == 0) return 0;
  // the layout: whole warps (the shuffles span all 32 lanes); every
  // point in one block's chunk, whole 16-byte groups from a chunk's start;
  // every segment in one slice and one rank's part of it; both tables of
  // a slice in shared memory; point indices that stay inside an int
  if (b < 0 || b > 65535 || k < 0 || k > (1 << 30) || s < 0 ||
      cluster < 1 || cluster > rvt::kMaxClusterBlocks || threads < 32 ||
      threads % 32 != 0 || threads > kMaxThreads || chunk < 0 ||
      chunk % 4 != 0 || (long long)chunk * cluster < k || slices < 1 ||
      slices > 65535 || per_slice < 1 ||
      (long long)per_slice * slices < s || per_rank < 1 ||
      (long long)per_rank * cluster < per_slice ||
      smem != 2 * (int)sizeof(int) * per_slice || smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(seg) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(val) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, b, slices);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // placeable at the largest blocks a plan may ask for, so at any plan's
  const int err =
      vec ? rvt::cluster_placeable<segment_minmax_kernel<true>>(
                device, cfg, cluster, kMaxThreads, kSmemLimit)
          : rvt::cluster_placeable<segment_minmax_kernel<false>>(
                device, cfg, cluster, kMaxThreads, kSmemLimit);
  if (err != 0) return err;
  const auto kernel =
      vec ? segment_minmax_kernel<true> : segment_minmax_kernel<false>;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, kernel, seg, val, mn, mx, k, s, chunk, per_slice, per_rank);
  *launches = rc == cudaSuccess;
  return (int)rc;
}

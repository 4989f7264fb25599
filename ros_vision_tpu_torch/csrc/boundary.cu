// K3: boundary points of big blob pairs, thinned and compacted to K slots.
//
// Replaces ros_vision_tpu/ops/frontend_pallas.py boundary_compact
// (stage-B pallas_call at :749, body _make_stage_b_kernel:673; the two
// route_planes pallas_calls at :657, body _make_route_kernel:590).
// Contract of ros_vision_tpu/ops/quadfit.py boundary_points:
//   stage A  per-pixel BlobDiff bits (quadfit.py:136-165): bit d = direction
//            d emits a point, bit 4+d = its gradient sign is +; pixels that
//            emit anything are uniformly thinned to p_cap = BR*W slots and
//            compacted in pixel order as pm = (py<<11|px)<<8 | maskbits;
//   stage B  the 4 x p_cap candidates in DIR-MAJOR order (d*p_cap + slot,
//            quadfit.py:247-256) are thinned to k_cap and compacted; each
//            kept candidate is written as the finish_points words
//            (quadfit.py:168-183): key = (lo_rank-1)<<11 | (hi_rank-1) and
//            pack2 = x2<<15 | y2<<4 | (gx+1)<<2 | (gy+1).
//   counts   = kept points per frame (what boundary_points returns).
//
// Thinning is the closed-form f32 rule of segments.thin_uniform /
// frontend_pallas._thin_targets: r = min(1, (cap-2)/max(T,1)), keep iff
// floor((slot+1) r) > floor(slot r), target floor(slot r). It must be
// computed exactly as XLA does (one f32 rounding per operation, IEEE
// division): __fdiv_rn / __fmul_rn / __fadd_rn below, and the build has
// no fast-math. One differing rounding drops different points on a frame
// that overflows the cap. Targets are strictly increasing over kept
// elements and cover [0, kept) exactly, so a scatter to the target
// replaces the TPU's monotone routing, as in the Pallas kernel.
//
// Bound on the H100: memory and latency. Per 400x640 frame stage A reads
// the u8 threshold and i32 rank planes once (~1.3 MB); stage B touches
// only the <= 4 x p_cap candidates and the K output words. Thinning needs
// a frame's total before any target is known, so each stage needs a
// barrier between its count and its write. Design: one launch, one
// thread-block cluster of C blocks per frame (grid (C, B); C = 16, a
// non-portable size the launcher opts in to), everything between the
// planes and the outputs in shared memory:
//   1. block r stages the threshold bytes and (rank > 0) bytes of pixels
//      [r*span, (r+1)*span) and of the row below them in its shared
//      memory (independent 16-byte loads: each plane byte or rank read
//      once), computes their bits four pixels a word (__vadd4,
//      __vcmpeq4), overwrites the staged threshold bytes with them and
//      counts the emitting pixels per warp and chunk;
//   2. cluster.sync(); every block reads the C block totals over DSMEM:
//      its pixel offset and the frame total T_A, hence the ratio;
//   3. stage-A write: each kept pixel's word goes to its target in pm,
//      which lies in slices of `slice` slots over the C blocks' shared
//      memory (written remotely through DSMEM); the written slots are
//      exactly [0, kept(T_A));
//   4. cluster.sync(); block r takes its C-th share of [0, kept(T_A)),
//      cut at multiples of 4 (balanced however few pixels emit), reads it
//      over DSMEM and counts its candidates for each direction, per warp
//      and chunk;
//   5. cluster.sync(); the 4 x C counts give each (direction, block) its
//      offset in the dir-major order and the total T_B;
//   6. stage-B write: per chunk the targets of all four directions, then
//      every rank load the kept candidates need at once (the words are
//      recomputed from the rank plane at p and q), then key / pack2; the
//      blocks share the fill of [kept(T_B), k_cap); rank 0 writes
//      counts[b]; a last cluster.sync() keeps every block's shared memory
//      alive until read.
// Block-local order comes from per-warp counts (one __reduce_add_sync per
// warp and chunk of blockDim * 4 elements) scanned once per stage.
// Measured (scripts/mb_torch_frontend_phases.py, its clock build): with
// 8-block clusters and the ranks read where a direction could emit, the
// bit pass and the stage-A write took ~2/3 of the launch at B=4, on the
// 32 SMs that 4 clusters of 8 occupy.
//
// The launch plan (cluster, threads, span, slice, shared bytes) is
// ops/frontend_kernel.py boundary_plan's; rvt_boundary_compact takes it as
// given and checks only what the device and the kernel's layout require.
#include <atomic>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRankBits = 11;
constexpr int kKeyInvalid = 1 << 22;
constexpr int kItems = 4;            // consecutive elements per thread
constexpr int kPortableCluster = 8;  // the portable cluster size limit
constexpr int kMaxCluster = 16;      // the H100's, non-portable
constexpr int kMaxThreads = 1024;
// a block's dynamic shared memory, opted in: the 232,448 bytes of the
// H100 less 1 KB for the static warp sums of block_exclusive_scan
constexpr int kSmemLimit = 232448 - 1024;
constexpr int kTotals = 8;           // [0] stage-A total, [1..4] stage B
// staged threshold bytes past a block's span: the row below (< 1024) and
// the reach of bits4's word loads
constexpr int kStageHalo = 1056;
constexpr int kMaxDevices = 64;
constexpr int kClusterUnplaceable = -1;
constexpr unsigned kFull = 0xffffffffu;
// A measuring build (-DRVT_BOUNDARY_PHASE_CLOCKS, for
// scripts/mb_torch_frontend_phases.py only) adds each block's clock64()
// cycles per phase, taken by its thread 0, into g_phase_cycles.
#ifdef RVT_BOUNDARY_PHASE_CLOCKS
constexpr int kPhases = 8;
__device__ unsigned long long g_phase_cycles[kPhases];
#define PHASE_START long long phase_t = clock64()
#define PHASE_MARK(k)                                                   \
  do {                                                                  \
    if (threadIdx.x == 0) {                                             \
      const long long now = clock64();                                  \
      atomicAdd(&g_phase_cycles[(k) - 1],                               \
                (unsigned long long)(now - phase_t));                   \
      phase_t = now;                                                    \
    }                                                                   \
  } while (0)
#else
#define PHASE_START do {} while (0)
#define PHASE_MARK(k) do {} while (0)
#endif
__constant__ int kDx[4] = {1, 0, -1, 1};
__constant__ int kDy[4] = {0, 1, 1, 1};

__device__ __forceinline__ float thin_ratio(int total, int cap) {
  return fminf(1.0f, __fdiv_rn((float)(cap - 2), fmaxf((float)total, 1.0f)));
}

// keep iff floor((slot+1) r) > floor(slot r); *target = floor(slot r)
__device__ __forceinline__ bool thin_keep(int slot, float r, int* target) {
  const float s = (float)slot;
  const float here = floorf(__fmul_rn(s, r));
  const float next = floorf(__fmul_rn(__fadd_rn(s, 1.0f), r));
  *target = (int)here;
  return next > here;
}

__device__ __forceinline__ int kept_total(int total, int cap) {
  return (int)floorf(__fmul_rn((float)total, thin_ratio(total, cap)));
}


// The 4 bytes of a staged byte array from index k on (k % 4 == S), read
// as aligned words: S is (w - 1) % 4 for the row below, the same for every
// pixel of the frame (spans start at multiples of 16).
template <int S>
__device__ __forceinline__ uint32_t bytes_at(const uint32_t* a, int k) {
  const uint32_t w0 = a[k >> 2];
  if (S == 0) return w0;
  return __funnelshift_r(w0, a[(k >> 2) + 1], 8 * S);
}

// BlobDiff bits (quadfit.boundary_masks) of the 4 pixels p = lo + i ..
// p + 3 (i % 4 == 0), byte j for pixel p + j: bit d where direction d
// emits (v + nv == 255 and both blobs big), bit 4 + d where also nv > v;
// interior pixels below `owned` only. tb holds the block's threshold
// bytes and big its (rank > 0) bytes (0 or 1), both from pixel lo on.
// Four pixels at once: __vadd4 wraps per byte, and v + nv <= 510, so a
// byte sum of 0xFF means 255.
template <int S>
__device__ __forceinline__ uint32_t bits4(const uint8_t* tb,
                                          const uint8_t* big, int i, int p,
                                          int owned, int h, int w) {
  const uint32_t* tw = reinterpret_cast<const uint32_t*>(tb);
  const uint32_t* bw = reinterpret_cast<const uint32_t*>(big);
  const uint32_t v = tw[i >> 2], bv = bw[i >> 2];
  // neighbours toward directions 0..3: right, below, below-left,
  // below-right (row below from i + w - 1, whose offset in its word is S)
  const int k = i + w - 1;
  const uint32_t nv[4] = {__funnelshift_r(v, tw[(i >> 2) + 1], 8),
                          bytes_at<(S + 1) & 3>(tw, k + 1),
                          bytes_at<S>(tw, k), bytes_at<(S + 2) & 3>(tw, k + 2)};
  const uint32_t nb[4] = {__funnelshift_r(bv, bw[(i >> 2) + 1], 8),
                          bytes_at<(S + 1) & 3>(bw, k + 1),
                          bytes_at<S>(bw, k), bytes_at<(S + 2) & 3>(bw, k + 2)};
  uint32_t out = 0;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const uint32_t ok = __vcmpeq4(__vadd4(v, nv[d]), 0xFFFFFFFFu) & bv & nb[d];
    out |= ok << d | (ok & __vcmpgtu4(nv[d], v)) << (4 + d);
  }
  int y = p / w, x = p - y * w;
  uint32_t inner = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < owned && y >= 1 && y <= h - 2 && x >= 1 && x <= w - 2)
      inner |= 0xFFu << (8 * j);
    if (++x == w) { x = 0; ++y; }
  }
  return out & inner;
}

// Exclusive prefix of a[0..len) in shared memory, in place; returns the
// total. Every thread of the block must call it; on return every thread
// sees every entry.
__device__ int scan_shared(int* a, int len) {
  int carry = 0;
  for (int base = 0; base < len; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < len ? a[i] : 0;
    int tot;
    const int ex = rvt::block_exclusive_scan(v, &tot);
    if (i < len) a[i] = carry + ex;
    carry += tot;
  }
  __syncthreads();
  return carry;
}

// exclusive prefix of v over the warp's lanes
__device__ __forceinline__ int warp_exclusive(int v) {
  const int lane = threadIdx.x & 31;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x - v;
}

// number of bytes of m whose low nibble is not 0
__device__ __forceinline__ int emitting(uint32_t m) {
  return __popc(__vcmpgtu4(m & 0x0F0F0F0Fu, 0) & 0x01010101u);
}

// Phase 1 after the staging: the bits of 2 chunks at a time from shared
// memory; they overwrite the staged threshold bytes of their own pixels,
// which no later chunk reads (every direction points forward); per-warp
// counts of the emitting pixels into wca.
template <int S>
__device__ __forceinline__ void bits_pass(uint8_t* tb, const uint8_t* big,
                                          int* wca, int lo, int owned,
                                          int span, int nca, int h, int w) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int chunk = blockDim.x * kItems;
  for (int c = 0; c < nca; c += 2) {
    uint32_t m[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i0 = (c + u) * chunk + tid * kItems;
      m[u] = c + u < nca && i0 < owned
          ? bits4<S>(tb, big, i0, lo + i0, owned - i0, h, w) : 0;
    }
    __syncthreads();      // every read of these chunks' staged bytes done
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i0 = (c + u) * chunk + tid * kItems;
      if (c + u < nca) {
        if (i0 < span) *reinterpret_cast<uint32_t*>(tb + i0) = m[u];
        const int cnt = __reduce_add_sync(kFull, emitting(m[u]));
        if (lane == 0) wca[(c + u) * nw + wid] = cnt;
      }
    }
  }
}

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// Stage-B chunks a block may take: its share of [0, kept(T_A)), cut at
// multiples of 4, is at most slice + 4 slots (kept(T_A) <= pc).
__host__ __device__ constexpr int b_chunks(int threads, int slice) {
  return ceil_div(slice + 4, threads * kItems);
}

// The shared-memory bytes of a plan: pm slice, per-warp counts of stage A
// and stage B, the totals, then the staged threshold bytes (which become
// the bit bytes) and (rank > 0) bytes of the block's pixels and of the
// row below them.
__host__ __device__ constexpr int smem_need(int threads, int span,
                                            int slice) {
  return 4 * (slice + ceil_div(span, threads * kItems) * (threads / 32)
              + 4 * b_chunks(threads, slice) * (threads / 32) + kTotals)
      + 2 * (span + kStageHalo);
}

__global__ void __launch_bounds__(kMaxThreads, 1)
    boundary_cluster_kernel(const uint8_t* __restrict__ thr,
                            const int* __restrict__ ranks,
                            int* __restrict__ key, int* __restrict__ pack2,
                            int* __restrict__ counts, int h, int w, int pc,
                            int k_cap, int span, int slice) {
  extern __shared__ __align__(16) unsigned char smem[];
  PHASE_START;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c_blocks = (int)cluster.num_blocks();
  const int b = blockIdx.y;
  const int n = h * w;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int chunk = blockDim.x * kItems;
  const int nca = ceil_div(span, chunk);
  const int ncb = b_chunks(blockDim.x, slice);
  int* pm = reinterpret_cast<int*>(smem);
  int* wca = pm + slice;
  int* wcb = wca + nca * nw;
  int* tot = wcb + 4 * ncb * nw;
  uint8_t* tb = reinterpret_cast<uint8_t*>(tot + kTotals);
  uint8_t* big = tb + span + kStageHalo;
  const uint8_t* t = thr + (size_t)b * n;
  const int* r = ranks + (size_t)b * n;
  const int lo = rank * span;
  const int owned = max(0, min(span, n - lo));   // pixels of this block

  // 1. stage the threshold bytes and the (rank > 0) bytes of the block's
  // pixels and of the row below them: every load independent, 16 bytes
  // a thread where the frame is 16-byte aligned; then the bits
  {
    const int len = max(0, min(span + kStageHalo, n - lo));
    const uint8_t* src = t + lo;
    int k0 = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      for (int k = tid; k < len >> 4; k += blockDim.x)
        reinterpret_cast<uint4*>(tb)[k] =
            __ldg(reinterpret_cast<const uint4*>(src) + k);
      k0 = len & ~15;
    }
    for (int k = k0 + tid; k < len; k += blockDim.x) tb[k] = src[k];
    const int* rs = r + lo;
    k0 = 0;
    if ((reinterpret_cast<uintptr_t>(rs) & 15) == 0) {
      for (int k = tid; k < len >> 2; k += blockDim.x) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(rs) + k);
        reinterpret_cast<uint32_t*>(big)[k] = (q.x > 0) | (q.y > 0) << 8
            | (q.z > 0) << 16 | (uint32_t)(q.w > 0) << 24;
      }
      k0 = len & ~3;
    }
    for (int k = k0 + tid; k < len; k += blockDim.x) big[k] = rs[k] > 0;
  }
  __syncthreads();
  PHASE_MARK(1);
  switch ((w - 1) & 3) {
    case 0: bits_pass<0>(tb, big, wca, lo, owned, span, nca, h, w); break;
    case 1: bits_pass<1>(tb, big, wca, lo, owned, span, nca, h, w); break;
    case 2: bits_pass<2>(tb, big, wca, lo, owned, span, nca, h, w); break;
    default: bits_pass<3>(tb, big, wca, lo, owned, span, nca, h, w);
  }
  PHASE_MARK(2);
  __syncthreads();
  const int block_a = scan_shared(wca, nca * nw);
  if (tid == 0) tot[0] = block_a;
  cluster.sync();
  PHASE_MARK(3);

  // 2. the C block totals: this block's offset and the frame total
  int total_a, off_a;
  {
    const int v = lane < c_blocks ? *cluster.map_shared_rank(tot, lane) : 0;
    total_a = __reduce_add_sync(kFull, v);
    off_a = __reduce_add_sync(kFull, lane < rank ? v : 0);
  }
  const float ra = thin_ratio(total_a, pc);
  const int kept_a = kept_total(total_a, pc);

  // 3. stage-A write: each kept pixel's word to its target slot in pm
  for (int c = 0; c < nca; ++c) {
    const int i0 = c * chunk + tid * kItems;
    const uint32_t m4 = i0 < span
        ? *reinterpret_cast<const uint32_t*>(tb + i0) : 0;
    const int cnt = emitting(m4);
    int slot = off_a + wca[c * nw + wid] + warp_exclusive(cnt);
    if (cnt == 0) continue;
    const int p0 = lo + i0;
    int y = p0 / w, x = p0 - y * w;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const uint32_t m = (m4 >> (8 * j)) & 0xFF;
      int tgt;
      if ((m & 0xF) && thin_keep(slot++, ra, &tgt)) {
        const int s = tgt / slice;
        cluster.map_shared_rank(pm, s)[tgt - s * slice] =
            (int)((((uint32_t)y << 11 | x) << 8) | m);
      }
      if (++x == w) { x = 0; ++y; }
    }
  }
  PHASE_MARK(4);
  cluster.sync();
  PHASE_MARK(5);

  // 4. stage B: the valid slots are exactly [0, kept(T_A)); block r takes
  // [b_lo, b_hi), its C-th share cut at multiples of 4, reading pm over
  // DSMEM; its candidates counted per direction, warp and chunk
  const int b_lo = (int)((long long)rank * kept_a / c_blocks) & ~3;
  const int b_hi = rank + 1 == c_blocks
      ? kept_a : (int)((long long)(rank + 1) * kept_a / c_blocks) & ~3;
  auto pm_word4 = [&](int i0) -> int4 {
    const int g = b_lo + i0;
    const int s = g / slice;
    return *reinterpret_cast<const int4*>(
        cluster.map_shared_rank(pm, s) + (g - s * slice));
  };
  for (int c = 0; c < ncb; ++c) {
    const int i0 = c * chunk + tid * kItems;
    int cd[4] = {0, 0, 0, 0};
    if (b_lo + i0 < b_hi) {
      const int4 q = pm_word4(i0);
      const int vs[kItems] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        if (b_lo + i0 + j < b_hi) {
#pragma unroll
          for (int d = 0; d < 4; ++d) cd[d] += (vs[j] >> d) & 1;
        }
    }
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int s = __reduce_add_sync(kFull, cd[d]);
      if (lane == 0) wcb[(d * ncb + c) * nw + wid] = s;
    }
  }
  __syncthreads();
  // one scan over the direction-major counts; direction d's count is the
  // difference of the prefixes at its two ends
  const int seg = ncb * nw;
  const int block_b = scan_shared(wcb, 4 * seg);
  if (tid < 4)
    tot[1 + tid] = (tid == 3 ? block_b : wcb[(tid + 1) * seg]) - wcb[tid * seg];
  cluster.sync();
  PHASE_MARK(6);

  // 5. lane q of every warp reads block q's four counts: each direction's
  // total and its count in the blocks before this one
  int off_b[4], total_b = 0;
  {
    const int* their = lane < c_blocks ? cluster.map_shared_rank(tot, lane)
                                       : nullptr;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int v = their ? their[1 + d] : 0;
      off_b[d] = total_b + __reduce_add_sync(kFull, lane < rank ? v : 0);
      total_b += __reduce_add_sync(kFull, v);
    }
  }
  const float rb = thin_ratio(total_b, k_cap);
  const int kept_b = kept_total(total_b, k_cap);

  // 6. stage-B write: per chunk the targets of all four directions first,
  // then every rank load the kept candidates need at once, then the words
  int* key_b = key + (size_t)b * k_cap;
  int* pack_b = pack2 + (size_t)b * k_cap;
  for (int c = 0; c < ncb; ++c) {
    const int i0 = c * chunk + tid * kItems;
    int vs[kItems] = {0, 0, 0, 0};
    if (b_lo + i0 < b_hi) {
      const int4 q = pm_word4(i0);
      vs[0] = q.x; vs[1] = q.y; vs[2] = q.z; vs[3] = q.w;
    }
    int tgt[4][kItems];
    unsigned kept = 0;                        // bit 4 * d + j
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      int ok = 0;
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        ok |= (b_lo + i0 + j < b_hi && ((vs[j] >> d) & 1)) << j;
      int slot = off_b[d] + wcb[(d * ncb + c) * nw + wid] - wcb[d * seg]
          + warp_exclusive(__popc(ok));
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        if (((ok >> j) & 1) && thin_keep(slot++, rb, &tgt[d][j]))
          kept |= 1u << (4 * d + j);
    }
    if (kept == 0) continue;
    int rp[kItems], rq[4][kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int p = ((vs[j] >> 19) & 0x7FF) * w + ((vs[j] >> 8) & 0x7FF);
      rp[j] = (kept >> j) & 0x1111u ? __ldg(r + p) : 0;
#pragma unroll
      for (int d = 0; d < 4; ++d)
        rq[d][j] = (kept >> (4 * d + j)) & 1
            ? __ldg(r + p + kDy[d] * w + kDx[d]) : 0;
    }
#pragma unroll
    for (int d = 0; d < 4; ++d) {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (!((kept >> (4 * d + j)) & 1)) continue;
        const int word = vs[j];
        const int py = (word >> 19) & 0x7FF;
        const int px = (word >> 8) & 0x7FF;
        const int g = ((word >> (4 + d)) & 1) ? 1 : -1;
        const int lo_r = min(rp[j], rq[d][j]) - 1;
        const int hi_r = max(rp[j], rq[d][j]) - 1;
        key_b[tgt[d][j]] = (lo_r << kRankBits) | hi_r;
        pack_b[tgt[d][j]] = ((2 * px + kDx[d]) << 15)
            | ((2 * py + kDy[d]) << 4) | ((kDx[d] * g + 1) << 2)
            | (kDy[d] * g + 1);
      }
    }
  }
  PHASE_MARK(7);
  for (int i = kept_b + rank * blockDim.x + tid; i < k_cap;
       i += c_blocks * blockDim.x) {
    key_b[i] = kKeyInvalid;
    pack_b[i] = 0;
  }
  if (rank == 0 && tid == 0) counts[b] = kept_b;
  cluster.sync();
  PHASE_MARK(8);
}

// Once per process, device and cluster size: the shared-memory opt-in
// (and, past the portable 8 blocks, the non-portable cluster size), and
// that the device can place such a cluster with the most shared memory
// asked for so far.
int prepare(int device, const cudaLaunchConfig_t& cfg, int cluster) {
  static std::atomic<int> placed[kMaxDevices][kMaxCluster + 1];
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const int smem = (int)cfg.dynamicSmemBytes;
  if (placed[device][cluster].load(std::memory_order_acquire) >= smem)
    return 0;
  cudaError_t err = cudaFuncSetAttribute(
      boundary_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemLimit);
  if (err == cudaSuccess && cluster > kPortableCluster)
    err = cudaFuncSetAttribute(boundary_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t one = cfg;
  one.gridDim = dim3(cluster, 1, 1);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, boundary_cluster_kernel,
                                       &one);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return kClusterUnplaceable;
  placed[device][cluster].store(smem, std::memory_order_release);
  return 0;
}

}  // namespace

// thr (B, H, W) u8, ranks (B, H, W) i32 -> key, pack2 (B, k_cap) i32 and
// counts (B,); pc is the stage-A cap in slots (boundary_block_rows * W);
// cluster, threads, span, slice and smem the plan of
// ops/frontend_kernel.py boundary_plan. *launches receives the number of
// kernel launches made. Returns a cudaError_t, or -1 when the device
// cannot place the cluster.
extern "C" int rvt_boundary_compact(const uint8_t* thr, const int* ranks,
                                    int* key, int* pack2, int* counts,
                                    int* launches, int b, int h, int w,
                                    int pc, int k_cap, int cluster,
                                    int threads, int span, int slice,
                                    int smem, int device,
                                    cudaStream_t stream) {
  *launches = 0;
  cudaSetDevice(device);
  if (b == 0) return 0;
  // 11-bit coordinates; every pixel in one block's span and every slot in
  // one block's slice; whole warps; the counts' int4 loads need slices of
  // whole int4s and the bits' word stores spans of whole 16-byte groups
  if (b < 0 || b > 65535 || h < 1 || w < 1 || 2 * w >= 2048 ||
      2 * h >= 2048 || pc < 1 || k_cap < 1 || cluster < 1 ||
      cluster > kMaxCluster || threads < 32 || threads % 32 != 0 ||
      threads > kMaxThreads || span < 16 || span % 16 != 0 ||
      (long long)span * cluster < (long long)h * w || slice < 4 ||
      slice % 4 != 0 || (long long)slice * cluster < pc ||
      smem != smem_need(threads, span, slice) || smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, b, 1);
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
  const int err = prepare(device, cfg, cluster);
  if (err != 0) return err;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, boundary_cluster_kernel, thr, ranks, key, pack2, counts, h, w,
      pc, k_cap, span, slice);
  *launches = rc == cudaSuccess;
  return (int)rc;
}

#ifdef RVT_BOUNDARY_PHASE_CLOCKS
extern "C" const char* rvt_boundary_phase_names() {
  return "stage,bits,scan_a+sync,write_a,sync,count_b+sync,write_b,"
         "fill+sync";
}

// The cycles summed since the last read into out[kPhases]; zeroes them.
extern "C" int rvt_boundary_phase_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles,
                                         sizeof(g_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kPhases] = {};
  return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
}
#endif

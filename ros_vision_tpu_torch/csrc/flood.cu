// K6 propagate_fixpoint, K7 label_histogram and K8 propagate: the flood CCL
// of ros_vision_tpu/ops/ccl.py (label_components_flood, flood_ranks,
// label_components_hybrid).
//
// K6 replaces ros_vision_tpu/ops/ccl_pallas.py propagate_fixpoint
// (pallas_call at :312, kernel body _make_fix_kernel:263): min-flood of
// int32 `values` over the threshold image's connectivity (4-way for 0,
// 8-way for 255, 127 isolated) to fixpoint. At the fixpoint every pixel
// holds min(its component's minimum value, 2^30): every masked-out
// neighbour offers _BIG = 2^30, and every component has a pixel with one.
// The TPU floods (~287 sweeps on a noisy 400x640 frame, ccl.py:248-250)
// because it has no atomics. Bound on the H100: latency of the
// union-find's dependent reads and atomics on shared roots (the bytes are
// ~6 us at B=4 960x540). Design: the two-level union-find of unionfind.cuh
// (tiles in shared memory, global atomics only at tile borders; 3
// launches) labels the pixels and takes the per-root minimum of `values`
// in its finalize launch (per tile and slot in shared memory, lanes of a
// warp that share a slot reduced with __reduce_min_sync first, then one
// global atomicMin per tile and component, into a table the first launch
// set to INT32_MAX at the tile-local roots); a fourth launch broadcasts
// out[p] = min(rootmin[label[p]], 2^30). Integer min is order-free, so
// the result is exact. Neither INT32_MAX (which label_components_flood
// floods for non-roots) nor 2^30 is a sentinel here: both are values.
// Measured (scripts/mb_torch_ccl_phases.py, NVIDIA H100 80GB HBM3,
// 700.00 W, B=4 960x540 bench planes, device ms summed over the launches):
// the one-level union-find of the earlier design took 0.477 in 6
// launches, 0.391 of it in its merge launch (1.6 finds and 8.4 hops a
// pixel, up to 184 hops in one find) and 0.044 in its warp-aggregated
// atomicMin launch; this design 0.073 in 4: tile 0.033, border 0.008,
// finalize 0.024, broadcast 0.008.
//
// K7 replaces ccl_pallas.py label_histogram (pallas_call at :376, kernel
// body _make_hist_kernel:339): counts[b, v] = #(labels[b] == v) for v in
// [0, N); labels outside [0, N) are not counted. The TPU builds one-hot
// planes and multiplies them on the MXU because it has no scatter-add.
// Bound on the H100: the bytes (the labels read and the counts written
// once, 5.0 us at B=4 960x540), while the global atomics stay few. The
// earlier design, a memset and one atomicAdd per warp group of equal
// labels, made 1.56 M global atomics on the 960x540 bench labels: 70% of
// them are distinct, since every 127 pixel is its own component (measured
// by scripts/mb_torch_flood_phases.py, NVIDIA H100 80GB HBM3, 700.00 W:
// memset 0.0030 ms, atomics 0.0180 ms). Design: one cooperative launch,
// blocks taking chunks of 8192 labels, a thread 16 consecutive labels
// (16-byte loads) collapsed to runs of equal keys (row * N + label). A run
// whose key lies in its own chunk adds to a shared window of the chunk's
// counts (a spare word after every 16 puts the lanes of a warp on 32
// banks), which the block stores as its part of the output: each output is
// written once, so no memset. After the grid barrier, the runs of keys in
// other chunks (the roots of components that reach back) add to the
// output with global atomics: a thread sums the runs of its first such
// key, and the lanes of a warp whose first keys agree (found by ballot)
// add their sums with one atomic; the thread's other such runs add one
// each. Measured after (same script and card, bench labels): 0.0117 ms
// in one launch, 68,916 global atomics (943 on one address); cycles a
// block: chunks 7,730, wait at the barrier 4,321, far runs 7,037.
//
// K8 replaces ccl_pallas.py propagate (pallas_call at :405, kernel body
// _kernel:49): exactly n_sweeps Jacobi sweeps of the masked 8-neighbour
// min, each reading only the previous sweep's labels (a masked-out
// neighbour offers 2^30). The TPU keeps the image in VMEM and sweeps
// in-kernel. Bound on the H100: the sweeps' integer work, 8 neighbour
// mins a pixel and sweep (0.22 ms for 448 sweeps at 640x400 B=4 on the
// INT32 pipe), while the labels stay on chip. The earlier design, one
// launch a sweep through L2, took 7.3 us a sweep. Design: rounds of 8
// sweeps (ops/ccl_kernel.py propagate_plan), one launch each; a block
// keeps an 80x112 tile and a halo of 8 in shared memory and sweeps
// between two buffers, the valid area shrinking by one pixel a sweep. A
// thread walks a column of 12 pixels with the rows above and below in
// registers, so a sweep reads three cells a pixel. A region of {0, 127,
// 255} (every threshold image) is kept as two planes, the labels of its
// 255 pixels and of its 0 pixels with 2^30 elsewhere, so that a sweep
// needs no eligibility bits: a 255 pixel takes the min of its 3x3 of the
// first plane, a 0 pixel of its cross in the second and 2^30, each a min
// of row mins (__vimin3_s32). Any other region sweeps one plane with the
// eight bits per pixel. Its shared-memory traffic (three 8-byte loads and
// one store a pixel) bounds a sweep. Measured
// (scripts/mb_torch_flood_phases.py, NVIDIA H100 80GB HBM3, 700.00 W, 448
// sweeps at 640x400 B=4 bench planes): before, a mask launch and 448
// sweep launches, 3.2965 ms summed; after, 56 launches, 1.2626 ms summed,
// a round's cycles a block: load 8,175, 8 sweeps 29,241, write-back
// 4,583. The masked path alone for every region (commit a0139f9: 4-byte
// cells, all loads in flight) took 1.4344-1.4348 ms device against the
// two planes' 1.3199-1.3228 in turns (scripts/mb_torch_kernel_versions.py,
// same card), its 8 sweeps 37,523 cycles a round: its eight selects a
// pixel cost more issue slots than the planes' 8-byte loads cost
// shared-memory wavefronts.
#include <atomic>
#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "unionfind.cuh"

// -DRVT_HIST_COUNT_ATOMICS (a counting build, off by default; see
// scripts/mb_torch_flood_phases.py): every global atomicAdd of K7 also
// adds one to its address's count, and rvt_label_histogram_atomics(out)
// returns the atomics, the most on one address and the addresses hit
// since the last read (labels of up to kHitSlots keys).
#ifdef RVT_HIST_COUNT_ATOMICS
constexpr int kHitSlots = 1 << 22;
__device__ unsigned g_hist_hits[kHitSlots];
__device__ __forceinline__ void count_atomic(int key) {
  if (key < kHitSlots) atomicAdd(&g_hist_hits[key], 1u);
}
extern "C" int rvt_label_histogram_atomics(unsigned long long* out) {
  unsigned* hits = new unsigned[kHitSlots];
  cudaError_t e = cudaMemcpyFromSymbol(hits, g_hist_hits,
                                       sizeof(unsigned) * kHitSlots);
  unsigned long long total = 0, most = 0, addresses = 0;
  for (int i = 0; i < kHitSlots && e == cudaSuccess; ++i) {
    total += hits[i];
    most = hits[i] > most ? hits[i] : most;
    addresses += hits[i] != 0;
  }
  delete[] hits;
  out[0] = total;
  out[1] = most;
  out[2] = addresses;
  void* sym = nullptr;
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&sym, g_hist_hits);
  if (e == cudaSuccess) e = cudaMemset(sym, 0, sizeof(unsigned) * kHitSlots);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}
#else
__device__ __forceinline__ void count_atomic(int) {}
#endif

// -DRVT_FLOOD_PHASE_CLOCKS (a timing build, off by default; see
// scripts/mb_torch_flood_phases.py): thread 0 of each block of K7 (set 0)
// and K8 (set 1) adds the clock cycles of the kernel's three phases and
// counts the blocks; rvt_flood_clocks(out) returns, per set, the three
// sums, the blocks, and the first start and the last end on the global
// timer (ns) since the last read. K7's phases: its chunks; the wait at
// the grid barrier; the far runs. K8's: the load of the region; the
// sweeps; the write-back.
#ifdef RVT_FLOOD_PHASE_CLOCKS
constexpr int kClockStats = 6;
__device__ unsigned long long g_flood_clocks[2][kClockStats];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// phase 0 starts the block's clock; phases 1-3 add the cycles since the
// last call to sum phase - 1, and phase 3 ends the block
__device__ __forceinline__ void phase_clock(int set, int phase,
                                            long long& since) {
  if (threadIdx.x != 0) return;
  const long long now = clock64();
  unsigned long long* c = g_flood_clocks[set];
  if (phase == 0) {
    atomicMin(&c[4], global_ns());
  } else {
    atomicAdd(&c[phase - 1], (unsigned long long)(now - since));
  }
  if (phase == 3) {
    atomicAdd(&c[3], 1ull);
    atomicMax(&c[5], global_ns());
  }
  since = now;
}
extern "C" int rvt_flood_clocks(unsigned long long* out) {
  unsigned long long zero[2][kClockStats] = {{0, 0, 0, 0, ~0ull, 0},
                                             {0, 0, 0, 0, ~0ull, 0}};
  cudaError_t e = cudaMemcpyFromSymbol(out, g_flood_clocks, sizeof(zero));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(g_flood_clocks, zero, sizeof(zero));
}
#define RVT_PHASE_SYNC() __syncthreads()
#else
__device__ __forceinline__ void phase_clock(int, int, long long&) {}
#define RVT_PHASE_SYNC()
#endif

namespace {

constexpr int kBig = 1 << 30;          // ccl_pallas._BIG
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

__global__ void root_broadcast_kernel(const int* __restrict__ labels,
                                      const int* __restrict__ rootmin,
                                      int* out, int n, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  out[i] = min(rootmin[(size_t)(i / n) * n + labels[i]], kBig);
}

// K7: one chunk of kHistChunk labels at a time per block; see the note at
// the top.
constexpr int kHistThreads = 512;
constexpr int kHistItems = 16;                 // consecutive labels a thread
constexpr int kHistChunk = kHistThreads * kHistItems;
constexpr unsigned kFull = 0xffffffffu;
// the chunk's counts in shared memory, a spare word after every 16, so
// that the lanes of a warp, each at item e of its 16, add to 32 banks
constexpr int kHistWindow = kHistChunk + kHistChunk / 16;
constexpr int kHistSmem = 4 * kHistWindow;

// The keys (row * n + label, -1 for a label outside [0, n) or an item
// past the end) of a thread's kHistItems labels from flat index i0, and
// the items where a run of equal keys ends.
template <bool kVec>
__device__ __forceinline__ unsigned load_keys(const int* __restrict__ labels,
                                              int i0, int n, int total,
                                              int (&key)[kHistItems]) {
  if (kVec && i0 + kHistItems <= total) {
    const int4* p = reinterpret_cast<const int4*>(labels + i0);
#pragma unroll
    for (int j = 0; j < kHistItems / 4; ++j) {
      const int4 v = __ldg(p + j);
      key[4 * j] = v.x;
      key[4 * j + 1] = v.y;
      key[4 * j + 2] = v.z;
      key[4 * j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kHistItems; ++e)
      key[e] = i0 + e < total ? __ldg(labels + i0 + e) : -1;
  }
  if (i0 < total && n >= kHistItems) {
    // the items span at most one row boundary
    const int row = i0 / n;
    const int next = (row + 1) * n;
#pragma unroll
    for (int e = 0; e < kHistItems; ++e) {
      const int base = i0 + e < next ? row * n : next;
      key[e] = (unsigned)key[e] < (unsigned)n ? base + key[e] : -1;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kHistItems; ++e)
      key[e] = i0 + e < total && (unsigned)key[e] < (unsigned)n
                   ? (i0 + e) / n * n + key[e]
                   : -1;
  }
  unsigned ends = 0;
#pragma unroll
  for (int e = 0; e < kHistItems; ++e)
    ends |= (unsigned)(e == kHistItems - 1 || key[e] != key[e + 1]) << e;
  return ends;
}

__device__ __forceinline__ int run_length(unsigned ends, int e) {
  const unsigned before = ends & ((1u << e) - 1);
  return e - (before ? 31 - __clz(before) : -1);
}

// The runs of a thread whose keys lie outside its chunk [c0, c0 +
// kHistChunk) (far runs: a component whose root is in another chunk),
// added to counts. The thread sums the runs of its first far key (a
// large component, where one is, takes most of them), and the lanes of a
// warp whose first keys agree add their sums with one atomicAdd; the
// thread's other far runs add one each.
__device__ __forceinline__ void add_far_runs(const int (&key)[kHistItems],
                                             unsigned ends, int c0,
                                             int* counts) {
  int first = -1, sum = 0;
  unsigned rest = 0;
#pragma unroll
  for (int e = 0; e < kHistItems; ++e) {
    const int k = key[e];
    if ((ends >> e) & 1u && k >= 0 &&
        (unsigned)(k - c0) >= (unsigned)kHistChunk) {
      if (first < 0 || k == first) {
        first = k;
        sum += run_length(ends, e);
      } else {
        rest |= 1u << e;
      }
    }
  }
  // the lanes' first keys, one key of the warp at a time (the lowest
  // lane's with one left)
  const int lane = threadIdx.x & 31;
  for (unsigned left = __ballot_sync(kFull, first >= 0); left;) {
    const int leader = __ffs(left) - 1;
    const int k = __shfl_sync(kFull, first, leader);
    const bool mine = first == k;
    const int total = __reduce_add_sync(kFull, mine ? sum : 0);
    if (lane == leader) {
      atomicAdd(counts + k, total);
      count_atomic(k);
    }
    left &= ~__ballot_sync(kFull, mine);
  }
#pragma unroll
  for (int e = 0; e < kHistItems; ++e)
    if ((rest >> e) & 1u) {
      atomicAdd(counts + key[e], run_length(ends, e));
      count_atomic(key[e]);
    }
}

template <bool kVec>
__global__ void __launch_bounds__(kHistThreads)
label_hist_kernel(const int* __restrict__ labels, int* counts, int n,
                  int total, int chunks) {
  long long since = 0;
  phase_clock(0, 0, since);
  extern __shared__ int win[];
  // 1. each chunk: its keys' counts by shared atomics in the window, one
  // add a run, stored into counts (every output written once, by the
  // block of its chunk); the last chunk's labels stay in registers
  int key[kHistItems];
  unsigned ends = 0;
  int c0 = 0;
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    c0 = c * kHistChunk;
    for (int i = threadIdx.x; i < kHistWindow; i += kHistThreads) win[i] = 0;
    ends = load_keys<kVec>(labels, c0 + threadIdx.x * kHistItems, n, total,
                           key);
    __syncthreads();                             // the window is clear
#pragma unroll
    for (int e = 0; e < kHistItems; ++e) {
      const int o = key[e] - c0;
      if ((ends >> e) & 1u && (unsigned)o < (unsigned)kHistChunk)
        atomicAdd(win + o + (o >> 4), run_length(ends, e));
    }
    __syncthreads();
    const int m = min(kHistChunk, total - c0);
    if (m == kHistChunk) {
      int4* out = reinterpret_cast<int4*>(counts + c0);
      for (int i = threadIdx.x; i < kHistChunk / 4; i += kHistThreads) {
        const int* from = win + 4 * i + (i >> 2);   // 4 words of one 16
        out[i] = make_int4(from[0], from[1], from[2], from[3]);
      }
    } else {
      for (int i = threadIdx.x; i < m; i += kHistThreads)
        counts[c0 + i] = win[i + (i >> 4)];
    }
    __syncthreads();                             // before the window clears
  }
  // 2. every chunk's counts are stored: add the far runs, the last
  // chunk's from registers, the block's earlier chunks' read again
  phase_clock(0, 1, since);
  cooperative_groups::this_grid().sync();
  phase_clock(0, 2, since);
  add_far_runs(key, ends, c0, counts);
  for (int c = blockIdx.x; c + (int)gridDim.x < chunks; c += gridDim.x) {
    const int c1 = c * kHistChunk;
    ends = load_keys<kVec>(labels, c1 + threadIdx.x * kHistItems, n, total,
                           key);
    add_far_runs(key, ends, c1, counts);
  }
  RVT_PHASE_SYNC();
  phase_clock(0, 3, since);
}

// K8: one launch a round of at most `halo` sweeps; one block a tile of
// tile_h x tile_w pixels and a halo of `halo` pixels on each side,
// kPropRows rows of one column a thread; see the note at the top.
constexpr int kPropRows = 12;        // propagate_plan's PROPAGATE_ROWS
constexpr int kPropThreads = 1024;   // propagate_plan's threads
// a thread's cells of the region, at most: every load is in flight at once
constexpr int kPropLoadSteps = 13;
static_assert(kPropRows % 4 == 0 && kPropRows <= 16,
              "a thread's mask bytes and class bits fit its words");

// The region: the tile, the halo and a ring of one cell, `pitch` cells a
// row; the thread's column and first row (cell coordinates).
struct Region {
  int pitch, cells, y0, x0, col, row0;
  size_t base;
};

__device__ __forceinline__ Region region(int h, int w, int tile_h,
                                         int tile_w, int halo) {
  const int rw = tile_w + 2 * halo;
  Region g;
  g.pitch = rw + 2;
  g.cells = (tile_h + 2 * halo + 2) * g.pitch;
  g.y0 = blockIdx.y * tile_h - halo - 1;   // frame row of cell row 0
  g.x0 = blockIdx.x * tile_w - halo - 1;   // frame column of cell column 0
  g.col = threadIdx.x % rw + 1;
  g.row0 = threadIdx.x / rw * kPropRows + 1;
  g.base = (size_t)blockIdx.z * h * w;
  return g;
}

// Row and column of flat index i in rows of `width`, stepped on by
// kPropThreads without a division a step.
struct Walk {
  int r, c, dr, dc, width;
  __device__ Walk(int i, int width_)
      : r(i / width_), c(i % width_), dr(kPropThreads / width_),
        dc(kPropThreads % width_), width(width_) {}
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= width) {
      c -= width;
      ++r;
    }
  }
};

__device__ __forceinline__ int offer(unsigned bits, int k, int v) {
  return (bits >> k) & 1u ? v : kBig;
}

// Any threshold values: each pixel's eight eligibility bits from the
// staged threshold tb, then sweeps over one label plane between in and
// out. Returns the buffer that holds the last sweep.
__device__ int* sweep_masked(const Region& g, const uint8_t* tb, int* in,
                             int* out, int h, int w, int sweeps) {
  constexpr int dy[8] = {0, 0, -1, 1, -1, -1, 1, 1};
  constexpr int dx[8] = {-1, 1, 0, 0, -1, 1, -1, 1};
  // bit k of byte i % 4 of mw[i / 4]: neighbour k of the thread's pixel i
  // is in the frame and connected to it (ccl_pallas._OFFSETS order)
  unsigned mw[kPropRows / 4] = {};
#pragma unroll
  for (int i = 0; i < kPropRows; ++i) {
    const int r = g.row0 + i;
    const int y = g.y0 + r, x = g.x0 + g.col;
    const int v = tb[r * g.pitch + g.col];
    unsigned bits = 0;
    if (y >= 0 && y < h && x >= 0 && x < w && v != 127) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int ny = y + dy[k], nx = x + dx[k];
        const bool ok = ny >= 0 && ny < h && nx >= 0 && nx < w &&
                        tb[(r + dy[k]) * g.pitch + g.col + dx[k]] == v &&
                        (k < 4 || v == 255);
        bits |= (unsigned)ok << k;
      }
    }
    mw[i / 4] |= bits << (8 * (i % 4));
  }
  for (int s = 0; s < sweeps; ++s) {
    const int* p = in + (g.row0 - 1) * g.pitch + g.col;
    int aL = p[-1], aM = p[0], aR = p[1];
    p += g.pitch;
    int bL = p[-1], bM = p[0], bR = p[1];
    int* q = out + g.row0 * g.pitch + g.col;
#pragma unroll
    for (int i = 0; i < kPropRows; ++i) {
      p += g.pitch;
      const int cL = p[-1], cM = p[0], cR = p[1];
      const unsigned bits = mw[i / 4] >> (8 * (i % 4));
      // a masked-out neighbour offers 2^30, so a pixel with one also
      // takes min(., 2^30)
      q[i * g.pitch] = __vimin3_s32(
          __vimin3_s32(bM, offer(bits, 0, bL), offer(bits, 1, bR)),
          __vimin3_s32(offer(bits, 2, aM), offer(bits, 3, cM),
                       offer(bits, 4, aL)),
          __vimin3_s32(offer(bits, 5, aR), offer(bits, 6, cL),
                       offer(bits, 7, cR)));
      aL = bL; aM = bM; aR = bR;
      bL = cL; bM = cM; bR = cR;
    }
    __syncthreads();
    int* t = in;
    in = out;
    out = t;
  }
  return in;
}

// A {0, 127, 255} region in two planes: a cell's .x is its label where it
// is 255, its .y where it is 0, 2^30 elsewhere (127 pixels, cells off the
// frame). A 255 pixel's sweep is then the plain min of its 3x3 cells' .x,
// a 0 pixel's the min of its 4-neighbour cross's .y and 2^30: a neighbour
// that is not eligible offers 2^30 by itself, so the sweep needs no
// eligibility bits. Returns the buffer that holds the last sweep.
__device__ int2* sweep_planes(const Region& g, const uint8_t* tb, int2* in,
                              int2* out, int sweeps) {
  // 2 bits a pixel i of the thread: 1 for 255, 2 for 0, 0 otherwise
  unsigned cls = 0;
#pragma unroll
  for (int i = 0; i < kPropRows; ++i) {
    const int v = tb[(g.row0 + i) * g.pitch + g.col];
    cls |= (v == 255 ? 1u : v == 0 ? 2u : 0u) << (2 * i);
  }
  for (int s = 0; s < sweeps; ++s) {
    // per row of the thread's column: the min of the three cells' .x
    // (wa, wb, wc for the rows above, at and below the pixel), the same
    // of .y (kb) and the cell's own .y (ka above, km at the pixel); the
    // 3x3 min is then the min of three row mins
    const int2* p = in + (g.row0 - 1) * g.pitch + g.col;
    int wa = __vimin3_s32(p[-1].x, p[0].x, p[1].x);
    int ka = p[0].y;
    p += g.pitch;
    int2 m = p[0];
    int wb = __vimin3_s32(p[-1].x, m.x, p[1].x);
    int kb = __vimin3_s32(p[-1].y, m.y, p[1].y);
    int km = m.y;
    int2* q = out + g.row0 * g.pitch + g.col;
#pragma unroll
    for (int i = 0; i < kPropRows; ++i) {
      p += g.pitch;
      const int2 l = p[-1], r = p[1];
      m = p[0];
      const int wc = __vimin3_s32(l.x, m.x, r.x);
      const unsigned c = cls >> (2 * i);
      q[i * g.pitch] = make_int2(
          c & 1u ? __vimin3_s32(wa, wb, wc) : kBig,
          c & 2u ? min(__vimin3_s32(kb, ka, m.y), kBig) : kBig);
      wa = wb;
      wb = wc;
      ka = km;
      km = m.y;
      kb = __vimin3_s32(l.y, m.y, r.y);
    }
    __syncthreads();
    int2* t = in;
    in = out;
    out = t;
  }
  return in;
}

__global__ void __launch_bounds__(kPropThreads, 1)
propagate_tile_kernel(const uint8_t* __restrict__ thr,
                      const int* __restrict__ src, int* __restrict__ dst,
                      int h, int w, int tile_h, int tile_w, int halo,
                      int sweeps) {
  // two buffers of the region's cells, 8 bytes each, then the threshold
  extern __shared__ int2 cells2[];
  long long since = 0;
  phase_clock(1, 0, since);
  const Region g = region(h, w, tile_h, tile_w, halo);
  uint8_t* tb = reinterpret_cast<uint8_t*>(cells2 + 2 * g.cells);
  int lab[kPropLoadSteps], val[kPropLoadSteps];
  Walk at(threadIdx.x, g.pitch);
#pragma unroll
  for (int k = 0; k < kPropLoadSteps; ++k, at.next()) {
    const int y = g.y0 + at.r, x = g.x0 + at.c;
    const bool inside = threadIdx.x + k * kPropThreads < g.cells &&
                        y >= 0 && y < h && x >= 0 && x < w;
    const size_t p = g.base + (size_t)y * w + x;
    lab[k] = inside ? src[p] : kBig;
    val[k] = inside ? thr[p] : 127;
  }
  bool other = false;          // a value outside {0, 127, 255} in the region
#pragma unroll
  for (int k = 0; k < kPropLoadSteps; ++k) {
    const int i = threadIdx.x + k * kPropThreads;
    if (i < g.cells) {
      tb[i] = (uint8_t)val[k];
      other |= val[k] != 0 && val[k] != 127 && val[k] != 255;
    }
  }
  Walk t(threadIdx.x, tile_w);
  if (__syncthreads_or(other)) {
    // one plane of labels over the first buffer, masked sweeps
    int* in = reinterpret_cast<int*>(cells2);
#pragma unroll
    for (int k = 0; k < kPropLoadSteps; ++k) {
      const int i = threadIdx.x + k * kPropThreads;
      if (i < g.cells) in[i] = lab[k];
    }
    __syncthreads();
    const int* last = sweep_masked(g, tb, in, in + g.cells, h, w, sweeps);
    for (int i = threadIdx.x; i < tile_h * tile_w; i += kPropThreads,
             t.next()) {
      const int y = blockIdx.y * tile_h + t.r, x = blockIdx.x * tile_w + t.c;
      if (y < h && x < w)
        dst[g.base + (size_t)y * w + x] =
            last[(t.r + halo + 1) * g.pitch + t.c + halo + 1];
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kPropLoadSteps; ++k) {
    const int i = threadIdx.x + k * kPropThreads;
    if (i < g.cells)
      cells2[i] = make_int2(val[k] == 255 ? lab[k] : kBig,
                            val[k] == 0 ? lab[k] : kBig);
  }
  __syncthreads();
  phase_clock(1, 1, since);
  const int2* last = sweep_planes(g, tb, cells2, cells2 + g.cells, sweeps);
  phase_clock(1, 2, since);
  // the tile's pixels inside the frame: a 127 pixel has taken
  // min(., 2^30) in the first sweep and kept it
#pragma unroll 4
  for (int i = threadIdx.x; i < tile_h * tile_w; i += kPropThreads,
           t.next()) {
    const int y = blockIdx.y * tile_h + t.r, x = blockIdx.x * tile_w + t.c;
    if (y >= h || x >= w) continue;
    const size_t p = g.base + (size_t)y * w + x;
    const int cell = (t.r + halo + 1) * g.pitch + t.c + halo + 1;
    const int c = tb[cell];
    dst[p] = c == 255 ? last[cell].x
             : c == 0 ? last[cell].y
                      : min(src[p], kBig);
  }
  RVT_PHASE_SYNC();
  phase_clock(1, 3, since);
}

}  // namespace

// threshim (B, h, w), values (B, h, w) -> out (B, h, w); labels and
// rootmin (B, h*w) are scratch. tile_h .. smem are ops/ccl_kernel.py
// ccl_plan's. *launches gets the launches made. Returns a cudaError_t.
extern "C" int rvt_propagate_fixpoint(const uint8_t* thr, const int* values,
                                      int* labels, int* rootmin, int* out,
                                      int* launches, int b, int h, int w,
                                      int tile_h, int tile_w, int tiles_x,
                                      int tiles_y, int threads,
                                      int border_threads, int smem,
                                      int device, cudaStream_t stream) {
  *launches = 0;
  cudaSetDevice(device);
  const rvt::TilePlan plan{tile_h, tile_w, tiles_x, tiles_y, threads,
                           border_threads, smem};
  if (!rvt::plan_ok(plan, b, h, w)) return (int)cudaErrorInvalidValue;
  const int n = h * w;
  const int total = b * n;
  // out holds the union-find's forest until the broadcast overwrites it
  cudaError_t err = rvt::label_tiles<true>(thr, values, out, labels, rootmin,
                                           nullptr, b, h, w, plan, launches,
                                           stream);
  if (err != cudaSuccess) return (int)err;
  root_broadcast_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                          stream>>>(labels, rootmin, out, n, total);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return (int)err;
}

// labels (B, n) -> counts (B, n): one cooperative launch of as many
// blocks as the device holds at once, at most one a chunk. *launches gets
// the device launches made. Returns a cudaError_t.
extern "C" int rvt_label_histogram(const int* labels, int* counts,
                                   int* launches, int b, int n, int device,
                                   cudaStream_t stream) {
  *launches = 0;
  cudaSetDevice(device);
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (b < 1 || n < 1 || (long long)b * n >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  const bool vec = reinterpret_cast<uintptr_t>(labels) % 16 == 0;
  const void* fn = vec ? (const void*)label_hist_kernel<true>
                       : (const void*)label_hist_kernel<false>;
  // once per device and variant: the blocks that fit at once
  static std::atomic<int> resident[kMaxDevices][2];
  int fit = resident[device][vec].load(std::memory_order_acquire);
  if (fit == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kHistSmem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fn, kHistThreads, kHistSmem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    fit = per_sm * sms;
    resident[device][vec].store(fit, std::memory_order_release);
  }
  int total = b * n;
  int chunks = (total + kHistChunk - 1) / kHistChunk;
  void* args[] = {(void*)&labels, (void*)&counts, (void*)&n, (void*)&total,
                  (void*)&chunks};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(chunks < fit ? chunks : fit), dim3(kHistThreads), args,
      kHistSmem, stream);
  if (err == cudaSuccess) ++*launches;
  return (int)err;
}

// threshim, labels (B, h, w) -> out (B, h, w), the labels after n_sweeps
// sweeps; scratch (B, h, w) holds every other round (unused for one).
// tile_h .. smem are ops/ccl_kernel.py propagate_plan's. *launches gets
// the device operations made: one a round of at most `halo` sweeps, or
// the copy for n_sweeps = 0. Returns a cudaError_t.
extern "C" int rvt_propagate(const uint8_t* thr, const int* labels,
                             int* scratch, int* out, int* launches, int b,
                             int h, int w, int n_sweeps, int tile_h,
                             int tile_w, int halo, int tiles_x, int tiles_y,
                             int threads, int smem, int device,
                             cudaStream_t stream) {
  *launches = 0;
  cudaSetDevice(device);
  if (n_sweeps == 0) {
    const cudaError_t err = cudaMemcpyAsync(
        out, labels, sizeof(int) * (size_t)b * h * w,
        cudaMemcpyDeviceToDevice, stream);
    if (err == cudaSuccess) ++*launches;
    return (int)err;
  }
  const int rh = tile_h + 2 * halo, rw = tile_w + 2 * halo;
  const long long cells = (long long)(rh + 2) * (rw + 2);
  const int rounds = (n_sweeps + halo - 1) / halo;
  if (n_sweeps < 0 || halo < 1 || tile_h < 1 || tile_w < 1 ||
      threads != kPropThreads || rh % kPropRows != 0 ||
      rh / kPropRows * rw != threads || tiles_x < 1 || tiles_y < 1 ||
      (long long)tiles_x * tile_w < w ||
      (long long)(tiles_x - 1) * tile_w >= w ||
      (long long)tiles_y * tile_h < h ||
      (long long)(tiles_y - 1) * tile_h >= h || tiles_y > 65535 || b < 1 ||
      b > 65535 || smem < 17 * cells ||
      cells > (long long)kPropLoadSteps * kPropThreads ||
      (scratch == nullptr && rounds > 1))
    return (int)cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  static std::atomic<int> opted[kMaxDevices];
  if (opted[device].load(std::memory_order_acquire) < smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        propagate_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    opted[device].store(smem, std::memory_order_release);
  }
  const int* src = labels;
  for (int r = 0; r < rounds; ++r) {
    // the last round writes out, the ones before alternate with scratch
    int* dst = (rounds - 1 - r) % 2 == 0 ? out : scratch;
    const int sweeps = r < rounds - 1 ? halo : n_sweeps - halo * r;
    propagate_tile_kernel<<<dim3(tiles_x, tiles_y, b), kPropThreads, smem,
                            stream>>>(thr, src, dst, h, w, tile_h, tile_w,
                                      halo, sweeps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launches;
    src = dst;
  }
  return 0;
}

RVT_HOPS_EXPORT(rvt_propagate_fixpoint_hops)

// Union-find labelling of a {0, 127, 255} threshold image, shared by
// ccl.cu (K2) and flood.cu (K6). Contract of ros_vision_tpu/ops/ccl.py
// label_components: 4-way connectivity for 0, 8-way for 255 (diagonals
// join only 255 pixels), 127 pixels are singletons. After the three phases
// below, labels[b, p] is the minimum flat pixel index of p's component and
// table[b, root] holds each root's accumulation (K2: its size; K6: the
// minimum of `values` over the component).
//
// Two levels, because one union-find over the whole frame in global
// memory is bound by chains of dependent L2 reads and by the atomics of
// many SMs on the few roots of the large components. The frame is cut into
// tiles of tile_h rows by tile_w columns (ops/ccl_kernel.py ccl_plan), one
// block a tile; the union-find's forest is a scratch plane:
//   A (tile_label_kernel): the block labels its tile in shared memory on
//     tile-local indices: each pixel starts under the first pixel of its
//     run of equal values within its warp's 32 (one ballot), then the
//     other edges are unioned with shared atomicMin links and path-halving
//     finds. It writes each pixel's forest entry, the global index of its
//     tile-local root (tile-local row-major order is monotone in the flat
//     index, so that root is the minimum of the tile's part of the
//     component), and initialises the table at the tile-local roots (every
//     final root is one);
//   B (border_merge_kernel): only the pixels on a tile's top row, left
//     column and right column union, and only across the tile border, in
//     the global forest: atomicMin, larger root under smaller, finds
//     through L2 with path halving;
//   C (finalize_kernel): each pixel takes a slot, a tile-local node of its
//     component; the block reduces its pixels per slot in shared memory,
//     one thread per slot finds the final root and adds the slot's total
//     with one global atomic, and every pixel writes its final label.
// 127 pixels are singletons: they take no union, and C writes their label
// and table entry with plain stores. Finds and unions run in warp lockstep
// (see warp_find).
//
// Edges. Pixel p unions with its left and up neighbours of equal value,
// and a 255 pixel with its up-left and up-right 255 neighbours, less the
// edges that others imply (edge_mask): up when left and up-left are equal
// too (left, up-left, up is a 4-connected path); up-left when left or up
// is 255 too; up-right when up is 255 too. Left edges are never skipped,
// and every skipped edge is implied by edges of pixels earlier in
// row-major order, so the unions join exactly the components. Phase A
// evaluates the rule with every neighbour outside the tile taken as
// different (it never skips on what it cannot see); phase B takes the
// edges that leave the tile with the whole frame in view. The diagonals
// leave through the corners: a top-row pixel's up-left and up-right enter
// the tiles above-left and above-right, a left-column pixel's up-left the
// tile to the left (or above-left), a right-column pixel's up-right the
// tile to the right (or, on the top row, above-right).
//
// Races. Every write to a label lowers it or replaces it by a smaller
// index of the same component: a link (atomicMin of a root), a
// path-halving store (a node's parent becomes its grandparent). No write
// makes a node a root again, so finds end and no cycle forms. A halving
// store may overwrite a concurrent atomicMin only on a node that was no
// root when it was read; that atomicMin then failed (it returned another
// value than the node), and its union goes on with the value it returned,
// so the merge it was making still happens. The forest is scratch: C
// writes the final labels to an array of their own, where no other
// block's halving store can put an earlier ancestor back over one.
// Integer min and integer counts do not depend on order, so the result is
// the same in every run.
#pragma once
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace rvt {
namespace {   // internal linkage: included by several .cu files

constexpr int kTileW = 128;                // tile columns (ccl_plan's TILE_W)
constexpr int kTileItems = 8;              // pixels of a tile per thread
static_assert(kTileItems * 4 <= 32, "phase A queues 4 edge bits a pixel");
constexpr int kTileSmemLimit = 48 * 1024;  // a block's shared memory, no opt-in
constexpr int kTileSmemPerPixel = 8;       // phase C: a slot total, a final root

// Counting builds (off by default; see scripts/mb_torch_ccl_phases.py).
// -DRVT_CCL_COUNT_HOPS: for each phase named in RVT_HOP_NAMES (kHopStats
// counts), the finds, their hops (parent steps) summed, the most hops of
// one find, the unions, and their rounds (atomicMin tries).
// -DRVT_CCL_STEP_CLOCKS: for phase A, the clock cycles that each block's
// thread 0 spent in each of its kTileSteps steps (load, runs, unions,
// finds), summed over the blocks. The two are separate builds: the
// counts' global atomics would swamp the cycles. RVT_HOPS_EXPORT(name)
// defines extern "C" name(out), which copies the kHopCounts counts to the
// host's out and zeroes them, and name_phases(), the names of the phases
// and of the steps.
constexpr int kHopPhases = 3;
constexpr int kHopStats = 5;
constexpr int kTileSteps = 4;
constexpr int kHopCounts = kHopPhases * kHopStats + kTileSteps;
#define RVT_HOP_NAMES "tile,border,finalize|load,runs,unions,finds"
#if defined(RVT_CCL_COUNT_HOPS) || defined(RVT_CCL_STEP_CLOCKS)
__device__ unsigned long long g_hops[kHopCounts];
#define RVT_HOPS_EXPORT(name)                                              \
  extern "C" const char* name##_phases() { return RVT_HOP_NAMES; }       \
  extern "C" int name(unsigned long long* out) {                           \
    static const unsigned long long zero[rvt::kHopCounts] = {};            \
    cudaError_t e = cudaMemcpyFromSymbol(out, rvt::g_hops, sizeof(zero));  \
    if (e != cudaSuccess) return (int)e;                                   \
    return (int)cudaMemcpyToSymbol(rvt::g_hops, zero, sizeof(zero));       \
  }
#else
#define RVT_HOPS_EXPORT(name)
#endif
#ifdef RVT_CCL_COUNT_HOPS
__device__ __forceinline__ void count_hops(int phase, unsigned hops) {
  atomicAdd(&g_hops[phase * kHopStats], 1ull);
  atomicAdd(&g_hops[phase * kHopStats + 1], (unsigned long long)hops);
  atomicMax(&g_hops[phase * kHopStats + 2], (unsigned long long)hops);
}
__device__ __forceinline__ void count_union(int phase, unsigned rounds) {
  atomicAdd(&g_hops[phase * kHopStats + 3], 1ull);
  atomicAdd(&g_hops[phase * kHopStats + 4], (unsigned long long)rounds);
}
#else
__device__ __forceinline__ void count_hops(int, unsigned) {}
__device__ __forceinline__ void count_union(int, unsigned) {}
#endif
#ifdef RVT_CCL_STEP_CLOCKS
__device__ __forceinline__ long long step_clock() { return clock64(); }
__device__ __forceinline__ void count_step(int step, long long cycles) {
  if (threadIdx.x == 0)
    atomicAdd(&g_hops[kHopPhases * kHopStats + step],
              (unsigned long long)cycles);
}
#else
__device__ __forceinline__ long long step_clock() { return 0; }
__device__ __forceinline__ void count_step(int, long long) {}
#endif

// The tiles' launch plan (ops/ccl_kernel.py ccl_plan), taken as given.
struct TilePlan {
  int tile_h, tile_w, tiles_x, tiles_y, threads, border_threads, smem;
};

// The plan's layout for (b, h, w) frames: tiles that cover the frame
// exactly once; tile_w kTileW (compiled in, so that the tile index
// arithmetic is shifts); a block's threads a multiple of tile_w, so that
// each thread keeps one column of its tile and a warp holds 32 pixels of
// one tile row; kTileItems pixels per thread; one phase-B thread per
// pixel of a tile's border; phase C's tables in shared memory within the
// default limit; grid sizes within the device's; flat indices below 2^24
// (phase C divides them by w in float).
inline bool plan_ok(const TilePlan& p, int b, int h, int w) {
  const long long px = (long long)p.tile_h * p.tile_w;
  return h >= 1 && w >= 1 && (long long)h * w <= (1LL << 24) && b >= 1 &&
         b <= 65535 && p.tile_h >= 1 && p.tile_w == kTileW &&
         (long long)p.tiles_x * p.tile_w >= w &&
         (long long)(p.tiles_x - 1) * p.tile_w < w &&
         (long long)p.tiles_y * p.tile_h >= h &&
         (long long)(p.tiles_y - 1) * p.tile_h < h && p.tiles_y <= 65535 &&
         p.threads <= 1024 && p.threads % p.tile_w == 0 &&
         px == (long long)p.threads * kTileItems &&
         p.border_threads >= p.tile_w + 2 * (p.tile_h - 1) &&
         p.border_threads <= 1024 && p.border_threads % 32 == 0 &&
         px * kTileSmemPerPixel <= p.smem &&
         p.smem <= kTileSmemLimit;
}

// This block's tile: origin, real (ragged) size, and where this thread
// sits in it: column lx of rows ly0 + k * rows, k < kTileItems.
struct Tile {
  int y0, x0, rh, rw, lx, ly0, rows;
  __device__ Tile(int h, int w, int th)
      : y0(blockIdx.y * th), x0(blockIdx.x * kTileW),
        rh(min(th, h - (int)blockIdx.y * th)),
        rw(min(kTileW, w - (int)blockIdx.x * kTileW)),
        lx(threadIdx.x % kTileW), ly0(threadIdx.x / kTileW),
        rows(blockDim.x / kTileW) {}
  __device__ int ly(int k) const { return ly0 + k * rows; }
  __device__ bool in(int k) const { return lx < rw && ly(k) < rh; }
};

// Edges of pixel (y, x) to union: bit 0 left, 1 up, 2 up-left, 3
// up-right (see the note above); get(y, x) is a pixel's value, -1 where
// it cannot be seen.
template <class Get>
__device__ __forceinline__ unsigned edge_mask(const Get& get, int y, int x) {
  const int v = get(y, x);
  if (v == 127) return 0;
  const bool l = get(y, x - 1) == v;
  const bool u = get(y - 1, x) == v;
  const bool ul = get(y - 1, x - 1) == v;
  unsigned m = (unsigned)l | (unsigned)(u && !(l && ul)) << 1;
  if (v == 255) {
    const bool ur = get(y - 1, x + 1) == v;
    m |= (unsigned)(ul && !l && !u) << 2 | (unsigned)(ur && !u) << 3;
  }
  return m;
}

// Loads and stores of the forest: shared memory in phase A, L2 in B and C
// (other SMs change the global forest within the same launch).
struct SharedLabels {
  int* L;
  __device__ int get(int x) const { return ((volatile int*)L)[x]; }
  __device__ void set(int x, int v) const { ((volatile int*)L)[x] = v; }
  __device__ int link(int x, int v) const { return atomicMin(L + x, v); }
};
struct GlobalLabels {
  int* L;
  __device__ int get(int x) const { return __ldcg(L + x); }
  __device__ void set(int x, int v) const { __stcg(L + x, v); }
  __device__ int link(int x, int v) const { return atomicMin(L + x, v); }
};

// Finds and unions run in warp lockstep: every lane of the warp calls
// them, the lanes with `active` (or `want`) false only keep step, and each
// loop goes round while any lane of the warp still has work (a vote), so
// the warp stays converged. Divergent per-lane loops let the warp run its
// lanes' finds and unions one group after another, which took most of
// the tile phase's time.

// The root of x for the active lanes, halving the path on the way: each
// visited node's parent becomes its grandparent.
template <int kPhase, class Labels>
__device__ __forceinline__ int warp_find(const Labels& L, int x,
                                         bool active) {
  unsigned hops = 0;
  bool go = active;
  while (__any_sync(0xffffffffu, go)) {
    if (go) {
      const int p = L.get(x);
      if (p == x) {
        go = false;
      } else {
        const int g = L.get(p);
        ++hops;
        if (g == p) {
          x = p;
          go = false;
        } else {
          L.set(x, g);
          x = g;
          ++hops;
        }
      }
    }
  }
  if (active) count_hops(kPhase, hops);
  return x;
}

// Join the sets of a and b for the lanes with `want`: link the larger
// root under the smaller by atomicMin; if that root was linked meanwhile,
// go on from what atomicMin returned.
template <int kPhase, class Labels>
__device__ __forceinline__ void warp_union(const Labels& L, bool want,
                                           int a, int b) {
  unsigned rounds = 0;
  bool go = want;
  while (__any_sync(0xffffffffu, go)) {
    a = warp_find<kPhase>(L, a, go);
    b = warp_find<kPhase>(L, b, go);
    if (go) {
      ++rounds;
      if (a > b) {
        const int t = a;
        a = b;
        b = t;
      }
      const int old = a == b ? b : L.link(b, a);
      if (old == b) go = false;
      else b = old;
    }
  }
  if (want) count_union(kPhase, rounds);
}

// Phase A. Shared memory: tile_h * kTileW int labels, then as many image
// bytes. Left edges inside a warp need no union: each pixel's first parent
// is the first pixel of its run of equal values among the warp's 32 (a
// ballot). kMin: the table starts at INT_MAX (K6), else at 0 (K2). done,
// when not null, gets 0 at [b] (a counter of a later K2 launch).
template <bool kMin>
__global__ void __launch_bounds__(1024)
    tile_label_kernel(const uint8_t* __restrict__ thr, int* forest,
                      int* table, int* done, int h, int w, int th) {
  extern __shared__ int smem[];
  int* sl = smem;
  uint8_t* si = reinterpret_cast<uint8_t*>(smem + th * kTileW);
  const Tile tile(h, w, th);
  const size_t origin =
      (size_t)blockIdx.z * h * w + (size_t)tile.y0 * w + tile.x0;
  const uint8_t* t = thr + origin;
  const int lane = threadIdx.x & 31;
  const int lx = tile.lx;
  long long clock0 = step_clock();
  int v[kTileItems];
#pragma unroll
  for (int k = 0; k < kTileItems; ++k)
    v[k] = tile.in(k) ? t[(size_t)tile.ly(k) * w + lx] : 127;
#pragma unroll
  for (int k = 0; k < kTileItems; ++k)
    si[tile.ly(k) * kTileW + lx] = (uint8_t)v[k];
  if (done != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      threadIdx.x == 0)
    done[blockIdx.z] = 0;
  __syncthreads();
  count_step(0, step_clock() - clock0);
  clock0 = step_clock();
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    const int i = tile.ly(k) * kTileW + lx;
    const bool join = lx > 0 && v[k] != 127 && si[i - 1] == v[k];
    // lane 0 starts a run here even when it joins the warp to its left
    const unsigned starts = ~__ballot_sync(0xffffffffu, join) | 1u;
    sl[i] = i - lane + 31 - __clz(starts & (0xffffffffu >> (31 - lane)));
  }
  __syncthreads();
  count_step(1, step_clock() - clock0);
  clock0 = step_clock();
  const SharedLabels L{sl};
  const auto get = [&](int y, int x) -> int {
    return (y >= 0 && y < tile.rh && x >= 0 && x < tile.rw)
               ? si[y * kTileW + x] : -1;
  };
  // this thread's edges, 4 bits a pixel (left only for lane 0), unioned
  // one at a time while any lane of the warp has one left
  unsigned edges = 0;
#pragma unroll
  for (int k = 0; k < kTileItems; ++k)
    if (tile.in(k))
      edges |= (edge_mask(get, tile.ly(k), lx) & (lane == 0 ? 15u : 14u))
               << 4 * k;
  while (__any_sync(0xffffffffu, edges != 0)) {
    const int bit = edges ? __ffs(edges) - 1 : 0;
    const int e = bit & 3;
    const int i = tile.ly(bit >> 2) * kTileW + lx;
    warp_union<0>(L, edges != 0, i,
                  i - (e == 0 ? 1 : e == 1 ? kTileW : e == 2 ? kTileW + 1
                                                           : kTileW - 1));
    edges &= edges - 1;
  }
  __syncthreads();
  count_step(2, step_clock() - clock0);
  clock0 = step_clock();
  int* lab = forest + origin;
  int* tab = table + origin;
  const int gorigin = tile.y0 * w + tile.x0;
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    const int i = tile.ly(k) * kTileW + lx;
    const int r = warp_find<0>(L, i, tile.in(k));
    if (!tile.in(k)) continue;
    const size_t p = (size_t)tile.ly(k) * w + lx;
    lab[p] = gorigin + (r / kTileW) * w + r % kTileW;
    if (r == i && v[k] != 127) tab[p] = kMin ? INT_MAX : 0;
  }
  count_step(3, step_clock() - clock0);
}

// Phase B: the tile's top row, left column and right column, in that
// order, one thread a pixel; each unions its edges that leave the tile.
__global__ void __launch_bounds__(1024)
    border_merge_kernel(const uint8_t* __restrict__ thr, int* forest, int h,
                        int w, int th) {
  const Tile tile(h, w, th);
  const size_t base = (size_t)blockIdx.z * h * w;
  const uint8_t* t = thr + base;
  const GlobalLabels L{forest + base};
  const auto get = [&](int y, int x) -> int {
    return (y >= 0 && y < h && x >= 0 && x < w) ? t[(size_t)y * w + x] : -1;
  };
  const int k = threadIdx.x;
  const int nb = tile.rw + (tile.rh - 1) * (tile.rw > 1 ? 2 : 1);
  int ly, lx;
  if (k < tile.rw) {
    ly = 0;
    lx = k;
  } else if (k < tile.rw + tile.rh - 1) {
    ly = k - tile.rw + 1;
    lx = 0;
  } else {
    ly = k - tile.rw - tile.rh + 2;
    lx = tile.rw - 1;
  }
  const int y = tile.y0 + ly, x = tile.x0 + lx;
  const unsigned m = k < nb ? edge_mask(get, y, x) : 0u;
  const int p = y * w + x;
  // the edges that leave the tile: left, up, up-left, up-right
  const bool leaves[4] = {lx == 0, ly == 0, ly == 0 || lx == 0,
                          ly == 0 || lx == tile.rw - 1};
  const int offset[4] = {-1, -w, -w - 1, -w + 1};
  // finds start at tile-local roots, so B writes no other pixel's label
  const int a = m ? L.get(p) : 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool want = (m >> e & 1u) && leaves[e];
    warp_union<1>(L, want, a, want ? L.get(p + offset[e]) : 0);
  }
}

// Phase C. Shared memory: tile_h * kTileW slot totals, then as many final
// roots (-1: not a slot). kMin: table[root] = the minimum of values over
// the component (K6), else its pixel count (K2). A pixel's slot is the
// label it holds where that lies in the tile (its tile-local root, or,
// for a tile-local root that B linked, an ancestor), else the pixel
// itself: a node of its component either way. Each thread loads all its
// pixels before it reduces any, so that their loads overlap.
template <bool kMin>
__global__ void __launch_bounds__(1024)
    finalize_kernel(const uint8_t* __restrict__ thr,
                    const int* __restrict__ values, int* forest,
                    int* labels, int* table, int h, int w, int th) {
  extern __shared__ int smem[];
  int* sacc = smem;
  int* sfin = smem + th * kTileW;
  const Tile tile(h, w, th);
  const size_t base = (size_t)blockIdx.z * h * w;
  const int gorigin = tile.y0 * w + tile.x0;
  const uint8_t* t = thr + base;
  const GlobalLabels L{forest + base};
  int* lab = labels + base;
  int* tab = table + base;
  const int lane = threadIdx.x & 31;
  const float inv_w = 1.0f / (float)w;
  int px[kTileItems], tv[kTileItems], q[kTileItems], val[kTileItems];
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    const bool in = tile.in(k);
    px[k] = in ? gorigin + tile.ly(k) * w + tile.lx : -1;
    tv[k] = in ? t[px[k]] : 127;
    q[k] = in ? L.get(px[k]) : 0;
    val[k] = kMin ? (in ? values[base + px[k]] : INT_MAX) : 1;
    const int i = tile.ly(k) * kTileW + tile.lx;
    sacc[i] = kMin ? INT_MAX : 0;
    sfin[i] = -1;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    int s = -1;
    if (px[k] >= 0 && tv[k] == 127) {
      lab[px[k]] = px[k];                    // a singleton: its own root
      tab[px[k]] = val[k];
    } else if (px[k] >= 0) {
      // the label's row and column: the float quotient, then corrected
      int qy = __float2int_rz(__int2float_rn(q[k]) * inv_w);
      int qx = q[k] - qy * w;
      while (qx < 0) {
        --qy;
        qx += w;
      }
      while (qx >= w) {
        ++qy;
        qx -= w;
      }
      qy -= tile.y0;
      qx -= tile.x0;
      s = (qy >= 0 && qy < tile.rh && qx >= 0 && qx < tile.rw)
              ? qy * kTileW + qx : tile.ly(k) * kTileW + tile.lx;
    }
    q[k] = s;
    if (!__any_sync(0xffffffffu, s >= 0)) continue;   // all singletons
    // lanes that share a slot reduce first, and their leader adds once
    const unsigned peers = __match_any_sync(0xffffffffu, s);
    const int total = kMin ? __reduce_min_sync(peers, val[k]) : __popc(peers);
    if (s >= 0 && lane == __ffs(peers) - 1) {
      if (kMin)
        atomicMin(sacc + s, total);
      else
        atomicAdd(sacc + s, total);
      sfin[s] = 0;
    }
  }
  __syncthreads();
  // this thread's slots, one bit a pixel, found one at a time while any
  // lane of the warp has one left
  unsigned slots = 0;
#pragma unroll
  for (int k = 0; k < kTileItems; ++k)
    if (sfin[tile.ly(k) * kTileW + tile.lx] == 0) slots |= 1u << k;
  while (__any_sync(0xffffffffu, slots != 0)) {
    const int k = slots ? __ffs(slots) - 1 : 0;
    const int i = tile.ly(k) * kTileW + tile.lx;
    const int f =
        warp_find<2>(L, gorigin + tile.ly(k) * w + tile.lx, slots != 0);
    if (slots != 0) {
      if (kMin)
        atomicMin(tab + f, sacc[i]);
      else
        atomicAdd(tab + f, sacc[i]);
      sfin[i] = f;
    }
    slots &= slots - 1;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kTileItems; ++k)
    if (q[k] >= 0) lab[px[k]] = sfin[q[k]];
}

// Phases A, B and C on `stream`: labels (B, h*w) of the (B, h, w)
// threshold image and the table (B, h*w) at the roots (kMin: the minimum
// of values, else sizes); forest (B, h*w) is the union-find's scratch.
// *launches counts the launches made. Returns cudaGetLastError() after
// each launch. The plan passed plan_ok.
template <bool kMin>
cudaError_t label_tiles(const uint8_t* thr, const int* values, int* forest,
                        int* labels, int* table, int* done, int b, int h,
                        int w, const TilePlan& plan, int* launches,
                        cudaStream_t stream) {
  const dim3 grid(plan.tiles_x, plan.tiles_y, b);
  tile_label_kernel<kMin><<<grid, plan.threads, plan.smem, stream>>>(
      thr, forest, table, done, h, w, plan.tile_h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launches;
  border_merge_kernel<<<grid, plan.border_threads, 0, stream>>>(
      thr, forest, h, w, plan.tile_h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launches;
  finalize_kernel<kMin><<<grid, plan.threads, plan.smem, stream>>>(
      thr, values, forest, labels, table, h, w, plan.tile_h);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return err;
}

}  // namespace
}  // namespace rvt

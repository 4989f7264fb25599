// K9: lexicographic sort of (B, K) int32 rows, not stable. 1-3 operand
// planes; the first `nkeys` are keys compared lexicographically as signed
// int32, the rest ride along as payload. Each row is padded to
// N = max(256, next power of two >= K) with INT32_MAX in the key planes and
// 0 in the payload planes; the first K slots of the sorted padded row are
// the result.
//
// Replaces ros_vision_tpu/ops/sort_pallas.py sort_tpu (pallas_call at
// :146, kernel body _make_sort_kernel:51), the four sorts of
// cluster_and_fit when use_pallas_sort is on, at K = 8,192, 32,768 and
// 131,072. The network, its direction rule (ascending where bit `size` of
// the element's global index is 0) and its swap rule (exchange only on
// strict less-than) are the TPU kernel's, so the output equals sort_tpu's
// bit for bit, payload order of equal keys included.
//
// Bound on the H100: bytes, one read and one write of every plane (3.1 MB
// at B = 4, N = 131,072: ~1 us at 3.35 TB/s). The design keeps a row on
// chip for the whole network: one block holds T = 16,384 elements of every
// plane in shared memory (3 x 16,896 padded int32 = 198 KB), and a row of
// N <= 131,072 is held by one thread-block cluster of C = N / T blocks
// (C = 1 up to 16,384, 2 at 32,768, 8 at 131,072, the portable maximum).
// Each plane is read from HBM once and its first K slots written once, in
// one launch. Inside, the 153 compare-exchange steps at N = 131,072 run by
// stride level; each thread holds E = 16 consecutive elements per plane:
//   - strides < E in registers, with no synchronisation (62 steps);
//   - strides < 32 E across the lanes of a warp, __shfl_xor_sync (55);
//   - strides < T across the warps, in shared memory behind __syncthreads
//     (30);
//   - strides >= T across the cluster's blocks, through distributed shared
//     memory (map_shared_rank) behind cluster.sync() (6).
// Occupancy given up: one block of 1024 threads per SM (the shared memory),
// so B rows take B * C SMs: 32 of 132 at B = 4, N = 131,072. At 1024
// threads a thread has 64 registers; three planes (48 values) spill a few
// hundred bytes, which cost less on the card than 32 elements per thread
// at 512 threads (128 registers, more spill). With the bytes moved once,
// what remains is the network's work: N/2 compare-exchanges in each of
// 153 steps on those 32 SMs, most of it in the register and shuffle
// levels (scripts/mb_torch_sort_levels.py times each level kind).
//
// Past N = 131,072 (which sort_tpu accepts and no path uses) the strides
// >= 8 T run one launch each in device memory (sort_step_kernel), and the
// cluster kernel runs every stride below 8 T of each larger stage: the same
// network in 1 + sum_i (i + 1) launches for N = 2^i * 131,072.
//
// The launch plan (N, T, C, threads, shared bytes) is ops/sort_kernel.py
// sort_plan's; rvt_sort takes it as given and checks only what the device
// and the kernel's layout require.
//
// Built with -DRVT_SORT_SKIP_LEVELS, the kernel skips the stride levels
// whose bits are set in the device variable g_skip_levels: registers (1),
// shuffles (2), shared memory (4), cluster (8). It then times a level kind
// and does not sort; scripts/mb_torch_sort_levels.py builds it so.
#include <atomic>
#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#ifdef RVT_SORT_SKIP_LEVELS
__device__ int g_skip_levels;
#define SKIP_LEVEL(bit) (g_skip_levels & (bit))
#else
#define SKIP_LEVEL(bit) false
#endif

namespace {

constexpr int kMaxOps = 3;
constexpr int kMaxCluster = 8;     // the portable cluster size limit
constexpr int kMaxThreads = 1024;
constexpr int kElems = 16;         // E, elements per thread per plane
constexpr int kMaxDevices = 64;
constexpr int kClusterUnplaceable = -1;

// one int of padding per 32, so a thread's E consecutive elements and 32
// consecutive pair slots both fall in distinct banks
__host__ __device__ constexpr int padded(int i) { return i + (i >> 5); }
__host__ __device__ constexpr int plane_len(int tile) {
  return tile + (tile >> 5);
}

struct Planes {
  int* p[kMaxOps];
};

struct CPlanes {
  const int* p[kMaxOps];
};

// lt = a < b and gt = a > b, lexicographic over the first NKEYS planes.
// Bitwise logic, no short circuit: the callers pick one of the two by a
// flag that differs between the lanes of a warp, and a branch there would
// split the warp.
template <int NKEYS, int NOPS>
__device__ __forceinline__ void lex_cmp(const int (&a)[NOPS],
                                        const int (&b)[NOPS], bool& lt,
                                        bool& gt) {
  lt = a[NKEYS - 1] < b[NKEYS - 1];
  gt = a[NKEYS - 1] > b[NKEYS - 1];
#pragma unroll
  for (int q = NKEYS - 2; q >= 0; --q) {
    const bool eq = a[q] == b[q];
    lt = (a[q] < b[q]) | (eq & lt);
    gt = (a[q] > b[q]) | (eq & gt);
  }
}

// The TPU's rule for the pair (lo, hi): exchange where ascending ? hi < lo
// : lo < hi.
template <int NKEYS, int NOPS>
__device__ __forceinline__ bool exchange(const int (&lo)[NOPS],
                                         const int (&hi)[NOPS], bool asc) {
  bool lt, gt;
  lex_cmp<NKEYS>(hi, lo, lt, gt);
  return (asc & lt) | (!asc & gt);
}

// Stride RS < E: the pairs (r, r + RS) inside each thread's registers.
// gbase is the global index of the thread's first element (a multiple of
// E), so bit `size` of element r's index is bit `size` of gbase | r.
template <int NOPS, int NKEYS, int E, int RS>
__device__ __forceinline__ void reg_step(int (&v)[NOPS][E], int gbase,
                                         int size) {
#pragma unroll
  for (int r = 0; r < E; ++r) {
    if (r & RS) continue;
    const bool asc = ((gbase | r) & size) == 0;
    int a[NOPS], b[NOPS];
#pragma unroll
    for (int q = 0; q < NOPS; ++q) {
      a[q] = v[q][r];
      b[q] = v[q][r + RS];
    }
    const bool sw = exchange<NKEYS>(a, b, asc);
#pragma unroll
    for (int q = 0; q < NOPS; ++q) {
      v[q][r] = sw ? b[q] : a[q];
      v[q][r + RS] = sw ? a[q] : b[q];
    }
  }
}

// every register stride from RS down to 1 that is <= s
template <int NOPS, int NKEYS, int E, int RS>
__device__ __forceinline__ void reg_levels(int (&v)[NOPS][E], int s,
                                           int gbase, int size) {
  if constexpr (RS >= 1) {
    if (RS <= s) reg_step<NOPS, NKEYS, E, RS>(v, gbase, size);
    reg_levels<NOPS, NKEYS, E, RS / 2>(v, s, gbase, size);
  }
}

// Stride s = E * m, E <= s < 32 E: element r of this thread pairs with
// element r of lane ^ m. Each side keeps the minimum or the maximum by the
// TPU's rule: take the partner's tuple where (lower == ascending) ?
// partner < own : own < partner.
template <int NOPS, int NKEYS, int E>
__device__ __forceinline__ void shfl_step(int (&v)[NOPS][E], int m,
                                          unsigned mask, int lane, int gbase,
                                          int size) {
  const bool lower = (lane & m) == 0;
  const bool want_min = lower == ((gbase & size) == 0);
#pragma unroll
  for (int r = 0; r < E; ++r) {
    int a[NOPS], p[NOPS];
#pragma unroll
    for (int q = 0; q < NOPS; ++q) {
      a[q] = v[q][r];
      p[q] = __shfl_xor_sync(mask, a[q], m);
    }
    bool take;
    if constexpr (NKEYS == 1) {
      // (on the card this form runs faster than lex_cmp's for one key)
      take = want_min ? p[0] < a[0] : a[0] < p[0];
    } else {
      bool lt, gt;  // partner < own, partner > own
      lex_cmp<NKEYS>(p, a, lt, gt);
      take = (want_min & lt) | (!want_min & gt);
    }
#pragma unroll
    for (int q = 0; q < NOPS; ++q) v[q][r] = take ? p[q] : a[q];
  }
}

// Compare-exchange of kChunk pairs in shared memory: plane 0 of pair i at
// slots lo[i] and hi[i] (plane q at + q * ps), its lower element at global
// index g_lo[i]. Every load comes before any exchange (the pairs are
// disjoint), so the chunk's loads are in flight together.
constexpr int kChunk = 4;

template <int NOPS, int NKEYS>
__device__ __forceinline__ void pairs_step(int* const (&lo)[kChunk],
                                           int* const (&hi)[kChunk], int ps,
                                           const int (&g_lo)[kChunk],
                                           int size) {
  int a[kChunk][NOPS], b[kChunk][NOPS];
#pragma unroll
  for (int i = 0; i < kChunk; ++i)
#pragma unroll
    for (int q = 0; q < NOPS; ++q) {
      a[i][q] = lo[i][q * ps];
      b[i][q] = hi[i][q * ps];
    }
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    if (exchange<NKEYS>(a[i], b[i], (g_lo[i] & size) == 0)) {
#pragma unroll
      for (int q = 0; q < NOPS; ++q) {
        lo[i][q * ps] = b[i][q];
        hi[i][q * ps] = a[i][q];
      }
    }
  }
}

// registers <-> shared memory: element r of thread tid at slot tid * E + r
template <int NOPS, int E>
__device__ __forceinline__ void regs_to_smem(const int (&v)[NOPS][E],
                                             int* sm, int ps, int tid) {
#pragma unroll
  for (int r = 0; r < E; ++r)
#pragma unroll
    for (int q = 0; q < NOPS; ++q) sm[q * ps + padded(tid * E + r)] = v[q][r];
}

template <int NOPS, int E>
__device__ __forceinline__ void smem_to_regs(int (&v)[NOPS][E],
                                             const int* sm, int ps, int tid) {
#pragma unroll
  for (int r = 0; r < E; ++r)
#pragma unroll
    for (int q = 0; q < NOPS; ++q) v[q][r] = sm[q * ps + padded(tid * E + r)];
}

// One cluster runs stages size_lo..size_hi of the network over C * tile
// consecutive elements of row blockIdx.y (each stage over strides
// min(size, C * tile) / 2 .. 1). Loads the padded planes from `in` (the
// fill past lim_in), stores the slots below lim_out to `out`. Between
// stages the row sits in registers; a stage with strides >= 32 E moves it
// to shared memory for those strides and back.
template <int NOPS, int NKEYS>
__global__ void __launch_bounds__(kMaxThreads, 1)
    sort_cluster_kernel(CPlanes in, int ld_in, int lim_in, Planes out,
                        int ld_out, int lim_out, int tile, int size_lo,
                        int size_hi) {
  constexpr int E = kElems;
  extern __shared__ int smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int threads = blockDim.x;  // tile / E
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rank = (int)cluster.block_rank();
  const int ctile = tile * (int)cluster.num_blocks();
  const int base = blockIdx.x * tile;
  const int gbase = base + tid * E;
  const int ps = plane_len(tile);
  const int warp_span = 32 * E;
  const unsigned mask = threads >= 32 ? 0xffffffffu : (1u << threads) - 1u;

#pragma unroll
  for (int q = 0; q < NOPS; ++q) {
    const int* src = in.p[q] + (size_t)blockIdx.y * ld_in;
    const int fill = q < NKEYS ? INT_MAX : 0;
    for (int i = tid; i < tile; i += threads) {
      const int g = base + i;
      smem[q * ps + padded(i)] = g < lim_in ? src[g] : fill;
    }
  }
  __syncthreads();
  int v[NOPS][E];
  smem_to_regs<NOPS, E>(v, smem, ps, tid);

  for (int size = size_lo; size <= size_hi; size <<= 1) {
    int s = min(size, ctile) >> 1;
    if (s >= warp_span) {
      __syncthreads();  // every thread has read its last load
      regs_to_smem<NOPS, E>(v, smem, ps, tid);
      if (s >= tile) {
        // the lower block of a pair takes the first half of the slots,
        // the upper block the second, each reading and writing both
        cluster.sync();
        for (; s >= tile; s >>= 1) {
          const int m = s / tile;
          const bool lower = (rank & m) == 0;
          int* other = cluster.map_shared_rank(smem, rank ^ m);
          int* lo_p = lower ? smem : other;
          int* hi_p = lower ? other : smem;
          const int g = (blockIdx.x & ~m) * tile;
          const int e0 = (lower ? 0 : tile / 2) + tid;
          for (int c = 0; c < E / 2 && !SKIP_LEVEL(8); c += kChunk) {
            int* lo[kChunk];
            int* hi[kChunk];
            int g_lo[kChunk];
#pragma unroll
            for (int i = 0; i < kChunk; ++i) {
              const int pe = padded(e0 + (c + i) * threads);
              lo[i] = lo_p + pe;
              hi[i] = hi_p + pe;
              g_lo[i] = g;
            }
            pairs_step<NOPS, NKEYS>(lo, hi, ps, g_lo, size);
          }
          cluster.sync();
        }
      } else {
        __syncthreads();
      }
      for (; s >= warp_span; s >>= 1) {
        for (int c = 0; c < E / 2 && !SKIP_LEVEL(4); c += kChunk) {
          int* lo[kChunk];
          int* hi[kChunk];
          int g_lo[kChunk];
#pragma unroll
          for (int i = 0; i < kChunk; ++i) {
            const int pi = tid + (c + i) * threads;
            const int l = ((pi & ~(s - 1)) << 1) | (pi & (s - 1));
            lo[i] = smem + padded(l);
            hi[i] = smem + padded(l + s);
            g_lo[i] = base + l;
          }
          pairs_step<NOPS, NKEYS>(lo, hi, ps, g_lo, size);
        }
        __syncthreads();
      }
      smem_to_regs<NOPS, E>(v, smem, ps, tid);
    }
    for (; s >= E; s >>= 1)
      if (!SKIP_LEVEL(2))
        shfl_step<NOPS, NKEYS, E>(v, s / E, mask, lane, gbase, size);
    if (!SKIP_LEVEL(1)) reg_levels<NOPS, NKEYS, E, E / 2>(v, s, gbase, size);
  }

  __syncthreads();
  regs_to_smem<NOPS, E>(v, smem, ps, tid);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NOPS; ++q) {
    int* dst = out.p[q] + (size_t)blockIdx.y * ld_out;
    for (int i = tid; i < tile; i += threads) {
      const int g = base + i;
      if (g < lim_out) dst[g] = smem[q * ps + padded(i)];
    }
  }
}

// One compare-exchange step (stage `size`, stride >= 8 T) over the padded
// (B, n) planes in device memory, one thread per pair.
__global__ void sort_step_kernel(Planes w, int n, int nops, int nkeys,
                                 int size, int stride) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n / 2) return;
  const int lo = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
  const int hi = lo + stride;
  const size_t off = (size_t)blockIdx.y * n;
  int a[kMaxOps], b[kMaxOps];
  for (int q = 0; q < nops; ++q) {
    a[q] = w.p[q][off + lo];
    b[q] = w.p[q][off + hi];
  }
  bool lt = false, gt = false;  // lexicographic b < a, b > a
  for (int q = nkeys - 1; q >= 0; --q) {
    const bool eq = b[q] == a[q];
    lt = (b[q] < a[q]) | (eq & lt);
    gt = (b[q] > a[q]) | (eq & gt);
  }
  if ((lo & size) == 0 ? lt : gt) {
    for (int q = 0; q < nops; ++q) {
      w.p[q][off + lo] = b[q];
      w.p[q][off + hi] = a[q];
    }
  }
}

struct Launch {
  int b, tile, cluster, threads;
  size_t smem;
  cudaStream_t stream;
};

// Once per process and device: the shared-memory opt-in, at the device's
// limit; once per tile and cluster size: that the device can place such a
// cluster at all.
template <int NOPS, int NKEYS>
int prepare(int device, const Launch& l) {
  static std::atomic<int> optin[kMaxDevices];  // the opt-in bytes, 0 before
  static std::atomic<int> placed[kMaxDevices][64];
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  auto kernel = sort_cluster_kernel<NOPS, NKEYS>;
  int limit = optin[device].load(std::memory_order_acquire);
  if (limit == 0) {
    cudaError_t err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (err != cudaSuccess) return (int)err;
    optin[device].store(limit, std::memory_order_release);
  }
  if (l.smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  const int key = __builtin_ctz((unsigned)l.tile) * 4 +
                  __builtin_ctz((unsigned)l.cluster);
  if (!placed[device][key].load(std::memory_order_acquire)) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(l.cluster, 1, 1);
    cfg.blockDim = dim3(l.threads, 1, 1);
    cfg.dynamicSmemBytes = l.smem;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = l.cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return kClusterUnplaceable;
    placed[device][key].store(1, std::memory_order_release);
  }
  return 0;
}

template <int NOPS, int NKEYS>
int launch_cluster(const Launch& l, int nblocks, CPlanes in, int ld_in,
                   int lim_in, Planes out, int ld_out, int lim_out,
                   int size_lo, int size_hi) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nblocks, l.b, 1);
  cfg.blockDim = dim3(l.threads, 1, 1);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = l.stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = l.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, sort_cluster_kernel<NOPS, NKEYS>, in,
                                 ld_in, lim_in, out, ld_out, lim_out, l.tile,
                                 size_lo, size_hi);
}

template <int NOPS, int NKEYS>
int sort_rows(const Launch& l, int device, const CPlanes& in,
              const Planes& work, const Planes& out, int k, int n,
              int* launches) {
  int err = prepare<NOPS, NKEYS>(device, l);
  if (err != 0) return err;
  const int ctile = l.tile * l.cluster;
  if (n == ctile) {  // the whole network in one cluster per row
    err = launch_cluster<NOPS, NKEYS>(l, l.cluster, in, k, k, out, k, k, 2,
                                      n);
    *launches += err == 0;
    return err;
  }
  err = launch_cluster<NOPS, NKEYS>(l, n / l.tile, in, k, k, work, n, n, 2,
                                    ctile);
  if (err != 0) return err;
  *launches += 1;
  const CPlanes cwork = {{work.p[0], work.p[1], work.p[2]}};
  const int step_threads = 256;
  const dim3 steps((n / 2 + step_threads - 1) / step_threads, l.b);
  for (int size = 2 * ctile; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride >= ctile; stride >>= 1) {
      sort_step_kernel<<<steps, step_threads, 0, l.stream>>>(
          work, n, NOPS, NKEYS, size, stride);
      err = (int)cudaGetLastError();
      if (err != 0) return err;
      *launches += 1;
    }
    const bool last = size == n;
    err = launch_cluster<NOPS, NKEYS>(l, n / l.tile, cwork, n, n,
                                      last ? out : work, last ? k : n,
                                      last ? k : n, size, size);
    if (err != 0) return err;
    *launches += 1;
  }
  return 0;
}

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

// in*/out*: (B, K) planes (unused ones NULL); work*: (B, N) scratch planes,
// needed only when N > tile * cluster. n is the padded row length N; tile,
// cluster, threads and smem the plan of ops/sort_kernel.py sort_plan.
// *launches receives the number of kernel launches made. Returns a
// cudaError_t, or -1 when the device cannot place the cluster.
extern "C" int rvt_sort(const int* in0, const int* in1, const int* in2,
                        int* work0, int* work1, int* work2, int* out0,
                        int* out1, int* out2, int* launches, int b, int k,
                        int n, int nops, int nkeys, int tile, int cluster,
                        int threads, int smem, int device,
                        cudaStream_t stream) {
  *launches = 0;
  cudaSetDevice(device);
  if (b == 0) return 0;
  // the layout: E elements a thread, a stride >= tile only once a warp's
  // span fits in the tile, the planes' padded tiles in shared memory
  if (nops < 1 || nops > kMaxOps || nkeys < 1 || nkeys > nops || n < k ||
      !pow2(n) || !pow2(tile) || !pow2(cluster) || cluster > kMaxCluster ||
      tile * cluster > n || threads * kElems != tile ||
      threads > kMaxThreads || (cluster > 1 && tile < 32 * kElems) ||
      smem < (int)sizeof(int) * nops * plane_len(tile))
    return (int)cudaErrorInvalidValue;
  const CPlanes in = {{in0, in1, in2}};
  const Planes work = {{work0, work1, work2}};
  const Planes out = {{out0, out1, out2}};
  const Launch l = {b, tile, cluster, threads, (size_t)smem, stream};
  switch (nops * 4 + nkeys) {
    case 5: return sort_rows<1, 1>(l, device, in, work, out, k, n, launches);
    case 9: return sort_rows<2, 1>(l, device, in, work, out, k, n, launches);
    case 10: return sort_rows<2, 2>(l, device, in, work, out, k, n, launches);
    case 13: return sort_rows<3, 1>(l, device, in, work, out, k, n, launches);
    case 14: return sort_rows<3, 2>(l, device, in, work, out, k, n, launches);
    case 15: return sort_rows<3, 3>(l, device, in, work, out, k, n, launches);
  }
  return (int)cudaErrorInvalidValue;
}

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
// 131,072. The TPU runs the whole bitonic network on a (N/128, 128) plane
// held in VMEM, each partner exchange a pair of rotates. Here a row does
// not fit a block's shared memory (3 planes of 131,072 int32 are 1.5 MB
// against 227 KB), so the same network runs in two kinds of launches:
//   - sort_tile_kernel: a tile of T = min(N, 4096) consecutive elements of
//     one row (3 planes x 4096 x 4 B = 48 KB of shared memory) runs every
//     compare-exchange step of the given stages whose stride is below T;
//   - sort_step_kernel: one compare-exchange step in device memory, one
//     thread per pair, for each stride >= T.
// The network, its direction rule (ascending where bit `size` of the
// element's index is 0) and its swap rule (exchange only on strict
// less-than) are those of the TPU kernel, so the output equals sort_tpu's
// bit for bit, payload order of equal keys included.
//
// Bound on the H100: bytes. The least work reads every plane once and
// writes it once; this network makes log2(N/T)*(log2(N/T)+1)/2 device-
// memory passes (15 at K = 131,072) plus one tile pass per stage above T,
// each a read and a (conditional) write of the padded planes. A radix sort
// would move fewer bytes; making K9 fast is later work.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxOps = 3;
constexpr int kTile = 4096;

struct Planes {
  int* p[kMaxOps];
};

struct CPlanes {
  const int* p[kMaxOps];
};

// a < b, lexicographic over the first nkeys planes
__device__ __forceinline__ bool lex_less(const int* a, const int* b,
                                         int nkeys) {
  for (int q = 0; q < nkeys; ++q) {
    if (a[q] != b[q]) return a[q] < b[q];
  }
  return false;
}

// The compare-exchange of the pair (lo, hi = lo + stride) at stage `size`:
// ascending where bit `size` of lo is 0; swap only on strict less-than.
__device__ __forceinline__ bool should_swap(const int* vlo, const int* vhi,
                                            int lo, int size, int nkeys) {
  const bool asc = (lo & size) == 0;
  return asc ? lex_less(vhi, vlo, nkeys) : lex_less(vlo, vhi, nkeys);
}

// One tile of T consecutive padded elements of row blockIdx.y: load (with
// the padding fill past `lim_in`), run stages size_lo..size_hi, each over
// strides min(size, T)/2 .. 1, store the slots below `lim_out`.
__global__ void sort_tile_kernel(CPlanes in, int ld_in, int lim_in,
                                 Planes out, int ld_out, int lim_out,
                                 int nops, int nkeys, int tile, int size_lo,
                                 int size_hi) {
  extern __shared__ int smem[];
  const int row = blockIdx.y;
  const int base = blockIdx.x * tile;
  for (int q = 0; q < nops; ++q) {
    const int* src = in.p[q] + (size_t)row * ld_in;
    const int fill = q < nkeys ? INT_MAX : 0;
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
      const int g = base + i;
      smem[q * tile + i] = g < lim_in ? src[g] : fill;
    }
  }
  for (int size = size_lo; size <= size_hi; size <<= 1) {
    for (int stride = min(size, tile) >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < tile / 2; t += blockDim.x) {
        const int lo = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
        const int hi = lo + stride;
        int a[kMaxOps], b[kMaxOps];
        for (int q = 0; q < nops; ++q) {
          a[q] = smem[q * tile + lo];
          b[q] = smem[q * tile + hi];
        }
        if (should_swap(a, b, base + lo, size, nkeys)) {
          for (int q = 0; q < nops; ++q) {
            smem[q * tile + lo] = b[q];
            smem[q * tile + hi] = a[q];
          }
        }
      }
    }
  }
  __syncthreads();
  for (int q = 0; q < nops; ++q) {
    int* dst = out.p[q] + (size_t)row * ld_out;
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
      const int g = base + i;
      if (g < lim_out) dst[g] = smem[q * tile + i];
    }
  }
}

// One compare-exchange step (stage `size`, stride >= T) over the padded
// (B, n) planes, one thread per pair.
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
  if (should_swap(a, b, lo, size, nkeys)) {
    for (int q = 0; q < nops; ++q) {
      w.p[q][off + lo] = b[q];
      w.p[q][off + hi] = a[q];
    }
  }
}

}  // namespace

// in*/out*: (B, K) planes (unused ones NULL); work*: (B, N) scratch planes,
// needed only when N > 4096. n is the padded row length N.
extern "C" int rvt_sort(const int* in0, const int* in1, const int* in2,
                        int* work0, int* work1, int* work2, int* out0,
                        int* out1, int* out2, int b, int k, int n, int nops,
                        int nkeys, int device, cudaStream_t stream) {
  cudaSetDevice(device);
  if (b == 0) return 0;
  if (nops < 1 || nops > kMaxOps || nkeys < 1 || nkeys > nops ||
      n < k || (n & (n - 1)) != 0 || n < 256)
    return (int)cudaErrorInvalidValue;
  const CPlanes in = {{in0, in1, in2}};
  const Planes work = {{work0, work1, work2}};
  const Planes out = {{out0, out1, out2}};
  const int tile = n < kTile ? n : kTile;
  const int threads = tile / 2 < 1024 ? tile / 2 : 1024;
  const size_t smem = sizeof(int) * (size_t)nops * tile;
  cudaError_t err = cudaFuncSetAttribute(
      sort_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 tiles(n / tile, b);
  if (n == tile) {  // the whole network in one tile
    sort_tile_kernel<<<tiles, threads, smem, stream>>>(
        in, k, k, out, k, k, nops, nkeys, tile, 2, n);
    return (int)cudaGetLastError();
  }
  sort_tile_kernel<<<tiles, threads, smem, stream>>>(
      in, k, k, work, n, n, nops, nkeys, tile, 2, tile);
  const CPlanes cwork = {{work0, work1, work2}};
  const int step_threads = 256;
  const dim3 steps((n / 2 + step_threads - 1) / step_threads, b);
  for (int size = 2 * tile; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride >= tile; stride >>= 1) {
      sort_step_kernel<<<steps, step_threads, 0, stream>>>(
          work, n, nops, nkeys, size, stride);
    }
    const bool last = size == n;
    sort_tile_kernel<<<tiles, threads, smem, stream>>>(
        cwork, n, n, last ? out : work, last ? k : n, last ? k : n, nops,
        nkeys, tile, size, size);
  }
  return (int)cudaGetLastError();
}

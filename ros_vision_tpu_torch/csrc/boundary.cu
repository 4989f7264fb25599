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
// elements, so a scatter to the target replaces the TPU's monotone
// routing, as in the Pallas kernel.
//
// Bound on the H100: memory and launch latency. Per 400x640 frame stage A
// reads the u8 threshold and i32 rank planes once (~1.3 MB) and writes a
// u8 bit plane; stage B touches only the <= 4 x p_cap candidates and the
// K output words. Design: per stage, a count launch (per-block totals of
// the valid flags, 1024 elements per block), a one-block-per-row scan of
// those totals, and a write launch that redoes the block-local scan, thins
// and scatters — exact exclusive counts with no global atomics and no
// sort; plus a fill launch for the unused tail. The stage-B key words are
// recomputed from the threshold and rank planes at the kept pixel instead
// of being carried through stage A as four i32 planes.
#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

constexpr int kRankBits = 11;
constexpr int kKeyInvalid = 1 << 22;
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

// BlobDiff bits of pixel (y, x) (quadfit.boundary_masks)
__device__ __forceinline__ int boundary_bits(const uint8_t* t, const int* r,
                                             int y, int x, int h, int w) {
  if (y < 1 || y > h - 2 || x < 1 || x > w - 2) return 0;
  const int p = y * w + x;
  const int v = t[p];
  if (r[p] <= 0) return 0;
  int mask = 0;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int q = p + kDy[d] * w + kDx[d];
    const int nv = t[q];
    if (v + nv == 255 && r[q] > 0) {
      mask |= 1 << d;
      if (nv > v) mask |= 1 << (4 + d);
    }
  }
  return mask;
}

// ---- stage A --------------------------------------------------------------

__global__ void bits_count_kernel(const uint8_t* __restrict__ thr,
                                  const int* __restrict__ ranks,
                                  uint8_t* maskbits, int* blk, int h, int w,
                                  int nblk) {
  const int b = blockIdx.y;
  const int n = h * w;
  const uint8_t* t = thr + (size_t)b * n;
  const int* r = ranks + (size_t)b * n;
  const int p0 = blockIdx.x * rvt::kScanTile + threadIdx.x * rvt::kScanItems;
  int c = 0;
  for (int j = 0; j < rvt::kScanItems; ++j) {
    const int p = p0 + j;
    if (p >= n) break;
    const int m = boundary_bits(t, r, p / w, p % w, h, w);
    maskbits[(size_t)b * n + p] = (uint8_t)m;
    c += (m & 0xF) != 0;
  }
  int tot;
  rvt::block_exclusive_scan(c, &tot);
  if (threadIdx.x == 0) blk[(size_t)b * (nblk + 1) + blockIdx.x] = tot;
}

__global__ void stage_a_write_kernel(const uint8_t* __restrict__ maskbits,
                                     const int* __restrict__ blk, int* pm,
                                     int h, int w, int nblk, int p_cap) {
  const int b = blockIdx.y;
  const int n = h * w;
  const uint8_t* mb = maskbits + (size_t)b * n;
  const int* off = blk + (size_t)b * (nblk + 1);
  const float r = thin_ratio(off[nblk], p_cap);
  const int p0 = blockIdx.x * rvt::kScanTile + threadIdx.x * rvt::kScanItems;
  int m[rvt::kScanItems];
  int c = 0;
  for (int j = 0; j < rvt::kScanItems; ++j) {
    m[j] = p0 + j < n ? mb[p0 + j] : 0;
    c += (m[j] & 0xF) != 0;
  }
  int tot;
  int slot = off[blockIdx.x] + rvt::block_exclusive_scan(c, &tot);
  for (int j = 0; j < rvt::kScanItems; ++j) {
    if ((m[j] & 0xF) == 0) continue;
    int tgt;
    if (thin_keep(slot, r, &tgt)) {
      const int p = p0 + j;
      pm[(size_t)b * p_cap + tgt] = ((((p / w) << 11) | (p % w)) << 8) | m[j];
    }
    ++slot;
  }
}

__global__ void stage_a_fill_kernel(const int* __restrict__ blk, int* pm,
                                    int nblk, int p_cap) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p_cap) return;
  if (i >= kept_total(blk[(size_t)b * (nblk + 1) + nblk], p_cap))
    pm[(size_t)b * p_cap + i] = -1;
}

// ---- stage B --------------------------------------------------------------

// candidate c of the dir-major stream: direction c / p_cap of slot c % p_cap
__device__ __forceinline__ bool cand_valid(const int* pm, int c, int p_cap,
                                           int* word, int* dir) {
  const int d = c / p_cap;
  const int v = pm[c - d * p_cap];
  *word = v;
  *dir = d;
  return v >= 0 && ((v >> d) & 1);
}

__global__ void stage_b_count_kernel(const int* __restrict__ pm, int* blk,
                                     int p_cap, int nblk) {
  const int b = blockIdx.y;
  const int m = 4 * p_cap;
  const int* row = pm + (size_t)b * p_cap;
  const int c0 = blockIdx.x * rvt::kScanTile + threadIdx.x * rvt::kScanItems;
  int c = 0;
  for (int j = 0; j < rvt::kScanItems; ++j) {
    int word, dir;
    if (c0 + j < m) c += cand_valid(row, c0 + j, p_cap, &word, &dir);
  }
  int tot;
  rvt::block_exclusive_scan(c, &tot);
  if (threadIdx.x == 0) blk[(size_t)b * (nblk + 1) + blockIdx.x] = tot;
}

__global__ void stage_b_write_kernel(const int* __restrict__ ranks,
                                     const int* __restrict__ pm,
                                     const int* __restrict__ blk, int* key,
                                     int* pack2, int h, int w, int p_cap,
                                     int k_cap, int nblk) {
  const int b = blockIdx.y;
  const int n = h * w;
  const int m = 4 * p_cap;
  const int* row = pm + (size_t)b * p_cap;
  const int* rk = ranks + (size_t)b * n;
  const int* off = blk + (size_t)b * (nblk + 1);
  const float r = thin_ratio(off[nblk], k_cap);
  const int c0 = blockIdx.x * rvt::kScanTile + threadIdx.x * rvt::kScanItems;
  int word[rvt::kScanItems], dir[rvt::kScanItems];
  bool ok[rvt::kScanItems];
  int c = 0;
  for (int j = 0; j < rvt::kScanItems; ++j) {
    ok[j] = c0 + j < m && cand_valid(row, c0 + j, p_cap, &word[j], &dir[j]);
    c += ok[j];
  }
  int tot;
  int slot = off[blockIdx.x] + rvt::block_exclusive_scan(c, &tot);
  for (int j = 0; j < rvt::kScanItems; ++j) {
    if (!ok[j]) continue;
    int tgt;
    if (thin_keep(slot, r, &tgt)) {
      const int d = dir[j];
      const int py = (word[j] >> 19) & 0x7FF;
      const int px = (word[j] >> 8) & 0x7FF;
      const int g = ((word[j] >> (4 + d)) & 1) ? 1 : -1;
      const int p = py * w + px;
      const int q = p + kDy[d] * w + kDx[d];
      const int ra = rk[p], rb = rk[q];
      const int lo = min(ra, rb) - 1, hi = max(ra, rb) - 1;
      const int x2 = 2 * px + kDx[d], y2 = 2 * py + kDy[d];
      const size_t o = (size_t)b * k_cap + tgt;
      key[o] = (lo << kRankBits) | hi;
      pack2[o] = (x2 << 15) | (y2 << 4) | ((kDx[d] * g + 1) << 2)
          | (kDy[d] * g + 1);
    }
    ++slot;
  }
}

__global__ void stage_b_fill_kernel(const int* __restrict__ blk, int* key,
                                    int* pack2, int* counts, int k_cap,
                                    int nblk) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int kept = kept_total(blk[(size_t)b * (nblk + 1) + nblk], k_cap);
  if (i == 0) counts[b] = kept;
  if (i >= k_cap || i < kept) return;
  key[(size_t)b * k_cap + i] = kKeyInvalid;
  pack2[(size_t)b * k_cap + i] = 0;
}

}  // namespace

extern "C" int rvt_boundary_compact(const uint8_t* thr, const int* ranks,
                                    uint8_t* maskbits, int* pm, int* blk_a,
                                    int* blk_b, int* key, int* pack2,
                                    int* counts, int b, int h, int w,
                                    int p_cap, int k_cap, int device,
                                    cudaStream_t stream) {
  cudaSetDevice(device);
  const int n = h * w;
  const int nblk_a = (n + rvt::kScanTile - 1) / rvt::kScanTile;
  const int nblk_b = (4 * p_cap + rvt::kScanTile - 1) / rvt::kScanTile;
  const int tf = 256;
  cudaError_t err;
#define RVT_CHECK()                                   \
  err = cudaGetLastError();                           \
  if (err != cudaSuccess) return (int)err

  bits_count_kernel<<<dim3(nblk_a, b), rvt::kScanThreads, 0, stream>>>(
      thr, ranks, maskbits, blk_a, h, w, nblk_a);
  RVT_CHECK();
  rvt::scan_rows_kernel<<<b, 1024, 0, stream>>>(blk_a, nblk_a);
  RVT_CHECK();
  stage_a_write_kernel<<<dim3(nblk_a, b), rvt::kScanThreads, 0, stream>>>(
      maskbits, blk_a, pm, h, w, nblk_a, p_cap);
  RVT_CHECK();
  stage_a_fill_kernel<<<dim3((p_cap + tf - 1) / tf, b), tf, 0, stream>>>(
      blk_a, pm, nblk_a, p_cap);
  RVT_CHECK();
  stage_b_count_kernel<<<dim3(nblk_b, b), rvt::kScanThreads, 0, stream>>>(
      pm, blk_b, p_cap, nblk_b);
  RVT_CHECK();
  rvt::scan_rows_kernel<<<b, 1024, 0, stream>>>(blk_b, nblk_b);
  RVT_CHECK();
  stage_b_write_kernel<<<dim3(nblk_b, b), rvt::kScanThreads, 0, stream>>>(
      ranks, pm, blk_b, key, pack2, h, w, p_cap, k_cap, nblk_b);
  RVT_CHECK();
  stage_b_fill_kernel<<<dim3((k_cap + tf - 1) / tf, b), tf, 0, stream>>>(
      blk_b, key, pack2, counts, k_cap, nblk_b);
  RVT_CHECK();
#undef RVT_CHECK
  return 0;
}

// K1: fused adaptive threshold, gray (B,H,W) u8 -> decim, threshim
// (B,H/2,W/2) u8.
//
// Replaces ros_vision_tpu/ops/threshold_pallas.py adaptive_threshold_fused
// (pallas_call at :122, kernel body _make_kernel:83). Same integer rule as
// ros_vision_tpu/ops/threshold.py and the reference chain threshold.cu:
// 151-201: 2x point decimation, 4x4 tile min/max, 3x3 edge-clamped tile
// dilation, {0,127,255} threshold with min_white_black_diff.
//
// Bound on the H100: device memory. The stage does a few integer compares
// per pixel and touches 1.25 bytes per full-res pixel (the even rows'
// bytes it samples plus two decimated writes), so its floor is a few
// microseconds per 1280x800 frame at 3.35 TB/s; launch overhead is the
// same order. Design: one launch; block (band, b) takes `band` tile rows
// (a tile is 4x4 decimated = 8x8 full-res pixels) of frame b with one tile
// row of halo above and below, recomputed here (at the frame's own
// borders the missing halo row holds the neutral min 255 / max 0, which
// equals edge clamping). A thread takes two tiles of a tile row: four
// 16-byte loads of its even rows (8-byte for a lone last tile when
// W % 16 == 8; byte loads when the frame's pointer is not 16-byte
// aligned; even rows always start 16-byte aligned then, since H and W
// are multiples of 8), picks the even bytes with __byte_perm and reduces
// the tile's min/max with __vminu4/__vmaxu4. The band's decimated words
// go to decim at once and to shared memory with the tiles' min/max
// (padded by a neutral column on each side); after one __syncthreads each
// thread takes one tile of the band, dilates from shared memory and
// writes four threshim words (__vcmpgtu4 against the tile's threshold).
//
// The launch plan (band, bands, threads, shared bytes) is
// ops/threshold_kernel.py threshold_plan's; rvt_adaptive_threshold takes
// it as given and checks only what the kernel's layout requires.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kDefaultSmem = 48 * 1024;  // a block's shared memory, no opt-in

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// shared bytes of a band: tile min and max of band + 2 rows of tw + 2
// tiles, then one word per tile and decimated row of the band
__host__ __device__ constexpr int smem_need(int band, int tw) {
  return round16(2 * (band + 2) * (tw + 2)) + 16 * band * tw;
}

// the even bytes of (a, b): a.b0, a.b2, b.b0, b.b2
__device__ __forceinline__ uint32_t even_bytes(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x6420);
}

__device__ __forceinline__ uint32_t even_bytes_scalar(const uint8_t* p) {
  return (uint32_t)p[0] | (uint32_t)p[2] << 8 | (uint32_t)p[4] << 16
      | (uint32_t)p[6] << 24;
}

__device__ __forceinline__ int byte_min(uint32_t x) {
  x = __vminu4(x, x >> 16);
  return __vminu4(x, x >> 8) & 0xFF;
}

__device__ __forceinline__ int byte_max(uint32_t x) {
  x = __vmaxu4(x, x >> 16);
  return __vmaxu4(x, x >> 8) & 0xFF;
}

__global__ void __launch_bounds__(kMaxThreads)
    threshold_band_kernel(const uint8_t* __restrict__ gray,
                          uint8_t* __restrict__ decim,
                          uint8_t* __restrict__ threshim, int h, int w,
                          int band, int min_white_black_diff) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int th = h / 8, tw = w / 8, h2 = h / 2, w2 = w / 2;
  const int b = blockIdx.y;
  const int ty0 = blockIdx.x * band;
  const int nb = min(band, th - ty0);       // tile rows of this band
  const int rows = nb + 2;                  // with the halo rows
  const int pw = tw + 2;                    // with the neutral columns
  uint8_t* tmin = smem;
  uint8_t* tmax = smem + rows * pw;
  uint32_t* samp = reinterpret_cast<uint32_t*>(smem + round16(2 * rows * pw));
  const uint8_t* g = gray + (size_t)b * h * w;
  const bool vec = (reinterpret_cast<uintptr_t>(gray) & 15) == 0;
  const int pairs = (tw + 1) / 2;

  for (int k = threadIdx.x; k < rows; k += blockDim.x) {
    tmin[k * pw] = tmin[k * pw + pw - 1] = 255;
    tmax[k * pw] = tmax[k * pw + pw - 1] = 0;
  }
  for (int item = threadIdx.x; item < rows * pairs; item += blockDim.x) {
    const int k = item / pairs, tp = item - k * pairs;
    const int ty = ty0 - 1 + k;
    const int t0 = 2 * tp;
    const bool two = t0 + 1 < tw;
    if (ty < 0 || ty >= th) {               // beyond the frame: neutral
      tmin[k * pw + 1 + t0] = 255;
      tmax[k * pw + 1 + t0] = 0;
      if (two) {
        tmin[k * pw + 2 + t0] = 255;
        tmax[k * pw + 2 + t0] = 0;
      }
      continue;
    }
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint8_t* row = g + (size_t)(ty * 8 + 2 * i) * w + 16 * tp;
      if (vec && two) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(row));
        lo[i] = even_bytes(q.x, q.y);
        hi[i] = even_bytes(q.z, q.w);
      } else if (vec) {
        const uint2 q = __ldg(reinterpret_cast<const uint2*>(row));
        lo[i] = even_bytes(q.x, q.y);
        hi[i] = 0;
      } else {
        lo[i] = even_bytes_scalar(row);
        hi[i] = two ? even_bytes_scalar(row + 8) : 0;
      }
    }
    const uint32_t mn_lo = __vminu4(__vminu4(lo[0], lo[1]),
                                    __vminu4(lo[2], lo[3]));
    const uint32_t mx_lo = __vmaxu4(__vmaxu4(lo[0], lo[1]),
                                    __vmaxu4(lo[2], lo[3]));
    tmin[k * pw + 1 + t0] = (uint8_t)byte_min(mn_lo);
    tmax[k * pw + 1 + t0] = (uint8_t)byte_max(mx_lo);
    if (two) {
      const uint32_t mn_hi = __vminu4(__vminu4(hi[0], hi[1]),
                                      __vminu4(hi[2], hi[3]));
      const uint32_t mx_hi = __vmaxu4(__vmaxu4(hi[0], hi[1]),
                                      __vmaxu4(hi[2], hi[3]));
      tmin[k * pw + 2 + t0] = (uint8_t)byte_min(mn_hi);
      tmax[k * pw + 2 + t0] = (uint8_t)byte_max(mx_hi);
    }
    if (k >= 1 && k <= nb) {                // a tile row of the band
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int y2 = ty * 4 + i;
        uint32_t* drow = reinterpret_cast<uint32_t*>(
            decim + ((size_t)b * h2 + y2) * w2);
        uint32_t* srow = samp + ((k - 1) * 4 + i) * tw;
        drow[t0] = lo[i];
        srow[t0] = lo[i];
        if (two) {
          drow[t0 + 1] = hi[i];
          srow[t0 + 1] = hi[i];
        }
      }
    }
  }
  __syncthreads();
  for (int item = threadIdx.x; item < nb * tw; item += blockDim.x) {
    const int k = item / tw, t = item - k * tw;
    int mn = 255, mx = 0;
#pragma unroll
    for (int dk = 0; dk < 3; ++dk) {
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) {
        const int s = (k + dk) * pw + t + dt;
        mn = min(mn, (int)tmin[s]);
        mx = max(mx, (int)tmax[s]);
      }
    }
    const int spread = mx - mn;
    const uint32_t thresh = (uint32_t)(mn + spread / 2);  // spread >= 0
    const bool flat = spread < min_white_black_diff;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t v = samp[(k * 4 + i) * tw + t];
      // strict v > thresh, per byte: 0xFF where greater
      const uint32_t out = flat ? 0x7F7F7F7Fu : __vcmpgtu4(v, thresh * 0x01010101u);
      const int y2 = (ty0 + k) * 4 + i;
      reinterpret_cast<uint32_t*>(threshim + ((size_t)b * h2 + y2) * w2)[t] =
          out;
    }
  }
}

}  // namespace

// gray (B, H, W) u8 -> decim, threshim (B, H/2, W/2) u8; band, bands,
// threads and smem the plan of ops/threshold_kernel.py threshold_plan.
// *launches receives the number of kernel launches made. Returns a
// cudaError_t.
extern "C" int rvt_adaptive_threshold(const uint8_t* gray, uint8_t* decim,
                                      uint8_t* threshim, int* launches,
                                      int b, int h, int w,
                                      int min_white_black_diff, int band,
                                      int bands, int threads, int smem,
                                      int device, cudaStream_t stream) {
  *launches = 0;
  cudaSetDevice(device);
  if (b == 0) return 0;
  // whole tiles; bands that cover the tile rows, none empty; whole warps;
  // decim and threshim rows of whole words (W/2 % 4 == 0)
  const int th = h / 8, tw = w / 8;
  if (b < 0 || b > 65535 || h < 8 || w < 8 || h % 8 != 0 || w % 8 != 0 ||
      band < 1 || bands != (th + band - 1) / band || threads < 32 ||
      threads % 32 != 0 || threads > kMaxThreads ||
      smem != smem_need(band, tw) || smem > kDefaultSmem ||
      (reinterpret_cast<uintptr_t>(decim) & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(threshim) & 3) != 0)
    return (int)cudaErrorInvalidValue;
  threshold_band_kernel<<<dim3(bands, b), threads, smem, stream>>>(
      gray, decim, threshim, h, w, band, min_white_black_diff);
  const cudaError_t rc = cudaGetLastError();
  *launches = rc == cudaSuccess;
  return (int)rc;
}

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
// [0, N); labels outside [0, N) are not counted. The TPU builds (2048, 512)
// one-hot planes and multiplies them on the MXU because it has no
// scatter-add. Bound on the H100: atomics on the few roots of large
// components (the background takes ~10^5 pixels of a frame). Design: one
// thread per label, lanes grouped by label with __match_any_sync, one
// atomicAdd of the group's popcount per group, into a zeroed (B, N) table.
//
// K8 replaces ccl_pallas.py propagate (pallas_call at :405, kernel body
// _kernel:49): exactly n_sweeps Jacobi sweeps of the masked 8-neighbour
// min, each reading only the previous sweep's labels (a masked-out
// neighbour offers 2^30). The TPU keeps the image in VMEM and sweeps
// in-kernel. Bound on the H100: one launch per sweep, each a pass over
// 4 bytes of labels read (neighbours hit L1/L2) and written per pixel plus
// one byte of mask. Design: the eight eligibility bits are built once per
// call into a (B, H*W) byte plane, then one launch per sweep over
// ping-pong buffers; the last sweep lands in `out`.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "unionfind.cuh"

namespace {

constexpr int kBig = 1 << 30;          // ccl_pallas._BIG
constexpr int kThreads = 256;

// (dy, dx) of ccl_pallas._OFFSETS; directions 4..7 are diagonal
__constant__ int kDy[8] = {0, 0, -1, 1, -1, -1, 1, 1};
__constant__ int kDx[8] = {-1, 1, 0, 0, -1, 1, -1, 1};

__global__ void root_broadcast_kernel(const int* __restrict__ labels,
                                      const int* __restrict__ rootmin,
                                      int* out, int n, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  out[i] = min(rootmin[(size_t)(i / n) * n + labels[i]], kBig);
}

__global__ void label_hist_kernel(const int* __restrict__ labels,
                                  int* counts, int n, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lab = i < total ? labels[i] : -1;
  const bool in = lab >= 0 && lab < n;
  const int key = in ? (i / n) * n + lab : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  if (in && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(counts + key, __popc(peers));
}

// bit k of mask[b, p]: neighbour k of p is in the frame and connected to p
__global__ void sweep_mask_kernel(const uint8_t* __restrict__ thr,
                                  uint8_t* mask, int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  const size_t base = (size_t)blockIdx.z * h * w;
  const uint8_t* t = thr + base;
  const int p = y * w + x;
  const int v = t[p];
  unsigned bits = 0;
  if (v != 127) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int ny = y + kDy[k], nx = x + kDx[k];
      const bool ok = ny >= 0 && ny < h && nx >= 0 && nx < w &&
                      t[ny * w + nx] == v && (k < 4 || v == 255);
      bits |= (unsigned)ok << k;
    }
  }
  mask[base + p] = (uint8_t)bits;
}

__global__ void sweep_kernel(const uint8_t* __restrict__ mask,
                             const int* __restrict__ src, int* dst, int h,
                             int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  const size_t base = (size_t)blockIdx.z * h * w;
  const int* s = src + base;
  const int p = y * w + x;
  const unsigned bits = mask[base + p];
  int m = s[p];
  if (bits != 0xFFu) m = min(m, kBig);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if ((bits >> k) & 1u) m = min(m, s[(y + kDy[k]) * w + x + kDx[k]]);
  dst[base + p] = m;
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

extern "C" int rvt_label_histogram(const int* labels, int* counts, int b,
                                   int n, int device, cudaStream_t stream) {
  cudaSetDevice(device);
  const int total = b * n;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)total,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  label_hist_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                      stream>>>(labels, counts, n, total);
  return (int)cudaGetLastError();
}

extern "C" int rvt_propagate(const uint8_t* thr, const int* labels,
                             uint8_t* mask, int* scratch, int* out, int b,
                             int h, int w, int n_sweeps, int device,
                             cudaStream_t stream) {
  cudaSetDevice(device);
  if (n_sweeps == 0)
    return (int)cudaMemcpyAsync(out, labels, sizeof(int) * (size_t)b * h * w,
                                cudaMemcpyDeviceToDevice, stream);
  const dim3 grid((w + 127) / 128, h, b);
  sweep_mask_kernel<<<grid, 128, 0, stream>>>(thr, mask, h, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // sweep s writes dst[s % 2]; the buffers are ordered so that the last
  // sweep (s = n_sweeps - 1) writes `out`
  int* dst[2] = {out, scratch};
  if (n_sweeps % 2 == 0) {
    dst[0] = scratch;
    dst[1] = out;
  }
  const int* src = labels;
  for (int s = 0; s < n_sweeps; ++s) {
    sweep_kernel<<<grid, 128, 0, stream>>>(mask, src, dst[s % 2], h, w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = dst[s % 2];
  }
  return 0;
}

RVT_HOPS_EXPORT(rvt_propagate_fixpoint_hops)

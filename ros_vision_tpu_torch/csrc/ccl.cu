// K2: connected components of the threshold image -> per-pixel dense blob
// ranks (and, for tests, labels and component sizes).
//
// Replaces ros_vision_tpu/ops/frontend_pallas.py rank_image (pallas_call
// at :505, kernel body _make_rank_kernel:353). Contract of
// ros_vision_tpu/ops/ccl.py label_components: 4-way connectivity for 0,
// 8-way for 255 (diagonals join only 255 pixels), 127 pixels are
// singletons; each label is the minimum flat pixel index of its
// component; ranks run 1..max_blobs over components of >= min_blob
// pixels in root order, 0 elsewhere.
//
// Bound on the H100: latency of dependent memory accesses, not bandwidth.
// The TPU kernel min-floods labels to fixpoint (~200-300 full-frame sweeps
// on a noisy 400x640 frame) because the TPU has no fast atomics. Here the
// union-find of the reference (labeling_allegretti_2019_BKE.cu) replaces
// the flood (unionfind.cuh, shared with flood.cu): init, then one merge
// launch in which every pixel unions itself with its
// already-visited neighbours (left, up, and for white up-left / up-right)
// by an atomicMin loop that always links the larger root under the
// smaller, so every root is its component's minimum flat index; one
// path-compression launch; sizes by atomicAdd at the root (warp-aggregated
// with __match_any_sync, because the background component takes a large
// share of the frame and would serialise a single address); ranks by a
// hand-written exclusive scan of is_big_root in flat order (per-block
// counts, one block per row scanning them, then the write); one broadcast
// launch rank[p] = rank_at_root[label[p]]. Eight launches per call, each a
// single pass over the (B, H*W) planes.
#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"
#include "unionfind.cuh"

namespace {

// size_root[b, label] += 1 per pixel; lanes of a warp that share a label
// add once through their leader.
__global__ void size_kernel(const int* __restrict__ labels, int* size_root,
                            int n, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < total;
  const int key = active ? (i / n) * n + labels[i] : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  if (active && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(size_root + key, __popc(peers));
}

__device__ __forceinline__ int big_root(const int* L, const int* S, int p,
                                        int n, int min_blob) {
  return (p < n && L[p] == p && S[p] >= min_blob) ? 1 : 0;
}

__global__ void rank_count_kernel(const int* __restrict__ labels,
                                  const int* __restrict__ size_root,
                                  int* block_counts, int n, int nblk,
                                  int min_blob) {
  const int b = blockIdx.y;
  const int* L = labels + (size_t)b * n;
  const int* S = size_root + (size_t)b * n;
  const int p0 = blockIdx.x * rvt::kScanTile + threadIdx.x * rvt::kScanItems;
  int c = 0;
  for (int j = 0; j < rvt::kScanItems; ++j)
    c += big_root(L, S, p0 + j, n, min_blob);
  int tot;
  rvt::block_exclusive_scan(c, &tot);
  if (threadIdx.x == 0)
    block_counts[(size_t)b * (nblk + 1) + blockIdx.x] = tot;
}

__global__ void rank_write_kernel(const int* __restrict__ labels,
                                  const int* __restrict__ size_root,
                                  const int* __restrict__ block_offsets,
                                  int* rank_root, int n, int nblk,
                                  int min_blob, int max_blobs) {
  const int b = blockIdx.y;
  const int* L = labels + (size_t)b * n;
  const int* S = size_root + (size_t)b * n;
  int* R = rank_root + (size_t)b * n;
  const int p0 = blockIdx.x * rvt::kScanTile + threadIdx.x * rvt::kScanItems;
  int f[rvt::kScanItems];
  int c = 0;
  for (int j = 0; j < rvt::kScanItems; ++j) {
    f[j] = big_root(L, S, p0 + j, n, min_blob);
    c += f[j];
  }
  int tot;
  int r = block_offsets[(size_t)b * (nblk + 1) + blockIdx.x]
      + rvt::block_exclusive_scan(c, &tot);
  for (int j = 0; j < rvt::kScanItems; ++j) {
    if (p0 + j >= n) break;
    r += f[j];                              // inclusive count at p0 + j
    R[p0 + j] = (f[j] && r <= max_blobs) ? r : 0;
  }
}

__global__ void broadcast_kernel(const int* __restrict__ labels,
                                 const int* __restrict__ rank_root,
                                 const int* __restrict__ size_root,
                                 int* ranks, int* sizes, int n, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const size_t root = (size_t)(i / n) * n + labels[i];
  ranks[i] = rank_root[root];
  if (sizes != nullptr) sizes[i] = size_root[root];
}

}  // namespace

extern "C" int rvt_rank_image(const uint8_t* thr, int* labels,
                              int* size_root, int* rank_root,
                              int* block_counts, int* ranks, int* sizes,
                              int b, int h, int w, int min_blob,
                              int max_blobs, int device,
                              cudaStream_t stream) {
  cudaSetDevice(device);
  const int n = h * w;
  const int total = b * n;
  const int t1 = 256;
  const int g1 = (total + t1 - 1) / t1;
  const int nblk = (n + rvt::kScanTile - 1) / rvt::kScanTile;
  cudaError_t err;
#define RVT_CHECK()                                   \
  err = cudaGetLastError();                           \
  if (err != cudaSuccess) return (int)err

  err = rvt::label_pixels(thr, labels, b, h, w, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(size_root, 0, sizeof(int) * (size_t)total, stream);
  if (err != cudaSuccess) return (int)err;
  size_kernel<<<g1, t1, 0, stream>>>(labels, size_root, n, total);
  RVT_CHECK();
  rank_count_kernel<<<dim3(nblk, b), rvt::kScanThreads, 0, stream>>>(
      labels, size_root, block_counts, n, nblk, min_blob);
  RVT_CHECK();
  rvt::scan_rows_kernel<<<b, 1024, 0, stream>>>(block_counts, nblk);
  RVT_CHECK();
  rank_write_kernel<<<dim3(nblk, b), rvt::kScanThreads, 0, stream>>>(
      labels, size_root, block_counts, rank_root, n, nblk, min_blob,
      max_blobs);
  RVT_CHECK();
  broadcast_kernel<<<g1, t1, 0, stream>>>(labels, rank_root, size_root,
                                          ranks, sizes, n, total);
  RVT_CHECK();
#undef RVT_CHECK
  return 0;
}

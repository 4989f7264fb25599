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
// Bound on the H100: latency of dependent memory accesses and atomics on
// shared roots, not bandwidth (the bytes are ~1.5 us at B=4 640x400). The
// TPU kernel min-floods labels to fixpoint (~200-300 full-frame sweeps on
// a noisy 400x640 frame) because the TPU has no fast atomics. Here the
// labels and the sizes come from the two-level union-find of
// unionfind.cuh (tiles in shared memory, global atomics only at tile
// borders; 3 launches, the sizes accumulated per tile and added once per
// tile and component), then the ranks by a hand-written exclusive scan of
// is_big_root in flat order: one launch counts per block of 1,024 pixels
// and its last block to finish scans the row's counts, one writes
// rank_at_root, one broadcasts rank[p] = rank_at_root[label[p]]. Six
// launches per call.
//
// Measured (scripts/mb_torch_ccl_phases.py, NVIDIA H100 80GB HBM3,
// 700.00 W, B=4 640x400 bench planes, device ms summed over the launches):
// the one-level union-find of the earlier design took 0.412 in 9 device
// operations, 0.351 of it in its merge launch (4.2 finds and 14.2 hops a
// pixel, up to 131 hops in one find); this design 0.060 in 6: tile 0.022,
// border 0.010, finalize 0.010, count 0.006, write 0.008, broadcast
// 0.006. What bounds it now is the tile phase's unions in shared memory
// (0.39 a pixel on the noisy bench planes).
#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"
#include "unionfind.cuh"

namespace {

__device__ __forceinline__ int big_root(const int* L, const int* S, int p,
                                        int n, int min_blob) {
  return (p < n && L[p] == p && S[p] >= min_blob) ? 1 : 0;
}

// block_counts[b, blk] = the big roots in pixels [1024 blk, 1024 blk +
// 1024); the row's last block to finish (done[b] counts them, zeroed by
// phase A) turns the row into its exclusive prefix.
__global__ void rank_count_kernel(const int* __restrict__ labels,
                                  const int* __restrict__ size_root,
                                  int* block_counts, int* done, int n,
                                  int nblk, int min_blob) {
  __shared__ bool last;
  const int b = blockIdx.y;
  const int* L = labels + (size_t)b * n;
  const int* S = size_root + (size_t)b * n;
  const int p0 = blockIdx.x * rvt::kScanTile + threadIdx.x * rvt::kScanItems;
  int c = 0;
  for (int j = 0; j < rvt::kScanItems; ++j)
    c += big_root(L, S, p0 + j, n, min_blob);
  int tot;
  rvt::block_exclusive_scan(c, &tot);
  int* row = block_counts + (size_t)b * (nblk + 1);
  if (threadIdx.x == 0) {
    row[blockIdx.x] = tot;
    __threadfence();
    last = atomicAdd(done + b, 1) == nblk - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  rvt::scan_row(row, nblk);
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

// threshim (B, h, w) -> labels, size_root, rank_root, ranks and (unless
// null) sizes, each (B, h*w). block_counts holds B * (nblk + 1) + B ints,
// nblk = ceil(h*w / 1024): the rows of block counts, then one counter per
// frame. tile_h .. smem are ops/ccl_kernel.py ccl_plan's. *launches gets
// the launches made. Returns a cudaError_t.
extern "C" int rvt_rank_image(const uint8_t* thr, int* labels,
                              int* size_root, int* rank_root,
                              int* block_counts, int* ranks, int* sizes,
                              int* launches, int b, int h, int w,
                              int min_blob, int max_blobs, int tile_h,
                              int tile_w, int tiles_x, int tiles_y,
                              int threads, int border_threads, int smem,
                              int device, cudaStream_t stream) {
  *launches = 0;
  cudaSetDevice(device);
  const rvt::TilePlan plan{tile_h, tile_w, tiles_x, tiles_y, threads,
                           border_threads, smem};
  if (!rvt::plan_ok(plan, b, h, w)) return (int)cudaErrorInvalidValue;
  const int n = h * w;
  const int total = b * n;
  const int t1 = 256;
  const int nblk = (n + rvt::kScanTile - 1) / rvt::kScanTile;
  int* done = block_counts + (size_t)b * (nblk + 1);
  // rank_root holds the union-find's forest until rank_write_kernel
  // overwrites all of it
  cudaError_t err = rvt::label_tiles<false>(thr, nullptr, rank_root, labels,
                                            size_root, done, b, h, w, plan,
                                            launches, stream);
  if (err != cudaSuccess) return (int)err;
#define RVT_CHECK()                                   \
  err = cudaGetLastError();                           \
  if (err != cudaSuccess) return (int)err;            \
  ++*launches

  rank_count_kernel<<<dim3(nblk, b), rvt::kScanThreads, 0, stream>>>(
      labels, size_root, block_counts, done, n, nblk, min_blob);
  RVT_CHECK();
  rank_write_kernel<<<dim3(nblk, b), rvt::kScanThreads, 0, stream>>>(
      labels, size_root, block_counts, rank_root, n, nblk, min_blob,
      max_blobs);
  RVT_CHECK();
  broadcast_kernel<<<(total + t1 - 1) / t1, t1, 0, stream>>>(
      labels, rank_root, size_root, ranks, sizes, n, total);
  RVT_CHECK();
#undef RVT_CHECK
  return 0;
}

RVT_HOPS_EXPORT(rvt_rank_image_hops)

// Union-find labelling of a {0, 127, 255} threshold image, shared by
// ccl.cu (K2) and flood.cu (K6). Contract of ros_vision_tpu/ops/ccl.py
// label_components: 4-way connectivity for 0, 8-way for 255 (diagonals
// join only 255 pixels), 127 pixels are singletons. After init, merge and
// compress, labels[b, p] is the minimum flat pixel index of p's component.
//
// merge: every pixel unions itself with its already-visited neighbours
// (left, up, and for white up-left / up-right) by an atomicMin loop that
// always links the larger root under the smaller, so every root is its
// component's minimum flat index. compress: one pointer chase per pixel.
// Reads inside the union loop go through L2 (__ldcg): the labels change
// under atomics from other SMs.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace rvt {
namespace {   // internal linkage: included by several .cu files

__device__ __forceinline__ int uf_find(const int* L, int x) {
  int p = __ldcg(L + x);
  while (p != x) {
    x = p;
    p = __ldcg(L + x);
  }
  return x;
}

__device__ void uf_union(int* L, int a, int b) {
  bool done;
  do {
    a = uf_find(L, a);
    b = uf_find(L, b);
    if (a < b) {
      const int old = atomicMin(L + b, a);
      done = (old == b);
      b = old;
    } else if (b < a) {
      const int old = atomicMin(L + a, b);
      done = (old == a);
      a = old;
    } else {
      done = true;
    }
  } while (!done);
}

__global__ void init_kernel(int* labels, int n, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) labels[i] = i % n;
}

__global__ void merge_kernel(const uint8_t* __restrict__ thr, int* labels,
                             int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= w) return;
  const size_t base = (size_t)b * h * w;
  const uint8_t* t = thr + base;
  int* L = labels + base;
  const int p = y * w + x;
  const int v = t[p];
  if (v == 127) return;
  if (x > 0 && t[p - 1] == v) uf_union(L, p, p - 1);
  if (y > 0) {
    if (t[p - w] == v) uf_union(L, p, p - w);
    if (v == 255) {
      if (x > 0 && t[p - w - 1] == 255) uf_union(L, p, p - w - 1);
      if (x + 1 < w && t[p - w + 1] == 255) uf_union(L, p, p - w + 1);
    }
  }
}

__global__ void compress_kernel(int* labels, int n, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int* L = labels + (size_t)(i / n) * n;
  L[i % n] = uf_find(L, i % n);
}

// The three launches above, in order, on `stream`: labels (B, h*w) of the
// (B, h, w) threshold image. Returns cudaGetLastError().
inline cudaError_t label_pixels(const uint8_t* thr, int* labels, int b,
                                int h, int w, cudaStream_t stream) {
  const int n = h * w;
  const int total = b * n;
  const int t1 = 256;
  const int g1 = (total + t1 - 1) / t1;
  init_kernel<<<g1, t1, 0, stream>>>(labels, n, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<<<dim3((w + 127) / 128, h, b), 128, 0, stream>>>(thr, labels,
                                                                 h, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  compress_kernel<<<g1, t1, 0, stream>>>(labels, n, total);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rvt

// Shared pieces of the kat_tpu_torch kernels: the key sentinel, the error
// convention of the C entry points, warp/block/array scans, and the merge
// path search.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Keys are int64 k-mers (k <= 31, so at most 62 bits); INT64_MAX marks
// invalid windows and padding and sorts after every real key.
#define KAT_SENTINEL 0x7FFFFFFFFFFFFFFFLL

// Every C entry point returns cudaGetLastError() after each launch, so a
// refused launch (bad configuration, too much shared memory) is reported
// to the Python wrapper, which raises.
#define KAT_CHECK_LAUNCH()                              \
  do {                                                  \
    cudaError_t kat_err_ = cudaGetLastError();          \
    if (kat_err_ != cudaSuccess) return (int)kat_err_;  \
  } while (0)

namespace kat {

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    T u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// Exclusive scan of one value per thread across the block (blockDim.x a
// multiple of 32).  Every thread of the block must call it; *total gets
// the block's sum.
template <typename T>
__device__ __forceinline__ T block_exclusive_scan(T v, T* total) {
  __shared__ T warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  T inc = warp_inclusive_scan(v);
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T s = lane < nw ? warp_sums[lane] : T(0);
    s = warp_inclusive_scan(s);
    if (lane < nw) warp_sums[lane] = s;
  }
  __syncthreads();
  T off = warp ? warp_sums[warp - 1] : T(0);
  *total = warp_sums[nw - 1];
  __syncthreads();  // warp_sums may be reused by the next call
  return off + inc - v;
}

// Merge path: the number of a-elements among the first `diag` outputs of
// the stable merge of sorted a[0:na) and b[0:nb) (a first on ties).
__device__ __forceinline__ int64_t merge_path(const int64_t* __restrict__ a,
                                              int64_t na,
                                              const int64_t* __restrict__ b,
                                              int64_t nb, int64_t diag) {
  int64_t lo = diag > nb ? diag - nb : 0;
  int64_t hi = diag < na ? diag : na;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] <= b[diag - 1 - mid]) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 8;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;  // elements per block

// Device-wide exclusive scan, phase 1: each block sums its SCAN_TILE slice.
template <typename T>
__global__ void __launch_bounds__(SCAN_THREADS)
scan_tile_sums(const T* data, int64_t n, T* partials) {
  const int64_t base = (int64_t)blockIdx.x * SCAN_TILE;
  T s = 0;
  for (int i = threadIdx.x; i < SCAN_TILE; i += SCAN_THREADS) {
    const int64_t g = base + i;
    if (g < n) s += data[g];
  }
  T total;
  block_exclusive_scan(s, &total);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// Phase 2 (and any short array): one block scans `data` in place, carrying
// the running sum from chunk to chunk; *total (if given) gets the sum.
template <typename T>
__global__ void __launch_bounds__(1024)
scan_single_block(T* data, int64_t n, T* total) {
  __shared__ T carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  constexpr int ITEMS = 4;
  const int64_t chunk = (int64_t)blockDim.x * ITEMS;
  for (int64_t base = 0; base < n; base += chunk) {
    const int64_t first = base + (int64_t)threadIdx.x * ITEMS;
    T v[ITEMS];
    T s = 0;
#pragma unroll
    for (int e = 0; e < ITEMS; e++) {
      v[e] = first + e < n ? data[first + e] : T(0);
      s += v[e];
    }
    T tot;
    T ex = block_exclusive_scan(s, &tot) + carry;
#pragma unroll
    for (int e = 0; e < ITEMS; e++) {
      if (first + e < n) data[first + e] = ex;
      ex += v[e];
    }
    __syncthreads();  // every thread has read carry
    if (threadIdx.x == 0) carry += tot;
    __syncthreads();
  }
  if (threadIdx.x == 0 && total != nullptr) *total = carry;
}

// Phase 3: each block scans its slice in place, starting from its partial.
template <typename T>
__global__ void __launch_bounds__(SCAN_THREADS)
scan_tile_apply(T* data, int64_t n, const T* partials) {
  __shared__ T tile[SCAN_TILE];
  const int64_t base = (int64_t)blockIdx.x * SCAN_TILE;
  for (int i = threadIdx.x; i < SCAN_TILE; i += SCAN_THREADS) {
    const int64_t g = base + i;
    tile[i] = g < n ? data[g] : T(0);
  }
  __syncthreads();
  T v[SCAN_ITEMS];
  T s = 0;
#pragma unroll
  for (int e = 0; e < SCAN_ITEMS; e++) {
    v[e] = tile[threadIdx.x * SCAN_ITEMS + e];
    s += v[e];
  }
  T tot;
  T ex = block_exclusive_scan(s, &tot) + partials[blockIdx.x];
#pragma unroll
  for (int e = 0; e < SCAN_ITEMS; e++) {
    tile[threadIdx.x * SCAN_ITEMS + e] = ex;
    ex += v[e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < SCAN_TILE; i += SCAN_THREADS) {
    const int64_t g = base + i;
    if (g < n) data[g] = tile[i];
  }
}

inline int64_t scan_partials_len(int64_t n) {
  return (n + SCAN_TILE - 1) / SCAN_TILE;
}

// Exclusive scan of data[0:n) in place; `partials` holds
// scan_partials_len(n) elements of scratch.
template <typename T>
inline int exclusive_scan(T* data, int64_t n, T* partials,
                          cudaStream_t stream) {
  const int64_t blocks = scan_partials_len(n);
  if (blocks == 0) return 0;
  scan_tile_sums<T><<<(unsigned)blocks, SCAN_THREADS, 0, stream>>>(
      data, n, partials);
  KAT_CHECK_LAUNCH();
  scan_single_block<T><<<1, 1024, 0, stream>>>(partials, blocks, nullptr);
  KAT_CHECK_LAUNCH();
  scan_tile_apply<T><<<(unsigned)blocks, SCAN_THREADS, 0, stream>>>(
      data, n, partials);
  KAT_CHECK_LAUNCH();
  return 0;
}

}  // namespace kat

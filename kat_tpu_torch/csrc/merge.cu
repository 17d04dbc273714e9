// K2: merge-path merge of the sorted count table with the sorted fresh keys.
//
// Replaces kat_tpu/ops/sort_kernel.py::_window_kernel in final-phase mode,
// reached through kat_tpu/ops/merge_kernel.py::merge_sorted_kernel, the
// table merge of the counting flush (kat_tpu/core/counting.py:351).  The
// TPU laid the two runs out as [reversed(b) | a | pad] and ran the last
// phase of a bitonic network over it; none of that layout is carried over.
//
// What bounds it on the H100: device-memory traffic, 12 bytes read and 12
// written per output element (int64 key + int32 weight), so one pass.
// Each block owns 2048 consecutive outputs: it finds where its output
// range starts and ends in each input by binary search on the merge path
// (the diagonal), stages the two input slices in shared memory with
// coalesced loads, lets each thread merge 8 outputs sequentially from
// shared memory, and stores the 2048 outputs coalesced.
//
// Ties take the table element first, so the merge is stable; the fresh
// keys' weight is (key != SENTINEL), as at counting.py:349-350.  The
// output is exactly na + nb long.

#include "common.cuh"

namespace {

constexpr int MG_THREADS = 256;
constexpr int MG_ITEMS = 8;
constexpr int MG_TILE = MG_THREADS * MG_ITEMS;  // outputs per block

// Number of a-elements among the first `diag` outputs (a first on ties).
__device__ int64_t merge_path(const int64_t* __restrict__ a, int64_t na,
                              const int64_t* __restrict__ b, int64_t nb,
                              int64_t diag) {
  int64_t lo = diag > nb ? diag - nb : 0;
  int64_t hi = diag < na ? diag : na;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] <= b[diag - 1 - mid]) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(MG_THREADS)
merge_kernel(const int64_t* __restrict__ a, const int32_t* __restrict__ aw,
             int64_t na, const int64_t* __restrict__ b, int64_t nb,
             int64_t* __restrict__ out_keys, int32_t* __restrict__ out_w) {
  __shared__ int64_t sk[MG_TILE];
  __shared__ int32_t sw[MG_TILE];
  __shared__ int64_t s_split[2];

  const int64_t n = na + nb;
  const int64_t d0 = (int64_t)blockIdx.x * MG_TILE;
  const int64_t d1 = min(d0 + MG_TILE, n);
  // two warps search the two ends concurrently
  if (threadIdx.x == 0) s_split[0] = merge_path(a, na, b, nb, d0);
  if (threadIdx.x == 32) s_split[1] = merge_path(a, na, b, nb, d1);
  __syncthreads();
  const int64_t i0 = s_split[0], i1 = s_split[1];
  const int64_t j0 = d0 - i0;
  const int la = (int)(i1 - i0);
  const int lb = (int)((d1 - i1) - j0);
  const int len = la + lb;

  for (int t = threadIdx.x; t < la; t += MG_THREADS) {
    sk[t] = a[i0 + t];
    sw[t] = aw[i0 + t];
  }
  for (int t = threadIdx.x; t < lb; t += MG_THREADS) {
    const int64_t k = b[j0 + t];
    sk[la + t] = k;
    sw[la + t] = k != KAT_SENTINEL;
  }
  __syncthreads();

  // this thread's outputs start at local diagonal dt
  const int dt = min((int)threadIdx.x * MG_ITEMS, len);
  int lo = dt > lb ? dt - lb : 0;
  int hi = dt < la ? dt : la;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sk[mid] <= sk[la + dt - 1 - mid]) lo = mid + 1;
    else hi = mid;
  }
  int ia = lo, ib = dt - lo;
  int64_t rk[MG_ITEMS];
  int32_t rw[MG_ITEMS];
#pragma unroll
  for (int e = 0; e < MG_ITEMS; e++) {
    if (ia + ib < len) {
      const bool take_a = ia < la && (ib >= lb || sk[ia] <= sk[la + ib]);
      const int src = take_a ? ia : la + ib;
      rk[e] = sk[src];
      rw[e] = sw[src];
      if (take_a) ia++;
      else ib++;
    }
  }
  __syncthreads();  // every thread is done reading the inputs
#pragma unroll
  for (int e = 0; e < MG_ITEMS; e++) {
    const int p = dt + e;
    if (p < len) {
      sk[p] = rk[e];
      sw[p] = rw[e];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < len; t += MG_THREADS) {
    out_keys[d0 + t] = sk[t];
    out_w[d0 + t] = sw[t];
  }
}

}  // namespace

// out[0:na+nb) = stable merge of (a, aw) with (b, b != SENTINEL).
extern "C" int kat_merge_sorted(const int64_t* a, const int32_t* aw,
                                int64_t na, const int64_t* b, int64_t nb,
                                int64_t* out_keys, int32_t* out_w,
                                void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int64_t n = na + nb;
  if (n <= 0) return 0;
  const int64_t blocks = (n + MG_TILE - 1) / MG_TILE;
  merge_kernel<<<(unsigned)blocks, MG_THREADS, 0, stream>>>(
      a, aw, na, b, nb, out_keys, out_w);
  KAT_CHECK_LAUNCH();
  return 0;
}

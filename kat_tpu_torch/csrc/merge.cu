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
//
// kat_merge_sorted_payload is the same kernel carrying 1-3 int32 planes
// from BOTH sides: the table/query merge of the sort-merge join
// (kat_tpu/ops/join.py:130, payload (count, idx); :199, payload
// (count_a, count_b, source); the port's join carries one plane, the
// query's position, and its dual join two).  What bounds it: device-memory
// traffic, 8 + 4P bytes in and the same out per element.  The join relies
// on the tie rule: a table row leads the queries that equal its key.

#include "common.cuh"

namespace {

constexpr int MG_THREADS = 256;
constexpr int MG_ITEMS = 8;
constexpr int MG_TILE = MG_THREADS * MG_ITEMS;  // outputs per block
constexpr int MG_MAX_PLANES = 3;

struct PlanesIn {
  const int32_t* p[MG_MAX_PLANES];
};
struct PlanesOut {
  int32_t* p[MG_MAX_PLANES];
};

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

// P payload planes ride with the keys.  With B_WEIGHT (P == 1) the b side
// has no plane in memory: its value is (key != SENTINEL).
template <int P, bool B_WEIGHT>
__global__ void __launch_bounds__(MG_THREADS)
merge_kernel(const int64_t* __restrict__ a, PlanesIn ap, int64_t na,
             const int64_t* __restrict__ b, PlanesIn bp, int64_t nb,
             int64_t* __restrict__ out_keys, PlanesOut op) {
  __shared__ int64_t sk[MG_TILE];
  __shared__ int32_t sw[P][MG_TILE];
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
#pragma unroll
    for (int q = 0; q < P; q++) sw[q][t] = ap.p[q][i0 + t];
  }
  for (int t = threadIdx.x; t < lb; t += MG_THREADS) {
    const int64_t k = b[j0 + t];
    sk[la + t] = k;
    if constexpr (B_WEIGHT) {
      sw[0][la + t] = k != KAT_SENTINEL;
    } else {
#pragma unroll
      for (int q = 0; q < P; q++) sw[q][la + t] = bp.p[q][j0 + t];
    }
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
  int32_t rw[P][MG_ITEMS];
#pragma unroll
  for (int e = 0; e < MG_ITEMS; e++) {
    if (ia + ib < len) {
      const bool take_a = ia < la && (ib >= lb || sk[ia] <= sk[la + ib]);
      const int src = take_a ? ia : la + ib;
      rk[e] = sk[src];
#pragma unroll
      for (int q = 0; q < P; q++) rw[q][e] = sw[q][src];
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
#pragma unroll
      for (int q = 0; q < P; q++) sw[q][p] = rw[q][e];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < len; t += MG_THREADS) {
    out_keys[d0 + t] = sk[t];
#pragma unroll
    for (int q = 0; q < P; q++) op.p[q][d0 + t] = sw[q][t];
  }
}

template <int P, bool B_WEIGHT>
int launch_merge(const int64_t* a, PlanesIn ap, int64_t na, const int64_t* b,
                 PlanesIn bp, int64_t nb, int64_t* out_keys, PlanesOut op,
                 cudaStream_t stream) {
  const int64_t n = na + nb;
  if (n <= 0) return 0;
  const int64_t blocks = (n + MG_TILE - 1) / MG_TILE;
  merge_kernel<P, B_WEIGHT><<<(unsigned)blocks, MG_THREADS, 0, stream>>>(
      a, ap, na, b, bp, nb, out_keys, op);
  KAT_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// out[0:na+nb) = stable merge of (a, aw) with (b, b != SENTINEL).
extern "C" int kat_merge_sorted(const int64_t* a, const int32_t* aw,
                                int64_t na, const int64_t* b, int64_t nb,
                                int64_t* out_keys, int32_t* out_w,
                                void* stream_ptr) {
  const PlanesIn ap = {{aw, nullptr, nullptr}};
  const PlanesIn bp = {{nullptr, nullptr, nullptr}};
  const PlanesOut op = {{out_w, nullptr, nullptr}};
  return launch_merge<1, true>(a, ap, na, b, bp, nb, out_keys, op,
                               (cudaStream_t)stream_ptr);
}

// out[0:na+nb) = stable merge of (a, a0..a2) with (b, b0..b2), n_planes
// (1-3) int32 planes on each side; unused plane pointers may be null.
extern "C" int kat_merge_sorted_payload(
    const int64_t* a, const int32_t* a0, const int32_t* a1, const int32_t* a2,
    int64_t na, const int64_t* b, const int32_t* b0, const int32_t* b1,
    const int32_t* b2, int64_t nb, int n_planes, int64_t* out_keys,
    int32_t* o0, int32_t* o1, int32_t* o2, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const PlanesIn ap = {{a0, a1, a2}};
  const PlanesIn bp = {{b0, b1, b2}};
  const PlanesOut op = {{o0, o1, o2}};
  switch (n_planes) {
    case 1:
      return launch_merge<1, false>(a, ap, na, b, bp, nb, out_keys, op,
                                    stream);
    case 2:
      return launch_merge<2, false>(a, ap, na, b, bp, nb, out_keys, op,
                                    stream);
    case 3:
      return launch_merge<3, false>(a, ap, na, b, bp, nb, out_keys, op,
                                    stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

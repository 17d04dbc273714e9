// K6: merge of the sorted runs of one key stream into one ascending stream.
//
// Replaces kat_tpu/ops/sort_kernel.py::_window_kernel in runs mode (reached
// through bitonic_merge_runs), which the minimizer-bucketed flush calls once
// per hot bucket (kat_tpu/core/bucketed.py:76): a bucket that overflows one
// chunk gets a group of g chunks, each sorted on its own by K5, and their g
// runs must become one.  The TPU reversed the odd runs and ran the bitonic
// phases above the run length; none of that is carried over.  Here it is a
// tree of merge-path merges: log2(g) levels, one launch per level, and a
// launch merges every pair of neighbouring runs of its level, ping-ponging
// between two buffers.  Any length and any run length work (the last run
// may be short, a run without a neighbour is copied), so there is no
// counterpart of merge_runs_supported.
//
// What bounds it on the H100: device-memory traffic, 16 B per key once by
// the function's contract, 16 B per key per level by this design.  Each
// block owns 2048 consecutive outputs of one pair: it finds where its output
// range starts and ends in the two runs by binary search on the merge path,
// stages both slices in shared memory with coalesced loads, lets each thread
// merge 8 outputs sequentially, and stores the 2048 outputs coalesced (the
// tile of csrc/merge.cu without payload planes).
//
// Ties take the lower run first.  Keys compare as signed int64, so the
// sentinel tails of the runs (INT64_MAX) merge to the end like any key.

#include "common.cuh"

namespace {

constexpr int MR_THREADS = 256;
constexpr int MR_ITEMS = 8;
constexpr int MR_TILE = MR_THREADS * MR_ITEMS;  // outputs per block

// One level: runs of `run_len` keys in src[0:n) (the last may be shorter)
// merge pairwise into dst.  Block -> (pair, tile of that pair's output).
__global__ void __launch_bounds__(MR_THREADS)
merge_runs_kernel(const int64_t* __restrict__ src, int64_t* __restrict__ dst,
                  int64_t n, int64_t run_len, int64_t tiles_per_pair) {
  __shared__ int64_t sk[MR_TILE];
  __shared__ int64_t s_split[2];

  const int64_t pair = blockIdx.x / tiles_per_pair;
  const int64_t tile = blockIdx.x % tiles_per_pair;
  const int64_t p0 = pair * 2 * run_len;
  const int64_t na = min(run_len, n - p0);
  const int64_t nb = min(run_len, n - p0 - na);
  const int64_t d0 = tile * MR_TILE;
  if (d0 >= na + nb) return;  // the short last pair needs fewer tiles
  const int64_t d1 = min(d0 + MR_TILE, na + nb);
  const int64_t* a = src + p0;
  const int64_t* b = a + na;
  int64_t* out = dst + p0;

  if (threadIdx.x == 0) s_split[0] = kat::merge_path(a, na, b, nb, d0);
  if (threadIdx.x == 32) s_split[1] = kat::merge_path(a, na, b, nb, d1);
  __syncthreads();
  const int64_t i0 = s_split[0], i1 = s_split[1];
  const int64_t j0 = d0 - i0;
  const int la = (int)(i1 - i0);
  const int lb = (int)((d1 - i1) - j0);
  const int len = la + lb;

  for (int t = threadIdx.x; t < la; t += MR_THREADS) sk[t] = a[i0 + t];
  for (int t = threadIdx.x; t < lb; t += MR_THREADS) sk[la + t] = b[j0 + t];
  __syncthreads();

  // this thread's outputs start at local diagonal dt
  const int dt = min((int)threadIdx.x * MR_ITEMS, len);
  int lo = dt > lb ? dt - lb : 0;
  int hi = dt < la ? dt : la;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sk[mid] <= sk[la + dt - 1 - mid]) lo = mid + 1;
    else hi = mid;
  }
  int ia = lo, ib = dt - lo;
  int64_t rk[MR_ITEMS];
#pragma unroll
  for (int e = 0; e < MR_ITEMS; e++) {
    if (ia + ib < len) {
      const bool take_a = ia < la && (ib >= lb || sk[ia] <= sk[la + ib]);
      rk[e] = sk[take_a ? ia : la + ib];
      if (take_a) ia++;
      else ib++;
    }
  }
  __syncthreads();  // every thread is done reading the inputs
#pragma unroll
  for (int e = 0; e < MR_ITEMS; e++) {
    if (dt + e < len) sk[dt + e] = rk[e];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < len; t += MR_THREADS) out[d0 + t] = sk[t];
}

}  // namespace

// out[0:n) = the ascending merge of the sorted runs keys[r*run_len :
// (r+1)*run_len) of keys[0:n).  `tmp` (n keys) is the ping-pong buffer; it
// may be null when there are at most two runs.  keys is not modified.
extern "C" int kat_merge_runs(const int64_t* keys, int64_t* out, int64_t* tmp,
                              int64_t n, int64_t run_len, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n < 0 || run_len < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int levels = 0;
  for (int64_t len = run_len; len < n; len *= 2) levels++;
  if (levels == 0)
    return (int)cudaMemcpyAsync(out, keys, sizeof(int64_t) * n,
                                cudaMemcpyDeviceToDevice, stream);
  if (levels > 1 && tmp == nullptr) return (int)cudaErrorInvalidValue;
  const int64_t* src = keys;
  int64_t len = run_len;
  for (int lv = 0; lv < levels; lv++, len *= 2) {
    // the last level lands in `out`; earlier ones alternate backwards
    int64_t* dst = (levels - 1 - lv) % 2 == 0 ? out : tmp;
    const int64_t pairs = (n + 2 * len - 1) / (2 * len);
    const int64_t tiles_per_pair = (2 * len + MR_TILE - 1) / MR_TILE;
    const int64_t blocks = pairs * tiles_per_pair;
    if (blocks >= (int64_t{1} << 31)) return (int)cudaErrorInvalidValue;
    merge_runs_kernel<<<(unsigned)blocks, MR_THREADS, 0, stream>>>(
        src, dst, n, len, tiles_per_pair);
    KAT_CHECK_LAUNCH();
    src = dst;
  }
  return 0;
}

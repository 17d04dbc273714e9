// K6 before its k-way redesign (csrc/merge_runs.cu's first design): a tree
// of pairwise merge-path merges, one launch a level, each level reading and
// writing the whole stream, sentinel tails included.  Kept only so that
// chip_smoke.py can time the k-way merge against it on the same card; the
// port never calls it.  Its design notes are below, as they were.
//
// K6: merge of the sorted runs of one key stream into one ascending stream,
// for one int64 key (kat_merge_runs) and for W int64 words
// (kat_merge_runs_words, below).
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

// ---------------------------------------------------------------------------
// K6 over W words: keys of W int64 words (2 <= W <= 9, most significant
// first), plane q of a stream at ptr + q * stride.
//
// Replaces the same runs mode of _window_kernel with W key planes: the
// arrival merge of kat_tpu/parallel/sharded.py:258 for wide keys, where n
// sorted runs of route_cap keys (one per source shard) become one stream
// before the table merge.  The same merge-path tree as the one-word form
// (log2(n / run_len) levels, one launch a level, ping-pong buffers, any
// run length, ties to the lower run), the compares lexicographic over the
// W words.  What bounds it: device memory, 16 W bytes per key once by the
// function's contract, 16 W bytes per key per level by this design.  A
// block owns TILE consecutive outputs of one pair: it finds their ends on
// the merge path by binary search over the words in device memory, stages
// both slices' W planes in shared memory, lets each thread merge ITEMS
// outputs and record each one's staged slot, then writes each plane out in
// output order, consecutive threads on consecutive outputs.  The tile
// shrinks with W (the W-word merge's tiles of csrc/merge.cu) so that the
// staged planes stay under ~78 KB, two blocks an SM: 3072 outputs at W = 2,
// 2048 at W <= 4, 1024 beyond.

constexpr int MRW_THREADS = 256;

template <int W>
struct MergeRunsWords {
  static constexpr int ITEMS = W <= 2 ? 12 : W <= 4 ? 8 : 4;
  static constexpr int TILE = MRW_THREADS * ITEMS;
  static constexpr int SMEM = W * TILE * 8 + TILE * 4;
};

// a[ia] <= b[ib] over W planes in device memory (stride s)
template <int W>
__device__ __forceinline__ bool words_le(const int64_t* __restrict__ a,
                                         int64_t ia,
                                         const int64_t* __restrict__ b,
                                         int64_t ib, int64_t s) {
#pragma unroll
  for (int q = 0; q < W; q++) {
    const int64_t x = a[q * s + ia], y = b[q * s + ib];
    if (x != y) return x < y;
  }
  return true;
}

// merge path over W-word keys: a-elements among the first diag outputs
template <int W>
__device__ int64_t merge_path_words(const int64_t* __restrict__ a,
                                    int64_t na,
                                    const int64_t* __restrict__ b,
                                    int64_t nb, int64_t diag, int64_t s) {
  int64_t lo = diag > nb ? diag - nb : 0;
  int64_t hi = diag < na ? diag : na;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (words_le<W>(a, mid, b, diag - 1 - mid, s)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <int W>
__global__ void __launch_bounds__(MRW_THREADS)
merge_runs_words_kernel(const int64_t* __restrict__ src, int64_t ss,
                        int64_t* __restrict__ dst, int64_t ds, int64_t n,
                        int64_t run_len, int64_t tiles_per_pair) {
  constexpr int ITEMS = MergeRunsWords<W>::ITEMS;
  constexpr int TILE = MergeRunsWords<W>::TILE;
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* sk = reinterpret_cast<int64_t*>(smem);            // [W][TILE]
  uint32_t* slot = reinterpret_cast<uint32_t*>(sk + W * TILE);  // [TILE]
  __shared__ int64_t s_split[2];

  const int64_t pair = blockIdx.x / tiles_per_pair;
  const int64_t tile = blockIdx.x % tiles_per_pair;
  const int64_t p0 = pair * 2 * run_len;
  const int64_t na = min(run_len, n - p0);
  const int64_t nb = min(run_len, n - p0 - na);
  const int64_t d0 = tile * TILE;
  if (d0 >= na + nb) return;  // the short last pair needs fewer tiles
  const int64_t d1 = min(d0 + TILE, na + nb);
  const int64_t* a = src + p0;
  const int64_t* b = a + na;

  if (threadIdx.x == 0)
    s_split[0] = merge_path_words<W>(a, na, b, nb, d0, ss);
  if (threadIdx.x == 32)
    s_split[1] = merge_path_words<W>(a, na, b, nb, d1, ss);
  __syncthreads();
  const int64_t i0 = s_split[0], i1 = s_split[1];
  const int64_t j0 = d0 - i0;
  const int la = (int)(i1 - i0);
  const int lb = (int)((d1 - i1) - j0);
  const int len = la + lb;

  // 1. stage a[i0, i0 + la) then b[j0, j0 + lb) of every plane
#pragma unroll
  for (int q = 0; q < W; q++) {
    for (int t = threadIdx.x; t < la; t += MRW_THREADS)
      sk[q * TILE + t] = a[q * ss + i0 + t];
    for (int t = threadIdx.x; t < lb; t += MRW_THREADS)
      sk[q * TILE + la + t] = b[q * ss + j0 + t];
  }
  __syncthreads();
  auto a_le_b = [&](int i, int j) {
#pragma unroll
    for (int q = 0; q < W; q++) {
      const int64_t x = sk[q * TILE + i], y = sk[q * TILE + la + j];
      if (x != y) return x < y;
    }
    return true;
  };

  // 2. this thread's outputs start at local diagonal dt; merge them,
  //    recording each output's staged slot
  const int dt = min((int)threadIdx.x * ITEMS, len);
  int lo = dt > lb ? dt - lb : 0;
  int hi = dt < la ? dt : la;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a_le_b(mid, dt - 1 - mid)) lo = mid + 1;
    else hi = mid;
  }
  int ia = lo, ib = dt - lo;
#pragma unroll
  for (int e = 0; e < ITEMS; e++) {
    if (dt + e >= len) break;
    const bool take_a = ia < la && (ib >= lb || a_le_b(ia, ib));
    slot[dt + e] = take_a ? (uint32_t)ia++ : (uint32_t)(la + ib++);
  }
  __syncthreads();

  // 3. every plane out in output order
  int64_t* out = dst + p0 + d0;
#pragma unroll
  for (int q = 0; q < W; q++) {
    for (int j = threadIdx.x; j < len; j += MRW_THREADS)
      out[q * ds + j] = sk[q * TILE + slot[j]];
  }
}

template <int W>
int launch_merge_runs_words(const int64_t* keys, int64_t sk, int64_t* out,
                            int64_t* tmp, int64_t n, int64_t run_len,
                            cudaStream_t stream) {
  constexpr int TILE = MergeRunsWords<W>::TILE;
  constexpr int SMEM = MergeRunsWords<W>::SMEM;
  int levels = 0;
  for (int64_t len = run_len; len < n; len *= 2) levels++;
  if (levels == 0)  // one run: a copy of each plane
    return (int)cudaMemcpy2DAsync(out, sizeof(int64_t) * n, keys,
                                  sizeof(int64_t) * sk, sizeof(int64_t) * n,
                                  W, cudaMemcpyDeviceToDevice, stream);
  if (levels > 1 && tmp == nullptr) return (int)cudaErrorInvalidValue;
  static int sms_of[kat::MAX_DEVICES] = {};
  int sms;
  const cudaError_t err =
      kat::prepare(merge_runs_words_kernel<W>, SMEM, sms_of, &sms);
  if (err != cudaSuccess) return (int)err;
  const int64_t* src = keys;
  int64_t ss = sk;
  int64_t len = run_len;
  for (int lv = 0; lv < levels; lv++, len *= 2) {
    // the last level lands in `out`; earlier ones alternate backwards
    int64_t* dst = (levels - 1 - lv) % 2 == 0 ? out : tmp;
    const int64_t pairs = (n + 2 * len - 1) / (2 * len);
    const int64_t tiles_per_pair = (2 * len + TILE - 1) / TILE;
    const int64_t blocks = pairs * tiles_per_pair;
    if (blocks >= (int64_t{1} << 31)) return (int)cudaErrorInvalidValue;
    merge_runs_words_kernel<W><<<(unsigned)blocks, MRW_THREADS, SMEM,
                                 stream>>>(src, ss, dst, n, n, len,
                                           tiles_per_pair);
    KAT_CHECK_LAUNCH();
    src = dst;
    ss = n;
  }
  return 0;
}

}  // namespace

// out[0:n) = the ascending merge of the sorted runs keys[r*run_len :
// (r+1)*run_len) of keys[0:n).  `tmp` (n keys) is the ping-pong buffer; it
// may be null when there are at most two runs.  keys is not modified.
extern "C" int kat_earlier_merge_runs(const int64_t* keys, int64_t* out,
                                      int64_t* tmp, int64_t n,
                                      int64_t run_len, void* stream_ptr) {
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

// out[q * n + i] for i < n = the ascending lexicographic merge of the sorted
// runs [r*run_len, (r+1)*run_len) of the `words`-word (2-9) keys whose
// plane q lies at keys + q * sk; ties take the lower run.  `out` and `tmp`
// hold `words` contiguous planes of n keys; tmp (the ping-pong buffer) may
// be null when there are at most two runs.  keys is not modified.
extern "C" int kat_earlier_merge_runs_words(const int64_t* keys,
                                            int64_t sk, int64_t* out,
                                            int64_t* tmp, int64_t n,
                                            int64_t run_len, int words,
                                            void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n < 0 || run_len < 1 || (n > 1 && sk < n))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
#define KAT_MERGE_RUNS_WORDS(W) \
  case W:                       \
    return launch_merge_runs_words<W>(keys, sk, out, tmp, n, run_len, stream);
  switch (words) {
    KAT_MERGE_RUNS_WORDS(2)
    KAT_MERGE_RUNS_WORDS(3)
    KAT_MERGE_RUNS_WORDS(4)
    KAT_MERGE_RUNS_WORDS(5)
    KAT_MERGE_RUNS_WORDS(6)
    KAT_MERGE_RUNS_WORDS(7)
    KAT_MERGE_RUNS_WORDS(8)
    KAT_MERGE_RUNS_WORDS(9)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef KAT_MERGE_RUNS_WORDS
}

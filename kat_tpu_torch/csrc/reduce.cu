// K3: reduce-by-key of a sorted (key, weight) stream, compacted to the front.
//
// Replaces kat_tpu/ops/reduce_kernel.py::_reduce_kernel (reached through
// reduce_compact_sorted), the last step of the counting flush
// (kat_tpu/core/counting.py:357).  Contract kept from the TPU kernel: emit
// each run's key with its summed weight, in stream order, at the front of
// out_size slots padded with SENTINEL / 0; never emit a sentinel run, even
// an interior one; report the true number of runs in n_unique even when it
// exceeds out_size (the caller then grows the table and replays).
//
// The TPU kernel walks its tiles in order on one core and carries the
// open run's key, partial sum and the output cursor from tile to tile in
// SMEM (reduce_kernel.py:169-273).  CUDA blocks run in no order, so the
// carry becomes scans:
//   1. run ends are flagged: emit[i] = key[i] != key[i+1] && key[i] !=
//      SENTINEL;
//   2. per-block totals of the flags and of the weights, a one-block
//      exclusive scan of those totals, and a block scan inside each block
//      give every element its output rank r and the inclusive int64
//      prefix S of the weights;
//   3. the first element of a run stores S[first-1] as start_sum[r], the
//      last stores its key and S[last] as end_sum[r]; a last pass writes
//      count[r] = end_sum[r] - start_sum[r] and the padding.
// Writes of rank >= out_size are dropped, never sent out of bounds.
//
// What bounds it on the H100: device-memory traffic, two reads of the
// stream (12 bytes per element each) plus 28 bytes per emitted run; tiles
// are staged in shared memory so the loads are coalesced.
//
// Counts are stored as int32.  kat_tpu's uint32 counts wrap past 2^32; a
// count past 2^31 - 1 is out of scope here (a k-mer seen 2 billion times).

#include "common.cuh"

namespace {

constexpr int RD_THREADS = 256;
constexpr int RD_ITEMS = 8;
constexpr int RD_TILE = RD_THREADS * RD_ITEMS;

// sk[0] = key[base-1], sk[1+i] = key[base+i], sk[RD_TILE+1] =
// key[base+RD_TILE]; entries outside [0, n) are never compared (the run
// boundary tests check the index first).
__device__ __forceinline__ void load_tile(const int64_t* __restrict__ keys,
                                          const int32_t* __restrict__ w,
                                          int64_t n, int64_t base,
                                          int64_t* sk, int32_t* sw) {
  for (int i = threadIdx.x; i < RD_TILE + 2; i += RD_THREADS) {
    const int64_t g = base - 1 + i;
    sk[i] = (g >= 0 && g < n) ? keys[g] : 0;
  }
  for (int i = threadIdx.x; i < RD_TILE; i += RD_THREADS) {
    const int64_t g = base + i;
    sw[i] = g < n ? w[g] : 0;
  }
}

// This thread's number of emitted runs and weight sum over its items.
__device__ __forceinline__ void thread_totals(const int64_t* sk,
                                              const int32_t* sw, int64_t n,
                                              int64_t base, int64_t* cnt,
                                              int64_t* sum) {
  int64_t c = 0, s = 0;
#pragma unroll
  for (int e = 0; e < RD_ITEMS; e++) {
    const int l = threadIdx.x * RD_ITEMS + e;
    const int64_t g = base + l;
    if (g < n) {
      const int64_t k = sk[l + 1];
      const bool last = g == n - 1 || sk[l + 2] != k;
      c += (last && k != KAT_SENTINEL);
      s += sw[l];
    }
  }
  *cnt = c;
  *sum = s;
}

__global__ void __launch_bounds__(RD_THREADS)
reduce_partials(const int64_t* __restrict__ keys,
                const int32_t* __restrict__ w, int64_t n,
                int64_t* __restrict__ p_cnt, int64_t* __restrict__ p_sum) {
  __shared__ int64_t sk[RD_TILE + 2];
  __shared__ int32_t sw[RD_TILE];
  const int64_t base = (int64_t)blockIdx.x * RD_TILE;
  load_tile(keys, w, n, base, sk, sw);
  __syncthreads();
  int64_t c, s, tc, ts;
  thread_totals(sk, sw, n, base, &c, &s);
  kat::block_exclusive_scan(c, &tc);
  kat::block_exclusive_scan(s, &ts);
  if (threadIdx.x == 0) {
    p_cnt[blockIdx.x] = tc;
    p_sum[blockIdx.x] = ts;
  }
}

__global__ void __launch_bounds__(RD_THREADS)
reduce_emit(const int64_t* __restrict__ keys, const int32_t* __restrict__ w,
            int64_t n, const int64_t* __restrict__ p_cnt,
            const int64_t* __restrict__ p_sum,
            int64_t* __restrict__ out_keys, int64_t out_size,
            int64_t* __restrict__ start_sum, int64_t* __restrict__ end_sum) {
  __shared__ int64_t sk[RD_TILE + 2];
  __shared__ int32_t sw[RD_TILE];
  const int64_t base = (int64_t)blockIdx.x * RD_TILE;
  load_tile(keys, w, n, base, sk, sw);
  __syncthreads();
  int64_t c, s, tc, ts;
  thread_totals(sk, sw, n, base, &c, &s);
  int64_t r = kat::block_exclusive_scan(c, &tc) + p_cnt[blockIdx.x];
  int64_t S = kat::block_exclusive_scan(s, &ts) + p_sum[blockIdx.x];
#pragma unroll
  for (int e = 0; e < RD_ITEMS; e++) {
    const int l = threadIdx.x * RD_ITEMS + e;
    const int64_t g = base + l;
    if (g < n) {
      const int64_t k = sk[l + 1];
      const bool real = k != KAT_SENTINEL;
      const bool first = g == 0 || sk[l] != k;
      const bool last = g == n - 1 || sk[l + 2] != k;
      if (real && first && r < out_size) start_sum[r] = S;
      S += sw[l];
      if (real && last) {
        if (r < out_size) {
          out_keys[r] = k;
          end_sum[r] = S;
        }
        r++;
      }
    }
  }
}

__global__ void reduce_finish(int64_t* __restrict__ out_keys,
                              int32_t* __restrict__ out_counts,
                              int64_t out_size,
                              const int64_t* __restrict__ start_sum,
                              const int64_t* __restrict__ end_sum,
                              const int64_t* __restrict__ n_unique) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= out_size) return;
  if (r < *n_unique) {
    out_counts[r] = (int32_t)(end_sum[r] - start_sum[r]);
  } else {
    out_keys[r] = KAT_SENTINEL;
    out_counts[r] = 0;
  }
}

int64_t blocks_for(int64_t n) { return (n + RD_TILE - 1) / RD_TILE; }

}  // namespace

// int64 scratch elements kat_reduce_by_key needs.
extern "C" int64_t kat_reduce_by_key_scratch(int64_t n, int64_t out_size) {
  return 2 * blocks_for(n) + 2 * out_size;
}

// Reduce the sorted stream (keys, w)[0:n) into out_keys/out_counts
// [0:out_size); n_unique[0] gets the true number of non-sentinel runs.
extern "C" int kat_reduce_by_key(const int64_t* keys, const int32_t* w,
                                 int64_t n, int64_t* out_keys,
                                 int32_t* out_counts, int64_t out_size,
                                 int64_t* scratch, int64_t* n_unique,
                                 void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int64_t blocks = blocks_for(n);
  int64_t* p_cnt = scratch;
  int64_t* p_sum = scratch + blocks;
  int64_t* start_sum = scratch + 2 * blocks;
  int64_t* end_sum = start_sum + out_size;
  if (blocks == 0) {
    const cudaError_t err =
        cudaMemsetAsync(n_unique, 0, sizeof(int64_t), stream);
    if (err != cudaSuccess) return (int)err;
  } else {
    reduce_partials<<<(unsigned)blocks, RD_THREADS, 0, stream>>>(
        keys, w, n, p_cnt, p_sum);
    KAT_CHECK_LAUNCH();
    kat::scan_single_block<int64_t><<<1, 1024, 0, stream>>>(p_cnt, blocks,
                                                            n_unique);
    KAT_CHECK_LAUNCH();
    kat::scan_single_block<int64_t><<<1, 1024, 0, stream>>>(p_sum, blocks,
                                                            nullptr);
    KAT_CHECK_LAUNCH();
    reduce_emit<<<(unsigned)blocks, RD_THREADS, 0, stream>>>(
        keys, w, n, p_cnt, p_sum, out_keys, out_size, start_sum, end_sum);
    KAT_CHECK_LAUNCH();
  }
  if (out_size > 0) {
    reduce_finish<<<(unsigned)((out_size + 255) / 256), 256, 0, stream>>>(
        out_keys, out_counts, out_size, start_sum, end_sum, n_unique);
    KAT_CHECK_LAUNCH();
  }
  return 0;
}

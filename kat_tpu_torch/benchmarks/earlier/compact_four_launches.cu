// K4 before its one-pass redesign (csrc/compact.cu's first design): four
// launches (per-tile counts, a one-block scan, the scatter, the tail), the
// flags read twice.  Kept only so that chip_smoke.py can time the redesigned
// compaction against it on the same card; the port never calls it.  Its
// design notes are below, as they were.
//
// K4: stable stream compaction of the flagged elements of 1-3 int32 planes.
//
// Replaces kat_tpu/ops/reduce_kernel.py::_compact_kernel (reached through
// compact_flagged), which the sort-merge join uses to pull the query rows
// out of the merged (table + queries) stream (kat_tpu/ops/join.py:153,212).
// Contract kept from the TPU kernel: flagged elements move to the front of
// out_size slots in stream order, every plane alike; slots after n_kept are
// zero; n_kept is the true number of flagged elements even when it exceeds
// out_size, and writes past out_size are dropped.
//
// The TPU kernel is one sequential grid: each tile routes its kept lanes
// to the front with log-shift passes, appends them to a VMEM staging
// buffer and flushes full rows by chained DMA, carrying the output cursor
// in SMEM (reduce_kernel.py:296-349).  None of that is carried over: CUDA
// blocks run in no order, and the card has a scatter.  Here
//   1. each block counts the flags of its 2048-element tile;
//   2. one block scans the per-tile counts (the ordered cross-block prefix
//      a stable compaction needs) and stores the total as n_kept;
//   3. each block scans its tile's flags again, lists the tile-local index
//      of every kept element in shared memory in rank order, and then
//      copies plane by plane: consecutive threads read the listed elements
//      (a gather inside one 8 KB tile) and write consecutive output slots;
//   4. a last pass zeroes the slots from n_kept to out_size.
//
// What bounds it on the H100: device-memory traffic.  The function must
// read n * (1 + 4P) bytes and write out_size * 4P; at the join's shape for
// 2^23 queries against a 2^24-slot table (n = 2^24 + 2^23, P = 2,
// n_kept = out_size = 2^23) that is 0.29 GB, about 0.09 ms at 3.35 TB/s.
// This design reads the flags twice (n more bytes) and nothing else twice.

#include "common.cuh"

namespace {

constexpr int CP_THREADS = 256;
constexpr int CP_ITEMS = 8;
constexpr int CP_TILE = CP_THREADS * CP_ITEMS;
constexpr int CP_MAX_PLANES = 3;

struct PlanesIn {
  const int32_t* p[CP_MAX_PLANES];
};
struct PlanesOut {
  int32_t* p[CP_MAX_PLANES];
};

// Stage the tile's flags in shared memory (coalesced) and return this
// thread's number of flagged elements among its CP_ITEMS consecutive ones.
__device__ __forceinline__ int load_flags(const uint8_t* __restrict__ flag,
                                          int64_t n, int64_t base,
                                          uint8_t* s_flag) {
  for (int i = threadIdx.x; i < CP_TILE; i += CP_THREADS) {
    const int64_t g = base + i;
    s_flag[i] = g < n ? (flag[g] != 0) : 0;
  }
  __syncthreads();
  int c = 0;
#pragma unroll
  for (int e = 0; e < CP_ITEMS; e++) c += s_flag[threadIdx.x * CP_ITEMS + e];
  return c;
}

__global__ void __launch_bounds__(CP_THREADS)
compact_counts(const uint8_t* __restrict__ flag, int64_t n,
               int64_t* __restrict__ partials) {
  __shared__ uint8_t s_flag[CP_TILE];
  const int64_t base = (int64_t)blockIdx.x * CP_TILE;
  const int c = load_flags(flag, n, base, s_flag);
  int total;
  kat::block_exclusive_scan(c, &total);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void __launch_bounds__(CP_THREADS)
compact_scatter(PlanesIn in, int n_planes, const uint8_t* __restrict__ flag,
                int64_t n, const int64_t* __restrict__ offsets,
                PlanesOut out, int64_t out_size) {
  __shared__ uint8_t s_flag[CP_TILE];
  __shared__ uint16_t s_src[CP_TILE];
  const int64_t base = (int64_t)blockIdx.x * CP_TILE;
  const int c = load_flags(flag, n, base, s_flag);
  int total;
  int r = kat::block_exclusive_scan(c, &total);
#pragma unroll
  for (int e = 0; e < CP_ITEMS; e++) {
    const int l = threadIdx.x * CP_ITEMS + e;
    if (s_flag[l]) s_src[r++] = (uint16_t)l;
  }
  __syncthreads();
  const int64_t first = offsets[blockIdx.x];
  for (int p = 0; p < n_planes; p++) {
    const int32_t* __restrict__ src = in.p[p];
    int32_t* __restrict__ dst = out.p[p];
    for (int j = threadIdx.x; j < total; j += CP_THREADS) {
      const int64_t o = first + j;
      if (o < out_size) dst[o] = src[base + s_src[j]];
    }
  }
}

__global__ void compact_zero_tail(PlanesOut out, int n_planes,
                                  int64_t out_size,
                                  const int64_t* __restrict__ n_kept) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= out_size || r < *n_kept) return;
  for (int p = 0; p < n_planes; p++) out.p[p][r] = 0;
}

int64_t blocks_for(int64_t n) { return (n + CP_TILE - 1) / CP_TILE; }

}  // namespace

// int64 scratch elements kat_compact_flagged needs for n elements.
extern "C" int64_t kat_earlier_compact_flagged_scratch(int64_t n) {
  return blocks_for(n);
}

// Compact the flagged elements of n_planes (1-3) int32 planes [n] into
// out0..out2 [out_size]; flag is one byte per element (non-zero = keep);
// n_kept[0] gets the number of flagged elements.  Unused plane pointers may
// be null.
extern "C" int kat_earlier_compact_flagged(const int32_t* in0,
                                           const int32_t* in1,
                                           const int32_t* in2, int n_planes,
                                   const uint8_t* flag, int64_t n,
                                   int32_t* out0, int32_t* out1,
                                   int32_t* out2, int64_t out_size,
                                   int64_t* scratch, int64_t* n_kept,
                                   void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n_planes < 1 || n_planes > CP_MAX_PLANES)
    return (int)cudaErrorInvalidValue;
  const PlanesIn in = {{in0, in1, in2}};
  const PlanesOut out = {{out0, out1, out2}};
  const int64_t blocks = blocks_for(n);
  if (blocks == 0) {
    const cudaError_t err =
        cudaMemsetAsync(n_kept, 0, sizeof(int64_t), stream);
    if (err != cudaSuccess) return (int)err;
  } else {
    compact_counts<<<(unsigned)blocks, CP_THREADS, 0, stream>>>(flag, n,
                                                                scratch);
    KAT_CHECK_LAUNCH();
    kat::scan_single_block<int64_t><<<1, 1024, 0, stream>>>(scratch, blocks,
                                                            n_kept);
    KAT_CHECK_LAUNCH();
    compact_scatter<<<(unsigned)blocks, CP_THREADS, 0, stream>>>(
        in, n_planes, flag, n, scratch, out, out_size);
    KAT_CHECK_LAUNCH();
  }
  if (out_size > 0) {
    compact_zero_tail<<<(unsigned)((out_size + 255) / 256), 256, 0, stream>>>(
        out, n_planes, out_size, n_kept);
    KAT_CHECK_LAUNCH();
  }
  return 0;
}

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
// blocks run in no order, and the card has a scatter.
//
// What bounds it on the H100: device-memory traffic.  The function must
// read n * (1 + 4P) bytes and write out_size * 4P; at the join's shape for
// 2^23 queries against a 2^24-slot table (n = 2^24 + 2^23, P = 2,
// n_kept = out_size = 2^23) that is 0.29 GB, about 0.09 ms at 3.35 TB/s.
// One call is one memset of the status words, ONE tile pass and a tail
// launch, and the flags are read once:
//   - a block takes its tile number from an atomic counter (common.cuh),
//     reads the tile's flag bytes with 16-byte loads (two a thread, as a
//     32-bit mask; byte loads where the flags are not 16-byte aligned or
//     the tile is short), and scans the threads' counts;
//   - it lists the tile-local index of every kept element in shared memory
//     in rank order, publishes the tile's count in one 64-bit status word
//     (2 flag bits, a 62-bit count), and finds its output offset by
//     decoupled look-back with one warp (common.cuh, as K3);
//   - then each plane goes out: its tile is staged in shared memory with
//     16-byte loads (the first plane's issued before the look-back, so
//     that they are in flight while it waits; the kept elements read where
//     they lie when under a sixteenth of the tile is kept), and
//     consecutive threads write the listed elements to
//     consecutive output slots (a gather from global memory in their place
//     measured slower at both the join's and the dual probe's shapes);
//     the tile holding the last element writes n_kept;
//   - a last launch zeroes the slots from n_kept to out_size.
// The design it replaced was four launches: per-tile counts, a
// one-block scan of every tile's count, the scatter (a second read of the
// flags) and the tail.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int CP_THREADS = 512;  // 256 measured no faster
constexpr int CP_ITEMS = 32;  // flags a thread: two 16-byte loads, one mask
constexpr int CP_TILE = CP_THREADS * CP_ITEMS;
constexpr int CP_MAX_PLANES = 3;
static_assert(CP_TILE <= (1 << 16), "a tile-local index must fit 16 bits");

struct PlanesIn {
  const int32_t* p[CP_MAX_PLANES];
};
struct PlanesOut {
  int32_t* p[CP_MAX_PLANES];
};

// status word: flag << 62 | kept count (flag 1: this tile alone, 2: the
// tiles up to and including this one)
constexpr uint64_t AGGREGATE = 1, PREFIX = 2;
constexpr uint64_t COUNT_MASK = (1ull << 62) - 1;

struct KeptStatus {
  using Word = uint64_t;
  using Value = uint64_t;
  static constexpr Word NOTHING = PREFIX << 62;
  __device__ static Value identity() { return 0; }
  __device__ static bool ready(Word w) { return (w >> 62) != 0; }
  __device__ static bool prefix(Word w) { return (w >> 62) == PREFIX; }
  __device__ static Value value(Word w) { return w & COUNT_MASK; }
  __device__ static Value combine(Value a, Value b) { return a + b; }
  __device__ static Value shfl(Value v, int src) {
    return __shfl_sync(0xffffffffu, v, src);
  }
};

// Bit e of the result: byte e of the 16 bytes (c) is not zero.
__device__ __forceinline__ uint32_t nonzero_bytes(const uint4& c) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
  uint32_t m = 0;
#pragma unroll
  for (int v = 0; v < 4; v++)
#pragma unroll
    for (int b = 0; b < 4; b++)
      m |= ((w[v] >> (8 * b)) & 0xffu ? 1u : 0u) << (4 * v + b);
  return m;
}

__global__ void __launch_bounds__(CP_THREADS)
compact_tiles(PlanesIn in, int n_planes, const uint8_t* __restrict__ flag,
              int64_t n, int64_t tiles, PlanesOut out, int64_t out_size,
              uint32_t* next_tile, uint64_t* status, int64_t* n_kept) {
  __shared__ uint16_t s_src[CP_TILE];
  extern __shared__ __align__(16) int32_t s_plane[];  // [CP_TILE]
  __shared__ uint32_t s_tile;
  __shared__ int64_t s_first;
  const int tid = threadIdx.x;
  kat::take_tile(next_tile, &s_tile);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t base = tile * CP_TILE;
  const int valid = (int)min((int64_t)CP_TILE, n - base);

  // 1. this thread's flags as a mask, bit e for element j0 + e
  const int j0 = tid * CP_ITEMS;
  const uint8_t* f = flag + base + j0;
  uint32_t mask = 0;
  if (j0 + CP_ITEMS <= valid && ((uintptr_t)f & 15) == 0) {
    const uint4* c = reinterpret_cast<const uint4*>(f);
    mask = nonzero_bytes(__ldg(c)) | nonzero_bytes(__ldg(c + 1)) << 16;
  } else {
    for (int e = 0; e < CP_ITEMS && j0 + e < valid; e++)
      mask |= (f[e] ? 1u : 0u) << e;
  }

  // 2. the kept elements' tile-local indices, in rank order
  int total;
  int r = kat::block_exclusive_scan(__popc(mask), &total);
  for (uint32_t m = mask; m; m &= m - 1)
    s_src[r++] = (uint16_t)(j0 + __ffs(m) - 1);

  // Where a sixteenth of the tile or more is kept (every 32-byte sector is
  // read anyway), each plane's tile is staged in shared memory with
  // 16-byte loads; else the kept elements are read where they lie.  The
  // first plane's loads are issued now, to be in flight during the
  // look-back.
  constexpr int VECS = CP_TILE / 4 / CP_THREADS;
  const bool stage = total * 16 >= valid;
  auto whole = [&](const int32_t* src) {
    return valid == CP_TILE && ((uintptr_t)src & 15) == 0;
  };
  uint4 ahead[VECS];
  if (stage && whole(in.p[0] + base)) {
    const uint4* c = reinterpret_cast<const uint4*>(in.p[0] + base);
#pragma unroll
    for (int v = 0; v < VECS; v++) ahead[v] = __ldg(c + v * CP_THREADS + tid);
  }

  // 3. warp 0 publishes the tile's count, looks back for the tiles below
  //    (32 status words a round trip) and publishes the prefix
  if (tid < 32) {
    uint64_t before = 0;
    if (tile > 0) {
      if (tid == 0)
        kat::st_relaxed(status + tile, AGGREGATE << 62 | (uint64_t)total);
      before = kat::look_back<KeptStatus, 1, 32>(status + tile, tile, 1);
    }
    if (tid == 0) {
      kat::st_relaxed(status + tile, PREFIX << 62 | (before + total));
      if (tile == tiles - 1) *n_kept = (int64_t)(before + total);
      s_first = (int64_t)before;
    }
  }
  __syncthreads();

  // 4. every plane's kept elements out, consecutive threads on consecutive
  //    slots; nothing past out_size
  const int64_t first = s_first;
  const int count =
      (int)max((int64_t)0, min((int64_t)total, out_size - first));
  for (int p = 0; p < n_planes; p++) {
    const int32_t* __restrict__ src = in.p[p] + base;
    int32_t* __restrict__ dst = out.p[p] + first;
    if (!stage) {
      for (int j = tid; j < count; j += CP_THREADS) dst[j] = src[s_src[j]];
      continue;
    }
    if (whole(src)) {
      if (p > 0) {
        const uint4* c = reinterpret_cast<const uint4*>(src);
#pragma unroll
        for (int v = 0; v < VECS; v++)
          ahead[v] = __ldg(c + v * CP_THREADS + tid);
      }
#pragma unroll
      for (int v = 0; v < VECS; v++)
        reinterpret_cast<uint4*>(s_plane)[v * CP_THREADS + tid] = ahead[v];
    } else {
      for (int j = tid; j < valid; j += CP_THREADS) s_plane[j] = src[j];
    }
    __syncthreads();
    for (int j = tid; j < count; j += CP_THREADS) dst[j] = s_plane[s_src[j]];
    __syncthreads();
  }
}

// Slots [min(n_kept, out_size), out_size) of every plane get 0.
__global__ void __launch_bounds__(256)
compact_zero_tail(PlanesOut out, int n_planes, int64_t out_size,
                  const int64_t* __restrict__ n_kept) {
  const int64_t first = min(*n_kept, out_size);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = first + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       r < out_size; r += stride)
    for (int p = 0; p < n_planes; p++) out.p[p][r] = 0;
}

int64_t tiles_for(int64_t n) { return (n + CP_TILE - 1) / CP_TILE; }

}  // namespace

// int64 scratch elements kat_compact_flagged needs for n elements: the tile
// counter, then a status word a tile.
extern "C" int64_t kat_compact_flagged_scratch(int64_t n) {
  return 1 + tiles_for(n);
}

// Compact the flagged elements of n_planes (1-3) int32 planes [n] into
// out0..out2 [out_size]; flag is one byte per element (non-zero = keep);
// n_kept[0] gets the number of flagged elements.  Unused plane pointers may
// be null.
extern "C" int kat_compact_flagged(const int32_t* in0, const int32_t* in1,
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
  const int64_t tiles = tiles_for(n);
  if (tiles == 0) {
    const cudaError_t err =
        cudaMemsetAsync(n_kept, 0, sizeof(int64_t), stream);
    if (err != cudaSuccess) return (int)err;
  } else {
    static int sms_of[kat::MAX_DEVICES] = {};
    int sms;
    cudaError_t err = kat::prepare(compact_tiles, CP_TILE * 4, sms_of, &sms);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(
        scratch, 0, kat_compact_flagged_scratch(n) * sizeof(int64_t), stream);
    if (err != cudaSuccess) return (int)err;
    compact_tiles<<<(unsigned)tiles, CP_THREADS, CP_TILE * 4, stream>>>(
        in, n_planes, flag, n, tiles, out, out_size,
        reinterpret_cast<uint32_t*>(scratch),
        reinterpret_cast<uint64_t*>(scratch + 1), n_kept);
    KAT_CHECK_LAUNCH();
  }
  if (out_size > 0) {
    const int64_t blocks = std::min<int64_t>((out_size + 1023) / 1024, 1024);
    compact_zero_tail<<<(unsigned)blocks, 256, 0, stream>>>(
        out, n_planes, out_size, n_kept);
    KAT_CHECK_LAUNCH();
  }
  return 0;
}

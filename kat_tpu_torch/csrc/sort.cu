// K1: LSD radix sort of int64 k-mer keys.
//
// Replaces kat_tpu/ops/sort_kernel.py::_window_kernel in full-sort mode
// (reached through bitonic_sort_planes / sort_planes_padded), the sort of
// the fresh windows in the counting flush (kat_tpu/core/counting.py:343).
// The TPU sorted (hi, lo) uint32 planes with a bitonic network because it
// has no fast scatter; Hopper has one, so this is a radix sort.
//
// What bounds it on the H100: device-memory traffic.  Each 8-bit pass
// reads the keys twice (digit histogram, then scatter) and writes them
// once: 24 bytes per key per pass.  The design keeps the passes few and
// the writes coalesced:
//   - only the significant bits are sorted: the caller passes key_bits =
//     2k+1, so k=27 takes 7 passes, not 8.  Real keys are < 2^(2k) and the
//     INT64_MAX sentinel has bit 2k set, so sentinels still sort last
//     without a separate compaction;
//   - each block ranks its 4096-key tile in shared memory and writes it
//     back digit by digit, so a warp's stores land in a few contiguous
//     runs instead of 32 scattered words.
//
// Stability (what LSD needs) comes from the within-tile ranking, not from
// the block order, which is arbitrary: warp w owns the contiguous slice
// [w*512, (w+1)*512) of the tile and walks it 32 keys at a time, in
// address order; __match_any_sync finds the lanes that share a digit,
// a lane's rank is the number of lower peer lanes plus the warp's running
// count for that digit, and the warps' counts are then scanned in warp
// order.  Tiles are ordered by the digit-major exclusive scan of the
// per-tile histograms.

#include "common.cuh"

namespace {

constexpr int RS_THREADS = 256;
constexpr int RS_WARPS = RS_THREADS / 32;
constexpr int RS_ITEMS = 16;                          // keys per thread
constexpr int RS_TILE = RS_THREADS * RS_ITEMS;        // 4096 keys per block
constexpr int RS_RADIX = 256;

__device__ __forceinline__ int digit_of(int64_t key, int shift) {
  return (int)(((uint64_t)key >> shift) & (RS_RADIX - 1));
}

// hist[d * tiles + t] = number of keys of tile t whose digit is d.
__global__ void __launch_bounds__(RS_THREADS)
radix_hist(const int64_t* __restrict__ keys, int64_t n, int shift,
           int32_t* __restrict__ hist, int64_t tiles) {
  __shared__ int32_t cnt[RS_RADIX];
  cnt[threadIdx.x] = 0;
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * RS_TILE;
  for (int i = threadIdx.x; i < RS_TILE; i += RS_THREADS) {
    const int64_t g = base + i;
    if (g < n) atomicAdd(&cnt[digit_of(keys[g], shift)], 1);
  }
  __syncthreads();
  hist[(int64_t)threadIdx.x * tiles + blockIdx.x] = cnt[threadIdx.x];
}

// Stable scatter of one tile; `offsets` is the exclusive scan of `hist`,
// so offsets[d * tiles + t] is where tile t's first key of digit d goes.
__global__ void __launch_bounds__(RS_THREADS)
radix_scatter(const int64_t* __restrict__ in, int64_t* __restrict__ out,
              int64_t n, int shift, const int32_t* __restrict__ offsets,
              int64_t tiles) {
  __shared__ int64_t s_keys[RS_TILE];
  __shared__ int32_t s_warp[RS_WARPS][RS_RADIX];
  __shared__ int32_t s_start[RS_RADIX];
  __shared__ int32_t s_global[RS_RADIX];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t base = (int64_t)blockIdx.x * RS_TILE;

  for (int i = tid; i < RS_WARPS * RS_RADIX; i += RS_THREADS)
    (&s_warp[0][0])[i] = 0;
  s_global[tid] = offsets[(int64_t)tid * tiles + blockIdx.x];
  __syncthreads();

  // 1. rank every key among the keys of its digit in this warp's slice
  int64_t key[RS_ITEMS];
  int digit[RS_ITEMS];
  int rank[RS_ITEMS];
  const int64_t seg = base + (int64_t)warp * (RS_ITEMS * 32);
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < RS_ITEMS; i++) {
    const int64_t g = seg + i * 32 + lane;
    const bool valid = g < n;
    key[i] = valid ? in[g] : 0;
    const int d = valid ? digit_of(key[i], shift) : RS_RADIX;  // 256 = none
    digit[i] = d;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int leader = 31 - __clz(peers);
    const int cur = d < RS_RADIX ? s_warp[warp][d] : 0;
    __syncwarp();
    if (lane == leader && d < RS_RADIX) s_warp[warp][d] = cur + __popc(peers);
    __syncwarp();
    rank[i] = cur + __popc(peers & lower);
  }
  __syncthreads();

  // 2. thread d: warp-order exclusive scan of digit d's counts, then the
  //    tile-local start of each digit (scan over digits)
  int count = 0;
#pragma unroll
  for (int w = 0; w < RS_WARPS; w++) {
    const int c = s_warp[w][tid];
    s_warp[w][tid] = count;
    count += c;
  }
  int tile_total;
  const int start = kat::block_exclusive_scan(count, &tile_total);
  s_start[tid] = start;
  __syncthreads();

  // 3. place the tile in shared memory in sorted-by-digit order
#pragma unroll
  for (int i = 0; i < RS_ITEMS; i++) {
    const int d = digit[i];
    if (d < RS_RADIX) s_keys[s_start[d] + s_warp[warp][d] + rank[i]] = key[i];
  }
  __syncthreads();

  // 4. write it out: consecutive threads, consecutive keys of one digit
  const int valid_n = (int)min((int64_t)RS_TILE, n - base);
  for (int j = tid; j < valid_n; j += RS_THREADS) {
    const int64_t k = s_keys[j];
    const int d = digit_of(k, shift);
    out[(int64_t)s_global[d] + (j - s_start[d])] = k;
  }
}

int64_t tiles_for(int64_t n) { return (n + RS_TILE - 1) / RS_TILE; }

}  // namespace

// int32 scratch elements kat_radix_sort needs for n keys.
extern "C" int64_t kat_radix_sort_scratch(int64_t n) {
  const int64_t h = (int64_t)RS_RADIX * tiles_for(n);
  return h + kat::scan_partials_len(h);
}

// Sort keys[0:n) ascending into out[0:n).  `alt` (n keys) is the ping-pong
// buffer of the passes; it may be null when key_bits <= 8.  keys is not
// modified.  Requires n < 2^31 and every non-sentinel key < 2^(key_bits-1).
extern "C" int kat_radix_sort(const int64_t* keys, int64_t* out,
                              int64_t* alt, int32_t* scratch, int64_t n,
                              int key_bits, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n <= 0) return 0;
  const int passes = (key_bits + 7) / 8;
  const int64_t tiles = tiles_for(n);
  const int64_t h = (int64_t)RS_RADIX * tiles;
  int32_t* hist = scratch;
  int32_t* partials = scratch + h;
  for (int p = 0; p < passes; p++) {
    // the last pass lands in `out`; earlier ones alternate backwards
    int64_t* dst = ((passes - 1 - p) % 2 == 0) ? out : alt;
    const int64_t* src =
        p == 0 ? keys : (((passes - p) % 2 == 0) ? out : alt);
    const int shift = 8 * p;
    radix_hist<<<(unsigned)tiles, RS_THREADS, 0, stream>>>(src, n, shift,
                                                         hist, tiles);
    KAT_CHECK_LAUNCH();
    const int err = kat::exclusive_scan<int32_t>(hist, h, partials, stream);
    if (err) return err;
    radix_scatter<<<(unsigned)tiles, RS_THREADS, 0, stream>>>(
        src, dst, n, shift, hist, tiles);
    KAT_CHECK_LAUNCH();
  }
  return 0;
}

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
//
// kat_radix_sort_pairs is the same sort carrying one int32 value with every
// key: the query sort of the sort-merge join (kat_tpu/ops/join.py:122),
// where the TPU rode the query's position as one more key word because its
// bitonic network is unstable and pads to a power of two.  This sort is
// stable and takes any length, so the position is a plain payload: equal
// keys keep their input order.  A pass then moves 12 bytes per pair where
// the keys-only pass moves 8, read twice and written once as before.  The
// pair kernel stages values beside the keys in shared memory, so it takes
// 2048-pair tiles to stay inside the 48 KB a block gets without asking.

#include "common.cuh"

namespace {

constexpr int RS_THREADS = 256;
constexpr int RS_WARPS = RS_THREADS / 32;
constexpr int RS_ITEMS = 16;        // keys per thread: 4096 keys per block
constexpr int RS_ITEMS_PAIRS = 8;   // pairs per thread: 2048 pairs per block
constexpr int RS_RADIX = 256;

__device__ __forceinline__ int digit_of(int64_t key, int shift) {
  return (int)(((uint64_t)key >> shift) & (RS_RADIX - 1));
}

// hist[d * tiles + t] = number of keys of tile t whose digit is d.
template <int ITEMS>
__global__ void __launch_bounds__(RS_THREADS)
radix_hist(const int64_t* __restrict__ keys, int64_t n, int shift,
           int32_t* __restrict__ hist, int64_t tiles) {
  __shared__ int32_t cnt[RS_RADIX];
  cnt[threadIdx.x] = 0;
  __syncthreads();
  constexpr int TILE = RS_THREADS * ITEMS;
  const int64_t base = (int64_t)blockIdx.x * TILE;
  for (int i = threadIdx.x; i < TILE; i += RS_THREADS) {
    const int64_t g = base + i;
    if (g < n) atomicAdd(&cnt[digit_of(keys[g], shift)], 1);
  }
  __syncthreads();
  hist[(int64_t)threadIdx.x * tiles + blockIdx.x] = cnt[threadIdx.x];
}

// Stable scatter of one tile; `offsets` is the exclusive scan of `hist`,
// so offsets[d * tiles + t] is where tile t's first key of digit d goes.
// With HAS_VAL every key's int32 value moves with it.
template <int ITEMS, bool HAS_VAL>
__global__ void __launch_bounds__(RS_THREADS)
radix_scatter(const int64_t* __restrict__ in, int64_t* __restrict__ out,
              const int32_t* __restrict__ vin, int32_t* __restrict__ vout,
              int64_t n, int shift, const int32_t* __restrict__ offsets,
              int64_t tiles) {
  constexpr int TILE = RS_THREADS * ITEMS;
  __shared__ int64_t s_keys[TILE];
  __shared__ int32_t s_vals[HAS_VAL ? TILE : 1];
  __shared__ int32_t s_warp[RS_WARPS][RS_RADIX];
  __shared__ int32_t s_start[RS_RADIX];
  __shared__ int32_t s_global[RS_RADIX];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t base = (int64_t)blockIdx.x * TILE;

  for (int i = tid; i < RS_WARPS * RS_RADIX; i += RS_THREADS)
    (&s_warp[0][0])[i] = 0;
  s_global[tid] = offsets[(int64_t)tid * tiles + blockIdx.x];
  __syncthreads();

  // 1. rank every key among the keys of its digit in this warp's slice
  int64_t key[ITEMS];
  int32_t val[HAS_VAL ? ITEMS : 1];
  int digit[ITEMS];
  int rank[ITEMS];
  const int64_t seg = base + (int64_t)warp * (ITEMS * 32);
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < ITEMS; i++) {
    const int64_t g = seg + i * 32 + lane;
    const bool valid = g < n;
    key[i] = valid ? in[g] : 0;
    if constexpr (HAS_VAL) val[i] = valid ? vin[g] : 0;
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
  for (int i = 0; i < ITEMS; i++) {
    const int d = digit[i];
    if (d < RS_RADIX) {
      const int slot = s_start[d] + s_warp[warp][d] + rank[i];
      s_keys[slot] = key[i];
      if constexpr (HAS_VAL) s_vals[slot] = val[i];
    }
  }
  __syncthreads();

  // 4. write it out: consecutive threads, consecutive keys of one digit
  const int valid_n = (int)min((int64_t)TILE, n - base);
  for (int j = tid; j < valid_n; j += RS_THREADS) {
    const int64_t k = s_keys[j];
    const int d = digit_of(k, shift);
    const int64_t o = (int64_t)s_global[d] + (j - s_start[d]);
    out[o] = k;
    if constexpr (HAS_VAL) vout[o] = s_vals[j];
  }
}

int64_t tiles_for(int64_t n, int items) {
  const int64_t tile = (int64_t)RS_THREADS * items;
  return (n + tile - 1) / tile;
}

int64_t scratch_for(int64_t n, int items) {
  const int64_t h = (int64_t)RS_RADIX * tiles_for(n, items);
  return h + kat::scan_partials_len(h);
}

// The LSD passes shared by both entry points: sort (keys, vals)[0:n) into
// (out, vout), ping-ponging through (alt, valt).
template <int ITEMS, bool HAS_VAL>
int radix_sort_passes(const int64_t* keys, const int32_t* vals, int64_t* out,
                      int32_t* vout, int64_t* alt, int32_t* valt,
                      int32_t* scratch, int64_t n, int key_bits,
                      cudaStream_t stream) {
  if (n <= 0) return 0;
  const int passes = (key_bits + 7) / 8;
  const int64_t tiles = tiles_for(n, ITEMS);
  const int64_t h = (int64_t)RS_RADIX * tiles;
  int32_t* hist = scratch;
  int32_t* partials = scratch + h;
  for (int p = 0; p < passes; p++) {
    // the last pass lands in `out`; earlier ones alternate backwards
    const bool to_out = (passes - 1 - p) % 2 == 0;
    const bool from_out = (passes - p) % 2 == 0;
    int64_t* dst = to_out ? out : alt;
    int32_t* vdst = to_out ? vout : valt;
    const int64_t* src = p == 0 ? keys : (from_out ? out : alt);
    const int32_t* vsrc = p == 0 ? vals : (from_out ? vout : valt);
    const int shift = 8 * p;
    radix_hist<ITEMS><<<(unsigned)tiles, RS_THREADS, 0, stream>>>(
        src, n, shift, hist, tiles);
    KAT_CHECK_LAUNCH();
    const int err = kat::exclusive_scan<int32_t>(hist, h, partials, stream);
    if (err) return err;
    radix_scatter<ITEMS, HAS_VAL><<<(unsigned)tiles, RS_THREADS, 0, stream>>>(
        src, dst, vsrc, vdst, n, shift, hist, tiles);
    KAT_CHECK_LAUNCH();
  }
  return 0;
}

}  // namespace

// int32 scratch elements kat_radix_sort needs for n keys.
extern "C" int64_t kat_radix_sort_scratch(int64_t n) {
  return scratch_for(n, RS_ITEMS);
}

// Sort keys[0:n) ascending into out[0:n).  `alt` (n keys) is the ping-pong
// buffer of the passes; it may be null when key_bits <= 8.  keys is not
// modified.  Requires n < 2^31 and every non-sentinel key < 2^(key_bits-1).
extern "C" int kat_radix_sort(const int64_t* keys, int64_t* out,
                              int64_t* alt, int32_t* scratch, int64_t n,
                              int key_bits, void* stream_ptr) {
  return radix_sort_passes<RS_ITEMS, false>(
      keys, nullptr, out, nullptr, alt, nullptr, scratch, n, key_bits,
      (cudaStream_t)stream_ptr);
}

// int32 scratch elements kat_radix_sort_pairs needs for n pairs.
extern "C" int64_t kat_radix_sort_pairs_scratch(int64_t n) {
  return scratch_for(n, RS_ITEMS_PAIRS);
}

// Stable sort of (keys, vals)[0:n) by key into (out, vout)[0:n); (alt, valt)
// are the ping-pong buffers, as in kat_radix_sort.  The inputs are not
// modified.
extern "C" int kat_radix_sort_pairs(const int64_t* keys, const int32_t* vals,
                                    int64_t* out, int32_t* vout, int64_t* alt,
                                    int32_t* valt, int32_t* scratch,
                                    int64_t n, int key_bits,
                                    void* stream_ptr) {
  return radix_sort_passes<RS_ITEMS_PAIRS, true>(
      keys, vals, out, vout, alt, valt, scratch, n, key_bits,
      (cudaStream_t)stream_ptr);
}

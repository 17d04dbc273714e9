// The W-word K1 before its prefix-split redesign (csrc/sort.cu's first
// design): an LSD one-sweep radix sort over every 8-bit digit of every
// word, each pass moving every word of every key.  Kept only so that
// chip_smoke.py and the benchmarks can time the redesigned sort against it
// on the same card; the port never calls it.  Its design notes are below,
// as they were.

#include <algorithm>

#include "common.cuh"
#ifndef KAT_RS_THREADS
#define KAT_RS_THREADS 512
#endif
#ifndef KAT_RS_ITEMS
#define KAT_RS_ITEMS 16
#endif
#ifndef KAT_RS_LOOK_BACK
#define KAT_RS_LOOK_BACK 4
#endif

namespace {

constexpr int RS_RADIX = 256;
constexpr int RS_MAX_PASSES = 8;
constexpr int HIST_THREADS = 512;
constexpr int HIST_ITEMS = 8;
constexpr int HIST_TILE = HIST_THREADS * HIST_ITEMS;
constexpr int LOOK_BACK = KAT_RS_LOOK_BACK;

constexpr uint32_t FLAG_AGGREGATE = 1u << 30;  // count of this tile alone
constexpr uint32_t FLAG_PREFIX = 2u << 30;     // count of tiles 0..this one
constexpr uint32_t COUNT_MASK = (1u << 30) - 1;

// shift is a multiple of 8, so a digit lies inside one 32-bit half
__device__ __forceinline__ int digit_of(int64_t key, int shift) {
  const uint32_t half =
      shift < 32 ? (uint32_t)key : (uint32_t)((uint64_t)key >> 32);
  return (int)((half >> (shift & 31)) & (RS_RADIX - 1));
}

// The look-back's view of status[pass][tile][digit] (kat::look_back).
struct DigitStatus {
  using Word = uint32_t;
  using Value = uint32_t;  // keys of the digit in the tiles read so far
  static constexpr Word NOTHING = FLAG_PREFIX;
  __device__ static Value identity() { return 0; }
  __device__ static bool ready(Word w) { return (w & ~COUNT_MASK) != 0; }
  __device__ static bool prefix(Word w) {
    return (w & ~COUNT_MASK) == FLAG_PREFIX;
  }
  __device__ static Value value(Word w) { return w & COUNT_MASK; }
  __device__ static Value combine(Value a, Value b) { return a + b; }
};

// Digit counts of every pass in one read of the keys, then (last block) the
// scan of each pass's counts.
//
// Counting is one shared-memory atomicAdd per key and digit.  On the H100 a
// warp whose lanes all add to one address (sentinels, poly-A k-mers, sorted
// input's high digits) is no slower than a warp of random digits, and
// aggregating equal digits with ballots first made every distribution
// slower (benchmarks/sweep_sort.py has the distributions), so the adds are
// plain.
//
// `base` is [passes][256] (the passes of one key word, lowest digit first)
// and `done` the launch's ticket counter, both zeroed.
__global__ void __launch_bounds__(HIST_THREADS)
radix_histogram(const int64_t* __restrict__ keys, int64_t n, int passes,
                uint32_t* base, uint32_t* done) {
  __shared__ uint32_t cnt[RS_MAX_PASSES][RS_RADIX];
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  for (int i = tid; i < passes * RS_RADIX; i += HIST_THREADS)
    (&cnt[0][0])[i] = 0;
  __syncthreads();

  for (int64_t base = (int64_t)blockIdx.x * HIST_TILE; base < n;
       base += (int64_t)gridDim.x * HIST_TILE) {
    int64_t key[HIST_ITEMS];
#pragma unroll
    for (int i = 0; i < HIST_ITEMS; i++) {
      const int64_t g = base + i * HIST_THREADS + tid;
      key[i] = g < n ? keys[g] : 0;
    }
#pragma unroll
    for (int i = 0; i < HIST_ITEMS; i++) {
      if (base + i * HIST_THREADS + tid < n) {
        for (int p = 0; p < passes; p++)
          atomicAdd(&cnt[p][digit_of(key[i], 8 * p)], 1u);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < passes * RS_RADIX; i += HIST_THREADS) {
    const uint32_t c = (&cnt[0][0])[i];
    if (c) atomicAdd(base + i, c);
  }

  // the block that takes the last ticket sees every block's counts: each
  // block's adds precede its fence and its ticket
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    s_last = atomicAdd(done, 1u) == gridDim.x - 1;
    __threadfence();
  }
  __syncthreads();
  if (!s_last) return;

  for (int p = 0; p < passes; p++) {
    const uint32_t c =
        tid < RS_RADIX ? kat::ld_relaxed(base + p * RS_RADIX + tid) : 0u;
    uint32_t total;
    const uint32_t ex = kat::block_exclusive_scan(c, &total);
    if (tid < RS_RADIX) base[p * RS_RADIX + tid] = ex;
  }
}

int64_t tiles_for(int64_t n, int tile) { return (n + tile - 1) / tile; }

// ---------------------------------------------------------------------------
// Wide keys: W int64 words a key, [W][n] planes, word 0 most significant.
//
// Replaces the same TPU kernel reached through sort_planes_padded with W key
// planes: the sort of the wide flush's fresh windows
// (kat_tpu/core/wide.py:217).  LSD over the words from the least
// significant up: 8 digit passes over each lower word (62 bits) and
// ceil(top_bits / 8) over the top word, whose bit top_bits - 1 is the
// sentinel's (11 passes at k = 41).  What bounds it: device-memory traffic,
// one read of every word for the histograms (one launch per word) and one
// read and one write of every word per pass: 8W (1 + 2 passes) bytes a key.
//
// A pass ranks its tile by the digit's word alone, exactly as the one-word
// pass above (same stability argument), and records each key's slot and
// digit.  Then the tile's words go out one plane at a time through the
// same TILE-key buffer of shared memory: the digit's word right after the
// look-back, each other word loaded, placed at the recorded slots and
// written.  So the tile length does not shrink with W: shared memory holds
// one plane of the tile (64 KB) and a byte per key for its digit, 90 KB a
// block and two blocks an SM for every W, and registers hold one word per
// item.  Counts in the status words stay below 2^30: n < 2^30.
//
// With a value (kat_earlier_sort_words_pairs): the same passes, and after
// the key words each pass moves one int32 value a key through the same
// buffer, placed at the recorded slots and written.  It replaces the TPU
// sort reached through sort_planes_padded(qs + (idx,), n_words + 1), the
// query sort of the wide join (kat_tpu/ops/join.py:122), which rides the
// query's index as one more key word; a stable sort gives the same order
// without sorting the index.  What bounds it: device memory, 8W + 4 bytes
// a key read and written per pass.

constexpr int WS_MAX_WORDS = 9;  // k <= 255
constexpr int WS_MAX_PASSES = 8 * WS_MAX_WORDS;
constexpr int WS_THREADS = KAT_RS_THREADS;
constexpr int WS_ITEMS = KAT_RS_ITEMS;
constexpr int WS_TILE = WS_THREADS * WS_ITEMS;

struct WordsState {
  uint32_t base[WS_MAX_PASSES][RS_RADIX];  // digit counts, then their scan
  uint32_t next_tile[WS_MAX_PASSES];       // each pass's tile counter
  uint32_t hist_blocks_done[WS_MAX_WORDS];  // each word's histogram tickets
};
constexpr int64_t WS_STATE_WORDS =
    (sizeof(WordsState) / 4 + RS_RADIX - 1) / RS_RADIX * RS_RADIX;

// One stable 8-bit pass over all tiles: the digit at `shift` of word
// `word`; every word of a key moves.
template <int THREADS, int ITEMS>
__global__ void __launch_bounds__(THREADS, 2)
radix_onesweep_words(const int64_t* __restrict__ src,
                     int64_t* __restrict__ dst,
                     const int32_t* __restrict__ vsrc,
                     int32_t* __restrict__ vdst, int64_t n, int words,
                     int word, int shift, int pass, WordsState* st,
                     uint32_t* status) {
  constexpr int TILE = THREADS * ITEMS;
  constexpr int WARPS = THREADS / 32;
  static_assert(ITEMS % 2 == 0, "slots are packed two to a register");
  static_assert(TILE < (1 << 16), "a slot must fit 16 bits");
  static_assert(ITEMS >= 8, "the match tables must fit under the buffer");
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* s_buf = reinterpret_cast<int64_t*>(smem);         // [TILE]
  int32_t* s_warp = reinterpret_cast<int32_t*>(s_buf + TILE);  // [WARPS][256]
  int32_t* s_start = s_warp + WARPS * RS_RADIX;               // [256]
  int32_t* s_global = s_start + RS_RADIX;                     // [256]
  uint8_t* s_digit = reinterpret_cast<uint8_t*>(s_global + RS_RADIX);  // [TILE]
  uint32_t* s_match = reinterpret_cast<uint32_t*>(smem);  // over s_buf
  __shared__ uint32_t s_tile;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  kat::take_tile(&st->next_tile[pass], &s_tile);
  for (int i = tid; i < WARPS * RS_RADIX; i += THREADS) s_warp[i] = 0;
  for (int i = tid; i < WARPS * 2 * RS_RADIX; i += THREADS) s_match[i] = 0;
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t base = tile * TILE;
  const int valid_n = (int)min((int64_t)TILE, n - base);

  // 1. load the digit's word of the warp's slice, 32 consecutive keys a step
  int64_t key[ITEMS];
  const int first = warp * (ITEMS * 32) + lane;
  const int64_t* dsrc = src + (int64_t)word * n + base;
#pragma unroll
  for (int i = 0; i < ITEMS; i++) {
    const int j = first + i * 32;
    key[i] = j < valid_n ? dsrc[j] : 0;
  }

  // 2. rank every key among the keys of its digit in this warp's slice (as
  //    radix_onesweep)
  unsigned slot2[ITEMS / 2];
  int32_t* my_warp = s_warp + warp * RS_RADIX;
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < ITEMS; i++) {
    const bool valid = first + i * 32 < valid_n;
    const int d = digit_of(key[i], shift);
    uint32_t* match = s_match + (warp * 2 + i % 2) * RS_RADIX;
    if (valid) atomicOr(&match[d], 1u << lane);
    __syncwarp();
    const unsigned peers = valid ? match[d] : 1u << lane;
    __syncwarp();
    const int leader = 31 - __clz(peers);
    int prior = 0;
    if (valid && lane == leader) {
      prior = my_warp[d];
      my_warp[d] = prior + __popc(peers);
      match[d] = 0;
    }
    prior = __shfl_sync(0xffffffffu, prior, leader);
    const unsigned r = (unsigned)(prior + __popc(peers & lower));
    if (i % 2 == 0) slot2[i / 2] = r;
    else slot2[i / 2] |= r << 16;
  }
  __syncthreads();

  // 3. warp-order scan of each digit's counts, the tile-local starts, and
  //    the tile's counts out at once
  int count = 0;
  if (tid < RS_RADIX) {
#pragma unroll
    for (int w = 0; w < WARPS; w++) {
      const int c = s_warp[w * RS_RADIX + tid];
      s_warp[w * RS_RADIX + tid] = count;
      count += c;
    }
  }
  int tile_total;
  const int start = kat::block_exclusive_scan(count, &tile_total);
  uint32_t* my_status = status + tile * RS_RADIX + tid;
  if (tid < RS_RADIX) {
    s_start[tid] = start;
    kat::st_relaxed(my_status, FLAG_AGGREGATE | (uint32_t)count);
  }
  __syncthreads();

  // 4. each key's slot in the tile's sorted-by-digit order (kept, packed,
  //    for the other words) and its digit; the digit's word goes in place
#pragma unroll
  for (int i = 0; i < ITEMS; i++) {
    if (first + i * 32 < valid_n) {
      const int d = digit_of(key[i], shift);
      const unsigned r = (slot2[i / 2] >> (16 * (i % 2))) & 0xffffu;
      const unsigned slot = (unsigned)(s_start[d] + my_warp[d]) + r;
      slot2[i / 2] = i % 2 ? (slot2[i / 2] & 0xffffu) | slot << 16
                           : (slot2[i / 2] & 0xffff0000u) | slot;
      s_buf[slot] = key[i];
      s_digit[slot] = (uint8_t)d;
    }
  }

  // 5. look back for each digit's place, then publish this tile's
  if (tid < RS_RADIX) {
    const uint32_t before =
        kat::look_back<DigitStatus, LOOK_BACK>(my_status, tile, RS_RADIX);
    kat::st_relaxed(my_status, FLAG_PREFIX | (before + (uint32_t)count));
    s_global[tid] = (int32_t)(st->base[pass][tid] + before) - start;
  }
  __syncthreads();

  // 6. every word out, the digit's first: consecutive threads, consecutive
  //    keys of one digit
  for (int q = 0; q < words; q++) {
    const int plane = q == 0 ? word : q <= word ? q - 1 : q;
    if (q > 0) {
      __syncthreads();  // every thread has written the last plane out
      const int64_t* psrc = src + (int64_t)plane * n + base;
#pragma unroll
      for (int i = 0; i < ITEMS; i++) {
        const int j = first + i * 32;
        if (j < valid_n)
          s_buf[(slot2[i / 2] >> (16 * (i % 2))) & 0xffffu] = psrc[j];
      }
      __syncthreads();
    }
    int64_t* pdst = dst + (int64_t)plane * n;
    for (int j = tid; j < valid_n; j += THREADS)
      pdst[s_global[s_digit[j]] + j] = s_buf[j];
  }

  // 7. the values, if any, the same way through the buffer
  if (vsrc != nullptr) {
    int32_t* s_val = reinterpret_cast<int32_t*>(s_buf);
    __syncthreads();  // every thread has written the last plane out
#pragma unroll
    for (int i = 0; i < ITEMS; i++) {
      const int j = first + i * 32;
      if (j < valid_n)
        s_val[(slot2[i / 2] >> (16 * (i % 2))) & 0xffffu] = vsrc[base + j];
    }
    __syncthreads();
    for (int j = tid; j < valid_n; j += THREADS)
      vdst[s_global[s_digit[j]] + j] = s_val[j];
  }
}

int words_passes(int words, int top_bits) {
  return 8 * (words - 1) + (top_bits + 7) / 8;
}

int64_t words_scratch(int64_t n, int words, int top_bits) {
  return WS_STATE_WORDS +
         (int64_t)words_passes(words, top_bits) * tiles_for(n, WS_TILE) *
             RS_RADIX;
}
}  // namespace

// Keys a thread block of kat_radix_sort_words takes for `words` words: the
// same for every W (one plane of the tile is in shared memory at a time).
extern "C" int kat_earlier_sort_words_tile(int words) {
  (void)words;
  return WS_TILE;
}

// int32 scratch elements kat_radix_sort_words needs.
extern "C" int64_t kat_earlier_sort_words_scratch(int64_t n, int words,
                                                int top_bits) {
  return words_scratch(n, words, top_bits);
}

namespace {

// The W-word sort, with (vals != null) or without a value a key.
int sort_words(const int64_t* keys, const int32_t* vals, int64_t* out,
               int32_t* vout, int64_t* alt, int32_t* valt, int32_t* scratch,
               int64_t n, int words, int top_bits, cudaStream_t stream) {
  if (words < 2 || words > WS_MAX_WORDS || top_bits < 1 || top_bits > 63)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  constexpr int WARPS = WS_THREADS / 32;
  constexpr int SMEM =
      WS_TILE * 9 + (WARPS + 2) * RS_RADIX * (int)sizeof(int32_t);
  const int passes = words_passes(words, top_bits);
  const int64_t tiles = tiles_for(n, WS_TILE);
  WordsState* st = reinterpret_cast<WordsState*>(scratch);
  uint32_t* status = reinterpret_cast<uint32_t*>(scratch) + WS_STATE_WORDS;

  static int sms_of[kat::MAX_DEVICES] = {};
  auto kernel = radix_onesweep_words<WS_THREADS, WS_ITEMS>;
  int sms;
  cudaError_t err = kat::prepare(kernel, SMEM, sms_of, &sms);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(scratch, 0,
                        words_scratch(n, words, top_bits) * sizeof(int32_t),
                        stream);
  if (err != cudaSuccess) return (int)err;

  // one histogram launch per word: word q's passes are numbered from
  // 8 (words - 1 - q) up
  const int64_t hist_blocks =
      std::min(tiles_for(n, HIST_TILE), (int64_t)sms * (2048 / HIST_THREADS));
  for (int q = 0; q < words; q++) {
    const int p0 = 8 * (words - 1 - q);
    radix_histogram<<<(unsigned)hist_blocks, HIST_THREADS, 0, stream>>>(
        keys + (int64_t)q * n, n, q == 0 ? passes - p0 : 8,
        &st->base[p0][0], &st->hist_blocks_done[q]);
    KAT_CHECK_LAUNCH();
  }

  // the last pass writes `out`, the one before it `alt`, and so on
  // backwards; the first reads the input
  const int64_t* src = keys;
  const int32_t* vsrc = vals;
  for (int p = 0; p < passes; p++) {
    const bool to_out = (passes - 1 - p) % 2 == 0;
    int64_t* dst = to_out ? out : alt;
    int32_t* vdst = vals == nullptr ? nullptr : to_out ? vout : valt;
    kernel<<<(unsigned)tiles, WS_THREADS, SMEM, stream>>>(
        src, dst, vsrc, vdst, n, words, words - 1 - p / 8, 8 * (p % 8), p,
        st, status + (int64_t)p * tiles * RS_RADIX);
    KAT_CHECK_LAUNCH();
    src = dst;
    vsrc = vdst;
  }
  return 0;
}

}  // namespace

// Sort the [words][n] planes of `keys` lexicographically (word 0 most
// significant) into `out`, ping-ponging through `alt` (both [words][n]).
// Requires 2 <= words <= 9, n < 2^30, every lower word < 2^62 and every
// non-sentinel top word < 2^(top_bits - 1).  keys is not modified.
extern "C" int kat_earlier_sort_words(const int64_t* keys, int64_t* out,
                                    int64_t* alt, int32_t* scratch,
                                    int64_t n, int words, int top_bits,
                                    void* stream_ptr) {
  return sort_words(keys, nullptr, out, nullptr, alt, nullptr, scratch, n,
                    words, top_bits, (cudaStream_t)stream_ptr);
}

// kat_radix_sort_words carrying one int32 value a key: vals[0:n) into
// vout[0:n) through valt, stably (equal keys keep their input order).
// Scratch as kat_earlier_sort_words_scratch; the inputs are not modified.
extern "C" int kat_earlier_sort_words_pairs(const int64_t* keys,
                                          const int32_t* vals, int64_t* out,
                                          int32_t* vout, int64_t* alt,
                                          int32_t* valt, int32_t* scratch,
                                          int64_t n, int words, int top_bits,
                                          void* stream_ptr) {
  if (vals == nullptr || vout == nullptr || valt == nullptr)
    return (int)cudaErrorInvalidValue;
  return sort_words(keys, vals, out, vout, alt, valt, scratch, n, words,
                    top_bits, (cudaStream_t)stream_ptr);
}

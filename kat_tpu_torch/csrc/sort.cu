// K1: one-sweep LSD radix sort of int64 k-mer keys, alone or carrying one
// int32 value each; and (below) the sort of wide keys of W int64 words, a
// split on the key's top 16 bits followed by a shared-memory sort of each
// bucket.
//
// Replaces kat_tpu/ops/sort_kernel.py::_window_kernel in full-sort mode
// (reached through bitonic_sort_planes / sort_planes_padded), the sort of
// the fresh windows in the counting flush (kat_tpu/core/counting.py:343).
// The TPU sorted (hi, lo) uint32 planes with a bitonic network because it
// has no fast scatter; Hopper has one, so this is a radix sort.
//
// What bounds it on the H100: device-memory traffic.  The design (Adinets
// and Merrill, "Onesweep", 2022, written here from the paper) reads every
// key once for the histograms of ALL digits and then once per 8-bit digit,
// and writes it once per digit: 8 + 16 * passes bytes per key (12 + 24 *
// passes per pair).  Only the significant bits are sorted: the caller
// passes key_bits = 2k+1, so k = 27 takes 7 passes; real keys are < 2^(2k)
// and the INT64_MAX sentinel has bit 2k set, so sentinels sort last.
//
// One sort is one memset of its scratch and passes + 1 launches:
//   radix_histogram  counts the digits of every pass in one read of the
//     keys; the block that finishes last turns each pass's 256 counts into
//     their exclusive scan (the digit's base in the output).
//   radix_onesweep, once per digit, ping-ponging between `out` and `alt` so
//     that the last pass lands in `out`.  Every pass runs, also one whose
//     digit is the same for every key: no caller's keys leave a digit
//     uniform (key_bits is 2k+1, tight over random k-mers), and finding out
//     would cost the host a read of the histogram or every pass a plan to
//     follow.  A block takes its tile number from an
//     atomic counter, not from blockIdx: a block then only ever waits for
//     tiles that have already started, whatever order the hardware
//     schedules blocks in.  It ranks its tile, publishes its 256 digit
//     counts, and finds where its keys of each digit go by decoupled
//     look-back over the lower tiles' status words (below).
//
// Stability (what LSD needs): inside a tile, warp w owns the contiguous
// slice [w*ITEMS*32, (w+1)*ITEMS*32) and walks it 32 keys at a time in
// address order; the lanes of a step that share a digit find each other
// through a word of shared memory, a lane's rank is the warp's running
// count of that digit plus the number of lower peer lanes, and the warps'
// counts are scanned in warp order.  Across tiles, tile numbers are handed
// out in order and the prefix a tile gets is the sum over all lower-numbered
// tiles, so within a digit lower tiles land first.  (16-byte loads would
// give a lane two neighbouring keys and break the lane-major address order
// of a step, so loads are 8 bytes a lane, 256 contiguous bytes a warp.)
//
// The status word: status[pass][tile][digit] holds a 2-bit flag and a
// 30-bit count in ONE 32-bit word, written by one st.relaxed.gpu and read
// by ld.relaxed.gpu (the tile counter, these accesses and the look-back
// loop are common.cuh's, shared with K3).  Nothing but this word passes
// from block to block (no block reads keys another block wrote in the
// same launch), so no release/acquire ordering is needed: a reader can
// never see a flag without its count because they are one store, and
// .relaxed.gpu makes both sides strong operations at device scope (served
// by L2, never by a stale L1 line, never hoisted out of the spin loop).
// Counts stay below 2^30, so the wrapper refuses n >= 2^30.  The memset
// leaves every word "not ready".
//
// Tiles are THREADS * ITEMS keys, staged in dynamic shared memory above the
// 48 KB a block gets without asking, so a digit's run in a tile is ~32 keys
// = 256 contiguous bytes on the way out.  The sizes below were picked by
// benchmarks/sweep_sort.py --tiles, which rebuilds this file with other
// values of the macros.

#include <algorithm>
#include <type_traits>

#include "common.cuh"

#ifndef KAT_RS_THREADS
#define KAT_RS_THREADS 512
#endif
#ifndef KAT_RS_ITEMS
#define KAT_RS_ITEMS 16
#endif
#ifndef KAT_RS_PAIR_THREADS
#define KAT_RS_PAIR_THREADS 384
#endif
#ifndef KAT_RS_PAIR_ITEMS
#define KAT_RS_PAIR_ITEMS 16
#endif
#ifndef KAT_RS_LOOK_BACK
#define KAT_RS_LOOK_BACK 4  // status words a thread reads at once
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

// The head of a sort's scratch; the status words follow it.
struct SortState {
  uint32_t base[RS_MAX_PASSES][RS_RADIX];  // digit counts, then their scan
  uint32_t next_tile[RS_MAX_PASSES];       // each pass's tile counter
  uint32_t hist_blocks_done;
};
// in int32 words, rounded so that status rows start on a 1 KB boundary
constexpr int64_t STATE_WORDS =
    (sizeof(SortState) / 4 + RS_RADIX - 1) / RS_RADIX * RS_RADIX;

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

// One stable 8-bit pass over all tiles.  With HAS_VAL every key's int32
// value moves with it.
template <int THREADS, int ITEMS, bool HAS_VAL>
__global__ void __launch_bounds__(THREADS, 2)
radix_onesweep(const int64_t* __restrict__ src, int64_t* __restrict__ dst,
               const int32_t* __restrict__ vsrc, int32_t* __restrict__ vdst,
               int64_t n, int pass, SortState* st, uint32_t* status) {
  constexpr int TILE = THREADS * ITEMS;
  constexpr int WARPS = THREADS / 32;
  static_assert(ITEMS % 2 == 0, "ranks are packed two to a register");
  static_assert(TILE < (1 << 16), "a rank must fit 16 bits");
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* s_keys = reinterpret_cast<int64_t*>(smem);        // [TILE]
  int32_t* s_vals = reinterpret_cast<int32_t*>(s_keys + TILE);
  int32_t* s_warp = s_vals + (HAS_VAL ? TILE : 0);           // [WARPS][256]
  int32_t* s_start = s_warp + WARPS * RS_RADIX;              // [256]
  int32_t* s_global = s_start + RS_RADIX;                    // [256]
  // the match tables of step 2 lie over s_keys, which step 4 fills
  uint32_t* s_match = reinterpret_cast<uint32_t*>(smem);     // [WARPS][2][256]
  static_assert(ITEMS >= 8, "the match tables must fit under the keys");
  __shared__ uint32_t s_tile;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int shift = 8 * pass;
  kat::take_tile(&st->next_tile[pass], &s_tile);
  for (int i = tid; i < WARPS * RS_RADIX; i += THREADS) s_warp[i] = 0;
  for (int i = tid; i < WARPS * 2 * RS_RADIX; i += THREADS) s_match[i] = 0;
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t base = tile * TILE;
  const int valid_n = (int)min((int64_t)TILE, n - base);

  // 1. load the warp's slice, 32 consecutive keys a step
  int64_t key[ITEMS];
  int32_t val[HAS_VAL ? ITEMS : 1];
  const int first = warp * (ITEMS * 32) + lane;
#pragma unroll
  for (int i = 0; i < ITEMS; i++) {
    const int j = first + i * 32;
    key[i] = j < valid_n ? src[base + j] : 0;
    if constexpr (HAS_VAL) val[i] = j < valid_n ? vsrc[base + j] : 0;
  }

  // 2. rank every key among the keys of its digit in this warp's slice.
  //    The lanes of a step that share a digit find each other by OR-ing
  //    their lane bit into the digit's word of the warp's match table and
  //    reading it back (eight ballots take four times as many operations and
  //    measured slower).  The highest of them keeps the warp's running
  //    count of the digit and clears the word; steps alternate between two
  //    tables, so a clear never meets the next step's bits.
  unsigned rank2[ITEMS / 2];
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
    if (i % 2 == 0) rank2[i / 2] = r;
    else rank2[i / 2] |= r << 16;
  }
  __syncthreads();

  // 3. thread d: warp-order exclusive scan of digit d's counts, then the
  //    tile-local start of each digit (scan over digits); the tile's count
  //    goes out at once so that higher tiles need not wait for the rest
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

  // 4. place the tile in shared memory in sorted-by-digit order
#pragma unroll
  for (int i = 0; i < ITEMS; i++) {
    if (first + i * 32 < valid_n) {
      const int d = digit_of(key[i], shift);
      const int r = (int)((rank2[i / 2] >> (16 * (i % 2))) & 0xffffu);
      const int slot = s_start[d] + my_warp[d] + r;
      s_keys[slot] = key[i];
      if constexpr (HAS_VAL) s_vals[slot] = val[i];
    }
  }

  // 5. thread d looks back: add the lower tiles' counts of digit d until
  //    one of them knows its whole prefix, then publish this tile's
  if (tid < RS_RADIX) {
    const uint32_t before =
        kat::look_back<DigitStatus, LOOK_BACK>(my_status, tile, RS_RADIX);
    kat::st_relaxed(my_status, FLAG_PREFIX | (before + (uint32_t)count));
    // where slot j of this tile goes, less j, for a key of digit d
    s_global[tid] = (int32_t)(st->base[pass][tid] + before) - start;
  }
  __syncthreads();

  // 6. write it out: consecutive threads, consecutive keys of one digit
  for (int j = tid; j < valid_n; j += THREADS) {
    const int64_t k = s_keys[j];
    const int64_t o = (int64_t)(s_global[digit_of(k, shift)] + j);
    dst[o] = k;
    if constexpr (HAS_VAL) vdst[o] = s_vals[j];
  }
}

int64_t tiles_for(int64_t n, int tile) { return (n + tile - 1) / tile; }

int passes_for(int key_bits) { return (key_bits + 7) / 8; }

int64_t scratch_for(int64_t n, int key_bits, int tile) {
  return STATE_WORDS + passes_for(key_bits) * tiles_for(n, tile) * RS_RADIX;
}

// Sort (keys, vals)[0:n) into (out, vout), ping-ponging through (alt, valt).
template <int THREADS, int ITEMS, bool HAS_VAL>
int onesweep_sort(const int64_t* keys, const int32_t* vals, int64_t* out,
                  int32_t* vout, int64_t* alt, int32_t* valt,
                  int32_t* scratch, int64_t n, int key_bits,
                  cudaStream_t stream) {
  if (n <= 0) return 0;
  constexpr int TILE = THREADS * ITEMS;
  constexpr int WARPS = THREADS / 32;
  constexpr int SMEM = TILE * (HAS_VAL ? 12 : 8) + (WARPS + 2) * RS_RADIX * 4;
  const int passes = passes_for(key_bits);
  const int64_t tiles = tiles_for(n, TILE);
  SortState* st = reinterpret_cast<SortState*>(scratch);
  uint32_t* status = reinterpret_cast<uint32_t*>(scratch) + STATE_WORDS;

  static int sms_of[kat::MAX_DEVICES] = {};
  auto kernel = radix_onesweep<THREADS, ITEMS, HAS_VAL>;
  int sms;
  cudaError_t err = kat::prepare(kernel, SMEM, sms_of, &sms);
  if (err != cudaSuccess) return (int)err;

  err = cudaMemsetAsync(
      scratch, 0, scratch_for(n, key_bits, TILE) * sizeof(int32_t), stream);
  if (err != cudaSuccess) return (int)err;
  const int64_t hist_blocks =
      std::min(tiles_for(n, HIST_TILE), (int64_t)sms * (2048 / HIST_THREADS));
  radix_histogram<<<(unsigned)hist_blocks, HIST_THREADS, 0, stream>>>(
      keys, n, passes, &st->base[0][0], &st->hist_blocks_done);
  KAT_CHECK_LAUNCH();

  // the last pass writes `out`, the one before it `alt`, and so on
  // backwards; the first reads the input
  const int64_t* src = keys;
  const int32_t* vsrc = vals;
  for (int p = 0; p < passes; p++) {
    const bool to_out = (passes - 1 - p) % 2 == 0;
    int64_t* dst = to_out ? out : alt;
    int32_t* vdst = to_out ? vout : valt;
    kernel<<<(unsigned)tiles, THREADS, SMEM, stream>>>(
        src, dst, vsrc, vdst, n, p, st, status + p * tiles * RS_RADIX);
    KAT_CHECK_LAUNCH();
    src = dst;
    vsrc = vdst;
  }
  return 0;
}

constexpr int TILE_KEYS = KAT_RS_THREADS * KAT_RS_ITEMS;
constexpr int TILE_PAIRS = KAT_RS_PAIR_THREADS * KAT_RS_PAIR_ITEMS;

}  // namespace

// Keys a thread block of kat_radix_sort takes.
extern "C" int kat_radix_sort_tile() { return TILE_KEYS; }

// int32 scratch elements kat_radix_sort needs for n keys of key_bits bits.
extern "C" int64_t kat_radix_sort_scratch(int64_t n, int key_bits) {
  return scratch_for(n, key_bits, TILE_KEYS);
}

// Sort keys[0:n) ascending into out[0:n).  `alt` (n keys) is the ping-pong
// buffer of the passes; it may be null when key_bits <= 8.  keys is not
// modified.  Requires n < 2^30 and every non-sentinel key < 2^(key_bits-1).
extern "C" int kat_radix_sort(const int64_t* keys, int64_t* out,
                              int64_t* alt, int32_t* scratch, int64_t n,
                              int key_bits, void* stream_ptr) {
  return onesweep_sort<KAT_RS_THREADS, KAT_RS_ITEMS, false>(
      keys, nullptr, out, nullptr, alt, nullptr, scratch, n, key_bits,
      (cudaStream_t)stream_ptr);
}

// Pairs a thread block of kat_radix_sort_pairs takes.
extern "C" int kat_radix_sort_pairs_tile() { return TILE_PAIRS; }

// int32 scratch elements kat_radix_sort_pairs needs for n pairs.
extern "C" int64_t kat_radix_sort_pairs_scratch(int64_t n, int key_bits) {
  return scratch_for(n, key_bits, TILE_PAIRS);
}

// Stable sort of (keys, vals)[0:n) by key into (out, vout)[0:n); (alt, valt)
// are the ping-pong buffers, as in kat_radix_sort.  The inputs are not
// modified.
extern "C" int kat_radix_sort_pairs(const int64_t* keys, const int32_t* vals,
                                    int64_t* out, int32_t* vout, int64_t* alt,
                                    int32_t* valt, int32_t* scratch,
                                    int64_t n, int key_bits,
                                    void* stream_ptr) {
  return onesweep_sort<KAT_RS_PAIR_THREADS, KAT_RS_PAIR_ITEMS, true>(
      keys, vals, out, vout, alt, valt, scratch, n, key_bits,
      (cudaStream_t)stream_ptr);
}

// ---------------------------------------------------------------------------
// Wide keys: W int64 words a key, [W][n] planes, word 0 most significant.
//
// Replaces the same TPU kernel reached through sort_planes_padded with W key
// planes: the sort of the wide flush's fresh windows
// (kat_tpu/core/wide.py:217), and (with a value) the query sort of the wide
// join, sort_planes_padded(qs + (idx,), n_words + 1)
// (kat_tpu/ops/join.py:122), which rides the query's index as one more key
// word; a stable sort gives the same order without sorting the index.
//
// What bounds it: device-memory traffic.  An LSD sort over every digit of
// every word (this sort's first design) moved every word of every key on
// each of its 8(W-1) + ceil(top_bits / 8) passes, 8W (1 + 2 passes) bytes
// a key, growing as W^2.
// This design makes three passes over the whole array whatever W is:
//
// 1. The prefix.  A key's significant bits are the top word's t = top_bits
//    - 1 data bits followed by 62 bits of each lower word (the contract:
//    lower words < 2^62), so that comparing those bit strings is comparing
//    the words in order.  Its first 16 bits are its prefix (they span the
//    top word and the next one where t < 16: the sharded sort's leading
//    owner word holds 3); a key whose top word is 2^t or more is a
//    SENTINEL and goes to a bucket of its own after the 65,536 prefixes.
//    split_histogram counts the prefix's low and high 8-bit digits (257
//    high digits: the sentinels' is 256) in one read of the top word (and
//    of the next where t < 16); its last block scans both.
// 2. The split.  Two stable one-sweep passes (words_pass, the narrow sort's
//    pass ranking one 8-bit digit, with the digit taken from the prefix) order
//    the keys by the prefix's low digit, then its high digit: every word
//    (and the value) moves once a pass.  The second pass also counts every
//    prefix (bucket) from its tile's sorted layout, one pair of global adds
//    a run; split_plan then scans the 65,536 counts (64 blocks, decoupled
//    look-back) and cuts [0, n_real) into units: runs of small buckets (at
//    most CAP/2 keys each; a unit holds those whose start lies in one
//    CAP/2-aligned window, so fewer than CAP keys), a bucket of CAP/2..CAP
//    keys alone, and the oversize buckets (more than CAP).  The sentinels
//    are in place already and never sorted.
// 3. The bucket sort.  sort_units, one block a unit of CAP = 4096 keys at
//    most: each key's first 64 significant bits (its abbreviated key,
//    prefix included) go into shared memory and are ordered there (a
//    counting pass into runs cut from each bucket's place in the unit, then
//    a rank within each run; a merge sort where keys cluster), then keys that
//    share their abbreviated key are compared on their lower words, and
//    each plane (and the value) is staged in shared memory and written back
//    in sorted order, in place.  A unit already in order is not written.
// 4. Oversize buckets (more than CAP keys: a hot k-mer, a skewed prefix,
//    n far past 2^28) are sorted together by segmented one-sweep passes
//    (words_pass over a list of segments: a tile finds its segment, looks
//    back only within it and adds the segment's start) over the digits the
//    prefix does not hold, with per-segment digit bases from
//    segment_histogram.  Their number and tiles are known only on the
//    device: the caller reads them (kat_sort_words_split's head, three
//    words) between the two C entry points.  That is the ONE host read of
//    a call, and it is made for every call with n > 0.
//
// Traffic at W = 2 (k = 41, t = 20): 8 B a key for the histogram, 2 x 32 B
// for the split and 32 B for the bucket sort, ~104 B a key against the
// LSD sort's 352; at W = 4 with a value ~224 B against 1,800.  Stability:
// the split passes are stable, units are sorted stably (ties keep their
// slot order) and the fallback passes are stable, so equal keys keep their
// input order, which the wide join relies on.  Counts in status words stay
// below 2^30, so n < 2^30.

namespace {

constexpr int WS_MAX_WORDS = 9;  // k <= 255
constexpr int PREFIX_BITS = 16;
constexpr int BUCKETS = 1 << PREFIX_BITS;  // real prefixes
constexpr uint32_t SENT_BUCKET = BUCKETS;  // the sentinels' bucket
constexpr int HIGH_RADIX = 257;            // the high digit: sentinels' 256

// the split passes: 6144 keys a tile, a 4-byte bucket a slot (90 KB, two
// blocks an SM)
constexpr int SP_THREADS = 512;
constexpr int SP_ITEMS = 12;
constexpr int SP_TILE = SP_THREADS * SP_ITEMS;
// the fallback passes: as the LSD design's pass, a byte a slot (90 KB)
constexpr int FB_THREADS = KAT_RS_THREADS;
constexpr int FB_ITEMS = KAT_RS_ITEMS;
constexpr int FB_TILE = FB_THREADS * FB_ITEMS;
constexpr int FB_MAX_PASSES = 8 * WS_MAX_WORDS;
// the bucket sort: a unit of up to CAP keys, 8 a thread
constexpr int BS_THREADS = 512;
constexpr int BS_ITEMS = 8;
constexpr int BS_CAP = BS_THREADS * BS_ITEMS;
constexpr int BS_SMALL = BS_CAP / 2;
// the plan: a block a 1024 buckets
constexpr int PLAN_THREADS = 1024;
constexpr int PLAN_BLOCKS = BUCKETS / PLAN_THREADS;

// What the host reads between the two C entry points (scratch word 0 on).
struct SplitHead {
  uint32_t n_units, n_over, over_tiles, pad;
};

// The zeroed head of the split's scratch; count2d and the status words
// follow it, then the plan's arrays.
struct SplitState {
  SplitHead head;
  uint32_t count[2][HIGH_RADIX + 7];  // the low and high digits' counts
  uint32_t base[2][HIGH_RADIX + 7];   // their exclusive scans
  uint32_t next_tile[2];
  uint32_t hist_done;
  uint32_t plan_tile;
  uint64_t plan_status[2][PLAN_BLOCKS];  // a word a plan block
};
constexpr int64_t SPLIT_STATE_WORDS =
    (sizeof(SplitState) / 4 + RS_RADIX - 1) / RS_RADIX * RS_RADIX;
constexpr int64_t COUNT2D_WORDS = BUCKETS + RS_RADIX;  // + the n_real slot

// The split's scratch, in int32 words from its start.
struct SplitLayout {
  int64_t tiles;
  int64_t count2d, status, zeroed;  // zeroed: words to clear
  int64_t bstart, ustart, uover, ostart, olen, otile, total;
  explicit SplitLayout(int64_t n) {
    tiles = (n + SP_TILE - 1) / SP_TILE;
    count2d = SPLIT_STATE_WORDS;
    status = count2d + COUNT2D_WORDS;
    zeroed = status + 2 * tiles * HIGH_RADIX;
    bstart = zeroed;
    ustart = bstart + BUCKETS + 1;
    uover = ustart + BUCKETS + 1;
    ostart = uover + BUCKETS / 4;
    olen = ostart + BUCKETS;
    otile = olen + BUCKETS;
    total = otile + BUCKETS + 1;
  }
};

// A key's bucket from its top word and the next (read only where t < 16).
__device__ __forceinline__ uint32_t bucket_of(uint64_t w0, uint64_t w1,
                                              int t) {
  if (w0 >> t) return SENT_BUCKET;
  if (t >= PREFIX_BITS) return (uint32_t)(w0 >> (t - PREFIX_BITS));
  return (uint32_t)(w0 << (PREFIX_BITS - t) | w1 >> (46 + t));
}

// A key's first 64 significant bits (t data bits of the top word, then 62
// bits a lower word); its top 16 are the prefix.
__device__ __forceinline__ uint64_t abbrev_of(const int64_t* keys,
                                              int64_t stride, int64_t i,
                                              int words, int t) {
  const uint64_t w0 = (uint64_t)__ldg(keys + i);
  const uint64_t w1 = (uint64_t)__ldg(keys + stride + i);
  uint64_t a = t > 0 ? w0 << (64 - t) : 0;
  a |= t <= 2 ? w1 << (2 - t) : w1 >> (t - 2);
  if (t < 2 && words > 2)
    a |= (uint64_t)__ldg(keys + 2 * stride + i) >> (60 + t);
  return a;
}

// The first word not wholly inside the abbreviated key: ties compare from
// there on.
__host__ __device__ __forceinline__ int first_tie_word(int t) {
  return t <= 2 ? 2 : 1;
}

// Digit counts of the split's two passes in one read; the last block scans
// them (as radix_histogram).
__global__ void __launch_bounds__(HIST_THREADS)
split_histogram(const int64_t* __restrict__ keys, int64_t n, int t,
                SplitState* st) {
  __shared__ uint32_t cnt[2][HIGH_RADIX];
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * HIGH_RADIX; i += HIST_THREADS)
    (&cnt[0][0])[i] = 0;
  __syncthreads();
  const bool two = t < PREFIX_BITS;
  for (int64_t base = (int64_t)blockIdx.x * HIST_TILE; base < n;
       base += (int64_t)gridDim.x * HIST_TILE) {
    uint64_t w0[HIST_ITEMS], w1[HIST_ITEMS];
#pragma unroll
    for (int i = 0; i < HIST_ITEMS; i++) {
      const int64_t g = base + i * HIST_THREADS + tid;
      w0[i] = g < n ? (uint64_t)keys[g] : 0;
      w1[i] = g < n && two ? (uint64_t)keys[n + g] : 0;
    }
#pragma unroll
    for (int i = 0; i < HIST_ITEMS; i++) {
      if (base + i * HIST_THREADS + tid < n) {
        const uint32_t b = bucket_of(w0[i], w1[i], t);
        atomicAdd(&cnt[0][b & 255u], 1u);
        atomicAdd(&cnt[1][b >> 8], 1u);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < 2 * HIGH_RADIX; i += HIST_THREADS) {
    const uint32_t c = (&cnt[0][0])[i];
    if (c) atomicAdd(&st->count[i / HIGH_RADIX][i % HIGH_RADIX], c);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    s_last = atomicAdd(&st->hist_done, 1u) == gridDim.x - 1;
    __threadfence();
  }
  __syncthreads();
  if (!s_last) return;
  for (int p = 0; p < 2; p++) {
    const int radix = p ? HIGH_RADIX : RS_RADIX;
    const uint32_t c = tid < radix ? kat::ld_relaxed(&st->count[p][tid]) : 0u;
    uint32_t total;
    const uint32_t ex = kat::block_exclusive_scan(c, &total);
    if (tid < radix) st->base[p][tid] = ex;
  }
}

enum PassMode { SPLIT_LOW, SPLIT_HIGH, SEGMENTS };

// The fallback's digits, least significant first: the word and the shift of
// each.
struct Digits {
  int n;
  uint8_t word[FB_MAX_PASSES];
  uint8_t shift[FB_MAX_PASSES];
};

// What a pass is told beyond its buffers.
struct PassArgs {
  int t;                      // the split: the top word's data bits
  int word, shift;            // a fallback pass: its digit
  const uint32_t* base;       // the split: [radix] output bases; the
                              // fallback: [segs][passes][256] bases within
                              // each segment
  uint32_t* count2d;          // SPLIT_HIGH: the buckets' counts
  const uint32_t* seg_start;  // the fallback: each segment's first key,
  const uint32_t* seg_len;    // its length
  const uint32_t* seg_tile;   // and its first tile ([segs + 1])
  int segs, pass, passes;
};

// The segment of fallback tile `tile`: the last s with seg_tile[s] <= tile.
__device__ __forceinline__ int segment_of(const uint32_t* seg_tile, int segs,
                                          int64_t tile) {
  int lo = 0, hi = segs - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (seg_tile[mid] <= tile) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// One stable 8-bit pass: the split's low or high prefix digit over the whole
// array, or one digit of one word over every oversize segment.  Each tile is
// ranked by its digit as radix_onesweep ranks it (the same stability
// argument), each key's slot in the tile's sorted-by-digit order is kept,
// and the tile's words go out one plane at a time through one TILE-key
// buffer of shared memory, each loaded, placed at the kept slots and
// written (the fallback's digit word is placed from registers right after
// the look-back); the value, if any, last.  The split keeps a bucket a key
// in registers, not the word, which left its passes short of registers.
template <int THREADS, int ITEMS, int MODE>
__global__ void __launch_bounds__(THREADS, 2)
words_pass(const int64_t* __restrict__ src, int64_t* __restrict__ dst,
           const int32_t* __restrict__ vsrc, int32_t* __restrict__ vdst,
           int64_t n, int words, PassArgs a, uint32_t* next_tile,
           uint32_t* status) {
  constexpr int TILE = THREADS * ITEMS;
  constexpr int WARPS = THREADS / 32;
  constexpr int RADIX = MODE == SPLIT_HIGH ? HIGH_RADIX : RS_RADIX;
  // a slot's tag: its bucket (the split) or its digit (the fallback)
  using Tag = typename std::conditional<MODE == SEGMENTS, uint8_t,
                                        uint32_t>::type;
  static_assert(ITEMS % 2 == 0, "slots are packed two to a register");
  static_assert(TILE < (1 << 16), "a slot must fit 16 bits");
  static_assert(WARPS * 2 * RADIX * 4 <= TILE * 8,
                "the match tables must fit under the buffer");
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* s_buf = reinterpret_cast<int64_t*>(smem);           // [TILE]
  int32_t* s_warp = reinterpret_cast<int32_t*>(s_buf + TILE);  // [WARPS][R]
  int32_t* s_start = s_warp + WARPS * RADIX;                   // [RADIX]
  int32_t* s_global = s_start + RADIX;                         // [RADIX]
  Tag* s_tag = reinterpret_cast<Tag*>(s_global + RADIX);       // [TILE]
  uint32_t* s_match = reinterpret_cast<uint32_t*>(smem);       // over s_buf
  __shared__ uint32_t s_tile;
  __shared__ int s_seg;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  kat::take_tile(next_tile, &s_tile);
  for (int i = tid; i < WARPS * RADIX; i += THREADS) s_warp[i] = 0;
  for (int i = tid; i < WARPS * 2 * RADIX; i += THREADS) s_match[i] = 0;
  __syncthreads();
  const int64_t tile = s_tile;
  int64_t local = tile, base = tile * TILE, end = n;
  int seg = 0;
  if constexpr (MODE == SEGMENTS) {
    if (tid == 0) s_seg = segment_of(a.seg_tile, a.segs, tile);
    __syncthreads();
    seg = s_seg;
    local = tile - a.seg_tile[seg];
    base = a.seg_start[seg] + local * TILE;
    end = (int64_t)a.seg_start[seg] + a.seg_len[seg];
  }
  const int valid_n = (int)min((int64_t)TILE, end - base);

  // 1. the warp's slice, 32 consecutive keys a step: the fallback keeps the
  //    digit's word (the first plane out), the split each key's bucket
  //    (from the top word and, where t < 16, the next)
  constexpr bool SEG = MODE == SEGMENTS;
  const int plane0 = SEG ? a.word : 0;
  int64_t key[SEG ? ITEMS : 1];
  Tag tag[SEG ? 1 : ITEMS];
  const int first = warp * (ITEMS * 32) + lane;
  const int64_t* k0 = src + (int64_t)plane0 * n + base;
#pragma unroll
  for (int i = 0; i < ITEMS; i++) {
    const int j = first + i * 32;
    if constexpr (SEG) {
      key[i] = j < valid_n ? k0[j] : 0;
    } else {
      const uint64_t w0 = j < valid_n ? (uint64_t)k0[j] : 0;
      const uint64_t w1 =
          j < valid_n && a.t < PREFIX_BITS ? (uint64_t)src[n + base + j] : 0;
      tag[i] = bucket_of(w0, w1, a.t);
    }
  }
  auto digit = [](Tag g) -> int {
    if constexpr (MODE == SPLIT_LOW) return (int)(g & 255u);
    else if constexpr (MODE == SPLIT_HIGH) return (int)(g >> 8);
    else return (int)g;
  };
  auto item_tag = [&](int i) -> Tag {
    if constexpr (SEG) return (Tag)digit_of(key[i], a.shift);
    else return tag[i];
  };

  // 2. rank every key among the keys of its digit in this warp's slice (as
  //    radix_onesweep)
  unsigned slot2[ITEMS / 2];
  int32_t* my_warp = s_warp + warp * RADIX;
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < ITEMS; i++) {
    const bool valid = first + i * 32 < valid_n;
    const int d = digit(item_tag(i));
    uint32_t* match = s_match + (warp * 2 + i % 2) * RADIX;
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
  if (tid < RADIX) {
#pragma unroll
    for (int w = 0; w < WARPS; w++) {
      const int c = s_warp[w * RADIX + tid];
      s_warp[w * RADIX + tid] = count;
      count += c;
    }
  }
  int tile_total;
  const int start = kat::block_exclusive_scan(count, &tile_total);
  uint32_t* my_status = status + tile * RADIX + tid;
  if (tid < RADIX) {
    s_start[tid] = start;
    kat::st_relaxed(my_status, FLAG_AGGREGATE | (uint32_t)count);
  }
  __syncthreads();

  // 4. each key's slot in the tile's sorted-by-digit order (kept, packed,
  //    for the planes) and its tag; the fallback's digit word in place
#pragma unroll
  for (int i = 0; i < ITEMS; i++) {
    if (first + i * 32 < valid_n) {
      const Tag g = item_tag(i);
      const int d = digit(g);
      const unsigned r = (slot2[i / 2] >> (16 * (i % 2))) & 0xffffu;
      const unsigned slot = (unsigned)(s_start[d] + my_warp[d]) + r;
      slot2[i / 2] = i % 2 ? (slot2[i / 2] & 0xffffu) | slot << 16
                           : (slot2[i / 2] & 0xffff0000u) | slot;
      if constexpr (SEG) s_buf[slot] = key[i];
      s_tag[slot] = g;
    }
  }

  // 5. look back (within the segment) for each digit's place, then publish
  //    this tile's
  if (tid < RADIX) {
    const uint32_t before =
        kat::look_back<DigitStatus, LOOK_BACK>(my_status, local, RADIX);
    kat::st_relaxed(my_status, FLAG_PREFIX | (before + (uint32_t)count));
    int64_t at;
    if constexpr (MODE == SEGMENTS)
      at = (int64_t)a.seg_start[seg] +
           a.base[((int64_t)seg * a.passes + a.pass) * RS_RADIX + tid];
    else
      at = a.base[tid];
    s_global[tid] = (int32_t)(at + before) - start;
  }
  __syncthreads();

  // 6. every plane out, the first plane's first: consecutive threads,
  //    consecutive keys of one digit
  for (int q = 0; q < words; q++) {
    const int plane = q == 0 ? plane0 : q <= plane0 ? q - 1 : q;
    if (q > 0 || !SEG) {
      if (q > 0) __syncthreads();  // every thread has written the last out
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
      pdst[s_global[digit(s_tag[j])] + j] = s_buf[j];
  }

  // 7. the values, if any, the same way through the buffer
  if (vsrc != nullptr) {
    int32_t* s_val = reinterpret_cast<int32_t*>(s_buf);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ITEMS; i++) {
      const int j = first + i * 32;
      if (j < valid_n)
        s_val[(slot2[i / 2] >> (16 * (i % 2))) & 0xffffu] = vsrc[base + j];
    }
    __syncthreads();
    for (int j = tid; j < valid_n; j += THREADS)
      vdst[s_global[digit(s_tag[j])] + j] = s_val[j];
  }

  // 8. the high pass counts every bucket: the tile's slots are in (high
  //    digit, input) order and its input is in low-digit order, so each
  //    bucket's slots lie together; a run adds its end and takes its start
  if constexpr (MODE == SPLIT_HIGH) {
    for (int j = tid; j < valid_n; j += THREADS) {
      const uint32_t b = s_tag[j];
      if (b == SENT_BUCKET) continue;
      if (j == valid_n - 1 || s_tag[j + 1] != b)
        atomicAdd(&a.count2d[b], (uint32_t)(j + 1));
      if (j == 0 || s_tag[j - 1] != b)
        atomicAdd(&a.count2d[b], 0u - (uint32_t)j);
    }
  }
}

template <int THREADS, int ITEMS, int MODE>
constexpr int pass_smem() {
  constexpr int radix = MODE == SPLIT_HIGH ? HIGH_RADIX : RS_RADIX;
  return THREADS * ITEMS * (8 + (MODE == SEGMENTS ? 1 : 4)) +
         (THREADS / 32 + 2) * radix * 4;
}

// The bucket counts (count2d) become their starts (bstart, [BUCKETS] and
// n_real after them), and [0, n_real) is cut into units (ustart, uover) and
// oversize segments (ostart, olen, otile); the head gets their numbers.  A
// block a 1024 buckets, tiles from the counter: a look-back over the
// blocks' key counts gives each bucket's start, a second one over the
// blocks' (units, oversize, tiles) the places of its units.
// A 64-bit status word: flag << 62 | value (flag 1: the block alone, 2: the
// blocks up to and including it).
struct SumStatus {
  using Word = uint64_t;
  using Value = uint64_t;
  static constexpr Word NOTHING = 2ull << 62;
  __device__ static Value identity() { return 0; }
  __device__ static bool ready(Word w) { return (w >> 62) != 0; }
  __device__ static bool prefix(Word w) { return (w >> 62) == 2; }
  __device__ static Value value(Word w) { return w & ((1ull << 62) - 1); }
  __device__ static Value combine(Value a, Value b) { return a + b; }
  __device__ static Value shfl(Value v, int src) {
    return __shfl_sync(0xffffffffu, v, src);
  }
};

// (units, oversize segments, their tiles) packed 20 bits each: none of the
// three passes 2^20 (65,536 buckets; n < 2^30 keys in 8192-key tiles plus
// one partial tile a segment), so sums never carry between fields
__device__ __forceinline__ uint32_t field(uint64_t v, int f) {
  return (uint32_t)(v >> (20 * f)) & ((1u << 20) - 1);
}

// The block's exclusive prefix over the blocks below, from its aggregate:
// warp 0 publishes, looks back and publishes the inclusive prefix.
__device__ __forceinline__ uint64_t plan_prefix(uint64_t* status,
                                                int64_t tile, uint64_t total,
                                                uint64_t* s_out) {
  if (threadIdx.x < 32) {
    uint64_t before = 0;
    if (tile > 0) {
      if (threadIdx.x == 0) kat::st_relaxed(status + tile, 1ull << 62 | total);
      before = kat::look_back<SumStatus, 1, 32>(status + tile, tile, 1);
    }
    if (threadIdx.x == 0) {
      kat::st_relaxed(status + tile, 2ull << 62 | (before + total));
      *s_out = before;
    }
  }
  __syncthreads();
  return *s_out;
}

__global__ void __launch_bounds__(PLAN_THREADS)
split_plan(SplitState* st, const uint32_t* __restrict__ count,
           uint32_t* bstart, uint32_t* ustart, uint8_t* uover,
           uint32_t* ostart, uint32_t* olen, uint32_t* otile) {
  __shared__ uint32_t s_tile;
  __shared__ uint64_t s_before;
  __shared__ uint32_t s_start[PLAN_THREADS], s_size[PLAN_THREADS];
  const int tid = threadIdx.x;
  kat::take_tile(&st->plan_tile, &s_tile);
  __syncthreads();
  const int64_t tile = s_tile;
  const int b = (int)tile * PLAN_THREADS + tid;

  // 1. the bucket's start
  const uint32_t size = count[b];
  uint32_t total;
  const uint32_t ex = kat::block_exclusive_scan(size, &total);
  const uint64_t below =
      plan_prefix(st->plan_status[0], tile, total, &s_before);
  const uint32_t start = (uint32_t)below + ex;
  bstart[b] = start;
  s_start[tid] = start;
  s_size[tid] = size;
  __syncthreads();

  // 2. does it open a unit? (the bucket before may lie in the block below)
  uint32_t prev_start = 0, prev_size = 0;
  if (tid > 0) {
    prev_start = s_start[tid - 1];
    prev_size = s_size[tid - 1];
  } else if (b > 0) {
    prev_size = count[b - 1];
    prev_start = start - prev_size;
  }
  const bool opens = b == 0 || size > (uint32_t)BS_SMALL ||
                     prev_size > (uint32_t)BS_SMALL ||
                     start / BS_SMALL != prev_start / BS_SMALL;
  const bool over = size > (uint32_t)BS_CAP;
  const uint64_t mine =
      (uint64_t)opens | (uint64_t)over << 20 |
      (uint64_t)(over ? (size + FB_TILE - 1) / FB_TILE : 0) << 40;
  uint64_t block_total;
  const uint64_t at = kat::block_exclusive_scan(mine, &block_total) +
                      plan_prefix(st->plan_status[1], tile, block_total,
                                  &s_before);

  // 3. its unit and oversize segment
  if (opens) {
    const uint32_t u = field(at, 0);
    ustart[u] = start;
    uover[u] = over;
    if (over) {
      const uint32_t o = field(at, 1);
      ostart[o] = start;
      olen[o] = size;
      otile[o] = field(at, 2);
    }
  }
  if (b == BUCKETS - 1) {  // the last bucket: every block below is counted
    const uint64_t all = at + mine;
    const uint32_t n_real = start + size;
    bstart[BUCKETS] = n_real;
    ustart[field(all, 0)] = n_real;
    otile[field(all, 1)] = field(all, 2);
    st->head = {field(all, 0), field(all, 1), field(all, 2), 0u};
  }
}

// The words below the abbreviated keys of two keys of one unit, by slot,
// compared (-1, 0, 1): the first from shared memory (`tie`, word tie_from
// of the unit's keys by slot), any further ones from L1/L2.
struct UnitWords {
  const int64_t* keys;  // the unit's first key, plane stride n
  int64_t n;
  int words, tie_from;
  __device__ __forceinline__ int cmp(uint32_t sa, uint32_t sb,
                                     const int64_t* tie) const {
    if (tie[sa] != tie[sb]) return tie[sa] < tie[sb] ? -1 : 1;
    for (int q = tie_from + 1; q < words; q++) {
      const int64_t wa = __ldg(keys + q * n + sa);
      const int64_t wb = __ldg(keys + q * n + sb);
      if (wa != wb) return wa < wb ? -1 : 1;
    }
    return 0;
  }
};

constexpr int BS_RUNS = BS_CAP;   // the counting pass's runs
constexpr int BS_RUN_MAX = 128;   // a longer run: the unit is merge sorted
static_assert(BS_RUNS == BS_THREADS * 8, "run counts are scanned 8 a thread");
// abbreviated keys by slot and by run; the slot at each position of the
// runs and of the order; the run counts (then a mark a position)
constexpr int BS_SMEM = BS_CAP * 8 * 2 + BS_CAP * 2 * 2 + (BS_RUNS + 1) * 4;

// Sort each unit of at most CAP keys in place (blocks of oversize units
// leave at once), in two steps:
// - by abbreviated key, equal ones in slot order, in shared memory alone:
//   a key's bucket (its prefix) holds n keys from its start in the unit on,
//   and the 48 bits below the prefix place the key in one of n runs there,
//   in proportion (one counting pass); each key counts the keys before it
//   in its run (~1 key for random keys, a k-mer's copies for a counting
//   flush; insertion, one thread a run, measured far slower on such
//   copies).  A unit with a run of more
//   than BS_RUN_MAX keys (keys clustered inside their bucket, a k-mer seen
//   that often) is merge sorted instead (8 keys a thread in registers, then
//   merge-path merges through shared memory; both stable);
// - where keys share their abbreviated key (the same first 64 significant
//   bits), their lower words are compared: each key with the one before
//   it, all at once (the first word below from shared memory, any further
//   ones from L1/L2), and only a group in which two differ is sorted
//   again, by insertion on every word (ties by slot).  A counting flush's
//   copies of one k-mer are compared once each and never moved.
__global__ void __launch_bounds__(BS_THREADS, 2)
sort_units(int64_t* keys, int32_t* vals, int64_t n, int words, int t,
           const uint32_t* __restrict__ ustart,
           const uint8_t* __restrict__ uover,
           const uint32_t* __restrict__ bstart) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* s_key = reinterpret_cast<uint64_t*>(smem);         // [CAP]
  uint64_t* s_run = s_key + BS_CAP;                            // [CAP]
  uint16_t* s_slot = reinterpret_cast<uint16_t*>(s_run + BS_CAP);  // [CAP]
  uint16_t* s_order = s_slot + BS_CAP;                             // [CAP]
  uint32_t* s_cnt = reinterpret_cast<uint32_t*>(s_order + BS_CAP);  // [RUNS+1]
  uint8_t* s_mark = reinterpret_cast<uint8_t*>(s_cnt);  // [CAP], after 5.
  __shared__ int s_longest;
  const int tid = threadIdx.x;
  const int64_t lo = ustart[blockIdx.x];
  const int m = (int)(ustart[blockIdx.x + 1] - lo);
  if (uover[blockIdx.x] || m <= 1) return;
  const UnitWords below{keys + lo, n, words, first_tie_word(t)};

  // 1. abbreviated keys in (coalesced), padding after m
  for (int j = tid; j < BS_CAP; j += BS_THREADS)
    s_key[j] = j < m ? abbrev_of(keys, n, lo + j, words, t) : ~0ull;
  for (int i = tid; i <= BS_RUNS; i += BS_THREADS) s_cnt[i] = 0;
  if (tid == 0) s_longest = 0;
  __syncthreads();

  // 2. each key's run and its place among the run's keys (in no order)
  constexpr int PER = BS_CAP / BS_THREADS;
  constexpr uint64_t LOW = (1ull << (64 - PREFIX_BITS)) - 1;
  uint32_t run[PER], place[PER];
#pragma unroll
  for (int e = 0; e < PER; e++) {
    const int j = tid + e * BS_THREADS;
    if (j < m) {
      const uint64_t a = s_key[j];
      const uint32_t b = (uint32_t)(a >> (64 - PREFIX_BITS));
      const uint32_t first = bstart[b], count = bstart[b + 1] - first;
      run[e] = first - (uint32_t)lo + (uint32_t)(((a & LOW) * count) >>
                                                  (64 - PREFIX_BITS));
      place[e] = atomicAdd(&s_cnt[run[e]], 1u);
    }
  }
  __syncthreads();

  // 3. the runs' starts, 8 counts a thread
  {
    uint32_t c[8], sum = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
      c[i] = s_cnt[tid * 8 + i];
      sum += c[i];
    }
    uint32_t total;
    uint32_t at = kat::block_exclusive_scan(sum, &total);
#pragma unroll
    for (int i = 0; i < 8; i++) {
      s_cnt[tid * 8 + i] = at;
      at += c[i];
    }
    if (tid == BS_THREADS - 1) s_cnt[BS_RUNS] = at;
  }
  __syncthreads();

  // 4. every key into its run, as its abbreviated key below the prefix
  //    (which a run shares) and its slot in one word, so that one compare
  //    orders two keys of a run by (abbreviated key, slot); the longest run
#pragma unroll
  for (int e = 0; e < PER; e++) {
    const int j = tid + e * BS_THREADS;
    if (j < m) s_run[s_cnt[run[e]] + place[e]] = s_key[j] << PREFIX_BITS | j;
  }
  int longest = 0;
  for (int d = tid; d < BS_RUNS; d += BS_THREADS)
    longest = max(longest, (int)(s_cnt[d + 1] - s_cnt[d]));
  atomicMax(&s_longest, longest);
  __syncthreads();

  // the order: abbreviated keys and slots; then a free buffer of CAP words
  uint64_t* ord_run = s_run;
  uint16_t* ord_slot = s_order;
  int64_t* spare = reinterpret_cast<int64_t*>(s_key);
  if (s_longest <= BS_RUN_MAX) {
    // 5. each key's place: its run's start and the keys of its run before
    //    it; then every key to its place (the run words are all read first)
#pragma unroll
    for (int e = 0; e < PER; e++) {
      const int j = tid + e * BS_THREADS;
      if (j < m) {
        const int a = (int)s_cnt[run[e]], b = (int)s_cnt[run[e] + 1];
        const uint64_t x = s_run[a + place[e]];
        int before = 0;
        for (int q = a; q < b; q++) before += s_run[q] < x;
        run[e] = (uint32_t)(a + before);
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < PER; e++) {
      const int j = tid + e * BS_THREADS;
      if (j < m) {
        ord_run[run[e]] = s_key[j];
        ord_slot[run[e]] = (uint16_t)j;
      }
    }
  } else {
    // 5'. merge sort on the abbreviated key: each thread's 8 consecutive
    //     slots in registers (odd-even transposition: equal keys never
    //     pass each other), then runs of len, 2 len, ... merged until one
    //     holds every key: each thread finds where its 8 outputs start on
    //     the merge path (ties take the lower run) and merges them.  Padding
    //     (~0 past m) stays after any key of its value: stability.
    uint64_t k[BS_ITEMS];
    uint32_t s[BS_ITEMS];
    const int j0 = tid * BS_ITEMS;
#pragma unroll
    for (int e = 0; e < BS_ITEMS; e++) {
      k[e] = s_key[j0 + e];
      s[e] = (uint32_t)(j0 + e);
    }
#pragma unroll
    for (int r = 0; r < BS_ITEMS; r++) {
#pragma unroll
      for (int e = r & 1; e + 1 < BS_ITEMS; e += 2) {
        if (k[e + 1] < k[e]) {
          const uint64_t tk = k[e];
          k[e] = k[e + 1];
          k[e + 1] = tk;
          const uint32_t ts = s[e];
          s[e] = s[e + 1];
          s[e + 1] = ts;
        }
      }
    }
    for (int len = BS_ITEMS; len < m; len *= 2) {
      __syncthreads();
#pragma unroll
      for (int e = 0; e < BS_ITEMS; e++) {
        s_run[j0 + e] = k[e];
        s_slot[j0 + e] = (uint16_t)s[e];
      }
      __syncthreads();
      const int pair = j0 & ~(2 * len - 1);
      if (pair >= m) continue;  // padding only: already in order
      const int a0 = pair, b0 = pair + len, diag = j0 - pair;
      int lo_ = max(0, diag - len), hi_ = min(diag, len);
      while (lo_ < hi_) {
        const int mid = (lo_ + hi_) >> 1;
        if (!(s_run[b0 + diag - 1 - mid] < s_run[a0 + mid])) lo_ = mid + 1;
        else hi_ = mid;
      }
      int ia = a0 + lo_, ib = b0 + diag - lo_;
      const int ea = b0, eb = b0 + len;
#pragma unroll
      for (int e = 0; e < BS_ITEMS; e++) {
        const bool take_b =
            ib < eb && (ia >= ea || s_run[ib] < s_run[ia]);
        const int from = take_b ? ib++ : ia++;
        k[e] = s_run[from];
        s[e] = s_slot[from];
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < BS_ITEMS; e++) {
      s_run[j0 + e] = k[e];
      s_slot[j0 + e] = (uint16_t)s[e];
    }
    ord_slot = s_slot;
  }
  __syncthreads();

  // 6. keys that share their abbreviated key: is each one's lower words
  //    equal to the key's before it?  A group with a difference is sorted
  //    by every word (ties by slot) by its first position's thread.
  if (below.tie_from < words) {
    int64_t* s_tie = spare;
    const int64_t* tie_plane = keys + below.tie_from * n + lo;
    for (int j = tid; j < m; j += BS_THREADS) s_tie[j] = tie_plane[j];
    __syncthreads();
    bool any = false;
#pragma unroll
    for (int e = 0; e < PER; e++) {
      const int i = tid + e * BS_THREADS;
      if (i < m) {
        s_mark[i] = i > 0 && ord_run[i] == ord_run[i - 1] &&
                    below.cmp(ord_slot[i - 1], ord_slot[i], s_tie) != 0;
        any |= s_mark[i];
      }
    }
    const bool differs = __syncthreads_or(any);  // s_mark is complete
    for (int i = tid; i < m && differs; i += BS_THREADS) {
      if (i > 0 && ord_run[i] == ord_run[i - 1]) continue;  // inside a group
      int e = i + 1;
      bool differ = false;
      while (e < m && ord_run[e] == ord_run[i]) differ |= s_mark[e++];
      if (!differ) continue;
      for (int p = i + 1; p < e; p++) {
        const uint16_t xs = ord_slot[p];
        int q = p;
        for (; q > i; q--) {
          const int c = below.cmp(xs, ord_slot[q - 1], s_tie);
          if (!(c < 0 || (c == 0 && xs < ord_slot[q - 1]))) break;
          ord_slot[q] = ord_slot[q - 1];
        }
        ord_slot[q] = xs;
      }
    }
    __syncthreads();
  }

  // 7. a unit already in order is left as it is
  bool same = true;
  for (int j = tid; j < m; j += BS_THREADS) same &= ord_slot[j] == j;
  if (__syncthreads_and(same)) return;

  // 8. each plane (and the value) staged in shared memory and written back
  //    in sorted order
  int64_t* stage = spare;
  for (int q = 0; q < words; q++) {
    int64_t* plane = keys + q * n + lo;
    for (int j = tid; j < m; j += BS_THREADS) stage[j] = plane[j];
    __syncthreads();
    for (int j = tid; j < m; j += BS_THREADS) plane[j] = stage[ord_slot[j]];
    __syncthreads();
  }
  if (vals != nullptr) {
    int32_t* v = vals + lo;
    int32_t* s_val = reinterpret_cast<int32_t*>(spare);
    for (int j = tid; j < m; j += BS_THREADS) s_val[j] = v[j];
    __syncthreads();
    for (int j = tid; j < m; j += BS_THREADS) v[j] = s_val[ord_slot[j]];
  }
}

// The fallback's scratch, in int32 words.
struct FallbackLayout {
  int64_t next_tile, seg_done, seg_base, status, total;
  FallbackLayout(int64_t segs, int64_t tiles, int passes) {
    next_tile = 0;
    seg_done = FB_MAX_PASSES;
    seg_base = seg_done + segs;
    status = seg_base + segs * passes * RS_RADIX;
    total = status + (int64_t)passes * tiles * RS_RADIX;
  }
};

// Each oversize segment's digit counts for every fallback pass, then (the
// segment's last tile to finish) their scans: one block a fallback tile.
// With `copy` the tile's planes and values also go to the other buffer,
// where the first fallback pass reads them (an odd number of passes then
// ends in `keys`).
__global__ void __launch_bounds__(FB_THREADS)
segment_histogram(const int64_t* __restrict__ keys,
                  const int32_t* __restrict__ vals, int64_t* __restrict__ alt,
                  int32_t* __restrict__ valt, int64_t n, int words,
                  Digits dg, PassArgs a, uint32_t* seg_base,
                  uint32_t* seg_done, bool copy) {
  extern __shared__ uint32_t cnt[];  // [passes][256]
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const int seg = segment_of(a.seg_tile, a.segs, blockIdx.x);
  const int64_t local = blockIdx.x - a.seg_tile[seg];
  const int64_t base = a.seg_start[seg] + local * FB_TILE;
  const int valid_n = (int)min((int64_t)FB_TILE,
                               (int64_t)a.seg_start[seg] + a.seg_len[seg] -
                                   base);
  for (int i = tid; i < dg.n * RS_RADIX; i += FB_THREADS) cnt[i] = 0;
  __syncthreads();
  for (int j = tid; j < valid_n; j += FB_THREADS) {
    for (int p = 0; p < dg.n; p++)
      atomicAdd(&cnt[p * RS_RADIX +
                     digit_of(keys[dg.word[p] * n + base + j], dg.shift[p])],
                1u);
    if (copy) {
      for (int q = 0; q < words; q++)
        alt[q * n + base + j] = keys[q * n + base + j];
      if (vals != nullptr) valt[base + j] = vals[base + j];
    }
  }
  __syncthreads();
  uint32_t* mine = seg_base + (int64_t)seg * dg.n * RS_RADIX;
  for (int i = tid; i < dg.n * RS_RADIX; i += FB_THREADS)
    if (cnt[i]) atomicAdd(mine + i, cnt[i]);
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const uint32_t tiles = a.seg_tile[seg + 1] - a.seg_tile[seg];
    s_last = atomicAdd(seg_done + seg, 1u) == tiles - 1;
    __threadfence();
  }
  __syncthreads();
  if (!s_last) return;
  for (int p = 0; p < dg.n; p++) {
    const uint32_t c =
        tid < RS_RADIX ? kat::ld_relaxed(mine + p * RS_RADIX + tid) : 0u;
    uint32_t total;
    const uint32_t ex = kat::block_exclusive_scan(c, &total);
    if (tid < RS_RADIX) mine[p * RS_RADIX + tid] = ex;
  }
}

bool words_args_ok(int words, int top_bits) {
  return words >= 2 && words <= WS_MAX_WORDS && top_bits >= 1 &&
         top_bits <= 63;
}

}  // namespace

// Keys a tile of the W-word sort's whole-array passes takes (for any W).
extern "C" int kat_radix_sort_words_tile(int words) {
  (void)words;
  return SP_TILE;
}

// Keys a block of the W-word sort's bucket sort takes at most: a bucket
// past it is sorted by the fallback passes.
extern "C" int kat_radix_sort_words_bucket_cap() { return BS_CAP; }

// int32 scratch elements kat_sort_words_split needs.
extern "C" int64_t kat_sort_words_split_scratch(int64_t n, int words,
                                                int top_bits) {
  (void)words;
  (void)top_bits;
  return SplitLayout(n).total;
}

// Steps 1-2 of the W-word sort of keys [words][n] (and vals [n] when not
// null): the histogram, the two split passes (keys -> alt -> out) and the
// plan.  The head (scratch words 0-2: units, oversize segments, their
// tiles) is what kat_sort_words_finish is then called with.  Requires 2 <=
// words <= 9, 0 < n < 2^30, every lower word < 2^62 and every non-sentinel
// top word < 2^(top_bits - 1).  keys and vals are not modified.
extern "C" int kat_sort_words_split(const int64_t* keys, const int32_t* vals,
                                    int64_t* out, int32_t* vout, int64_t* alt,
                                    int32_t* valt, int32_t* scratch,
                                    int64_t n, int words, int top_bits,
                                    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (!words_args_ok(words, top_bits) || n <= 0 || n >= (1 << 30))
    return (int)cudaErrorInvalidValue;
  if (vals != nullptr && (vout == nullptr || valt == nullptr))
    return (int)cudaErrorInvalidValue;
  const SplitLayout L(n);
  SplitState* st = reinterpret_cast<SplitState*>(scratch);
  uint32_t* base = reinterpret_cast<uint32_t*>(scratch);
  const int t = top_bits - 1;

  auto low = words_pass<SP_THREADS, SP_ITEMS, SPLIT_LOW>;
  auto high = words_pass<SP_THREADS, SP_ITEMS, SPLIT_HIGH>;
  constexpr int LOW_SMEM = pass_smem<SP_THREADS, SP_ITEMS, SPLIT_LOW>();
  constexpr int HIGH_SMEM = pass_smem<SP_THREADS, SP_ITEMS, SPLIT_HIGH>();
  static int sms_low[kat::MAX_DEVICES] = {};
  static int sms_high[kat::MAX_DEVICES] = {};
  int sms;
  cudaError_t err = kat::prepare(low, LOW_SMEM, sms_low, &sms);
  if (err != cudaSuccess) return (int)err;
  err = kat::prepare(high, HIGH_SMEM, sms_high, &sms);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(scratch, 0, L.zeroed * sizeof(int32_t), stream);
  if (err != cudaSuccess) return (int)err;

  const int64_t hist_blocks =
      std::min(tiles_for(n, HIST_TILE), (int64_t)sms * (2048 / HIST_THREADS));
  split_histogram<<<(unsigned)hist_blocks, HIST_THREADS, 0, stream>>>(
      keys, n, t, st);
  KAT_CHECK_LAUNCH();

  PassArgs a{};
  a.t = t;
  a.base = &st->base[0][0];
  low<<<(unsigned)L.tiles, SP_THREADS, LOW_SMEM, stream>>>(
      keys, alt, vals, valt, n, words, a, &st->next_tile[0],
      base + L.status);
  KAT_CHECK_LAUNCH();
  a.base = &st->base[1][0];
  a.count2d = base + L.count2d;
  high<<<(unsigned)L.tiles, SP_THREADS, HIGH_SMEM, stream>>>(
      alt, out, valt, vout, n, words, a, &st->next_tile[1],
      base + L.status + L.tiles * HIGH_RADIX);
  KAT_CHECK_LAUNCH();

  split_plan<<<PLAN_BLOCKS, PLAN_THREADS, 0, stream>>>(
      st, base + L.count2d, base + L.bstart, base + L.ustart,
      reinterpret_cast<uint8_t*>(base + L.uover), base + L.ostart,
      base + L.olen, base + L.otile);
  KAT_CHECK_LAUNCH();
  return 0;
}

// int32 scratch elements kat_sort_words_finish needs for n_over oversize
// segments of over_tiles tiles and n_digits fallback digits.
extern "C" int64_t kat_sort_words_fallback_scratch(int64_t n_over,
                                                   int64_t over_tiles,
                                                   int n_digits) {
  return FallbackLayout(n_over, over_tiles, n_digits).total;
}

// Steps 3-4: the bucket sort of every unit in place in out (and vout), then
// the fallback over the n_over oversize segments (over_tiles tiles) on the
// n_digits digits digits[i] = word << 8 | shift (a host array, least
// significant first), through alt (valt) and back into out.  n_units,
// n_over and over_tiles are kat_sort_words_split's head; fscratch (null
// when n_over is 0) as kat_sort_words_fallback_scratch.
extern "C" int kat_sort_words_finish(int64_t* out, int32_t* vout,
                                     int64_t* alt, int32_t* valt,
                                     int32_t* scratch, int32_t* fscratch,
                                     int64_t n, int words, int top_bits,
                                     int64_t n_units, int64_t n_over,
                                     int64_t over_tiles,
                                     const int32_t* digits, int n_digits,
                                     void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (!words_args_ok(words, top_bits) || n <= 0 || n >= (1 << 30) ||
      n_units < 0 || n_units > BUCKETS || n_over < 0 || n_over > n_units ||
      n_digits < 0 || n_digits > FB_MAX_PASSES ||
      (n_over > 0 && (fscratch == nullptr || n_digits == 0)))
    return (int)cudaErrorInvalidValue;
  const SplitLayout L(n);
  uint32_t* base = reinterpret_cast<uint32_t*>(scratch);
  if (n_units > 0) {
    static int sms_units[kat::MAX_DEVICES] = {};
    int sms;
    const cudaError_t err = kat::prepare(sort_units, BS_SMEM, sms_units, &sms);
    if (err != cudaSuccess) return (int)err;
    sort_units<<<(unsigned)n_units, BS_THREADS, BS_SMEM, stream>>>(
        out, vout, n, words, top_bits - 1, base + L.ustart,
        reinterpret_cast<const uint8_t*>(base + L.uover), base + L.bstart);
    KAT_CHECK_LAUNCH();
  }
  if (n_over == 0) return 0;

  Digits dg{};
  dg.n = n_digits;
  for (int p = 0; p < n_digits; p++) {
    dg.word[p] = (uint8_t)(digits[p] >> 8);
    dg.shift[p] = (uint8_t)(digits[p] & 255);
    if (dg.word[p] >= words || dg.shift[p] > 56 || dg.shift[p] % 8)
      return (int)cudaErrorInvalidValue;
  }
  const FallbackLayout F(n_over, over_tiles, n_digits);
  uint32_t* fb = reinterpret_cast<uint32_t*>(fscratch);
  auto pass = words_pass<FB_THREADS, FB_ITEMS, SEGMENTS>;
  constexpr int PASS_SMEM = pass_smem<FB_THREADS, FB_ITEMS, SEGMENTS>();
  const int HIST_SMEM = n_digits * RS_RADIX * (int)sizeof(uint32_t);
  static int sms_pass[kat::MAX_DEVICES] = {};
  static int sms_hist[kat::MAX_DEVICES] = {};
  int sms;
  cudaError_t err = kat::prepare(pass, PASS_SMEM, sms_pass, &sms);
  if (err != cudaSuccess) return (int)err;
  err = kat::prepare(segment_histogram, FB_MAX_PASSES * RS_RADIX * 4,
                     sms_hist, &sms);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(fscratch, 0, F.total * sizeof(int32_t), stream);
  if (err != cudaSuccess) return (int)err;

  PassArgs a{};
  a.base = fb + F.seg_base;
  a.seg_start = base + L.ostart;
  a.seg_len = base + L.olen;
  a.seg_tile = base + L.otile;
  a.segs = (int)n_over;
  a.passes = n_digits;
  // an odd number of passes starts from alt, so that the last lands in out
  const bool odd = n_digits % 2 == 1;
  segment_histogram<<<(unsigned)over_tiles, FB_THREADS, HIST_SMEM, stream>>>(
      out, vout, alt, valt, n, words, dg, a, fb + F.seg_base,
      fb + F.seg_done, odd);
  KAT_CHECK_LAUNCH();
  for (int p = 0; p < n_digits; p++) {
    const bool from_alt = (p % 2 == 0) == odd;
    a.word = dg.word[p];
    a.shift = dg.shift[p];
    a.pass = p;
    pass<<<(unsigned)over_tiles, FB_THREADS, PASS_SMEM, stream>>>(
        from_alt ? alt : out, from_alt ? out : alt,
        vout == nullptr ? nullptr : from_alt ? valt : vout,
        from_alt ? vout : valt, n, words, a, fb + F.next_tile + p,
        fb + F.status + (int64_t)p * over_tiles * RS_RADIX);
    KAT_CHECK_LAUNCH();
  }
  return 0;
}

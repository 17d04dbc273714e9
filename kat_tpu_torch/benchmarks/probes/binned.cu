// csrc/binned.cu with its timing probes and build knobs, for
// benchmarks/profile_binned_chunks.py alone: built with no flags it is the
// port's kernel; -DKAT_BN_MAX_STAGES=N stages at most N tiles a block;
// -DKAT_BN_PROBE=1 adds to the first pass's counters without atomics, 2
// does not add at all, 3 only stages the tiles (the counts are then
// wrong and not checked).  Same C entry points as csrc/binned.cu, built
// into a library of its own; the port never calls it.
//
// Binned sums: for each request r = (div, mod, mask), out_r[b] is the number
// of elements i with masks[mask][i] != 0 and (keys[i] / div) % mod == b.
//
// Replaces the binned form of K1 + K3 in kat_tpu/core/stats.py: binned_sums
// (stats.py:38-70) sorts a u32 bin plane carrying 1-3 u32 mask planes
// through kat_tpu/ops/sort_kernel.py::_window_kernel (sort_planes_padded,
// stats.py:58) and reduces the sorted bins through
// kat_tpu/ops/reduce_kernel.py::_reduce_kernel (reduce_compact_sorted,
// stats.py:63), then scatters the few run sums; monotone_packed_sums
// (stats.py:78-178) does the same for bins derived from one packed key,
// (packed // div) % mod (stats.py:124,153).  kat_tpu sorts because a
// scatter is slow on the TPU; here block-private counters in shared memory
// take the adds.  Integer adds make the result exact in any order
// (tolerance 0).
//
// What bounds it on the H100: device-memory traffic, one read of the keys
// (4 bytes an element) and of each mask (1 byte), one write of each output
// bin (8 bytes): at 2^24 elements and one mask about 0.025 ms.  The design:
//   - requests with the same (div, mod) form a group and share one bin
//     computation.  Division by run-time div and mod is a multiply-high and
//     a shift: the host computes m = ceil(2^(31 + l) / d), l = ceil(log2 d),
//     and then x / d == umulhi(x, m) >> (l - 1) for every x < 2^31
//     (Granlund and Montgomery 1994, theorem 4.2: m * d - 2^(31 + l) < d
//     <= 2^l); d == 1 skips the step;
//   - the tiles of 4096 keys and their mask bytes reach shared memory by
//     16-byte cp.async copies of the aligned memory around them (planes
//     and views at any byte offset), in persistent blocks that keep 2-5
//     tiles in flight while they count one (stages picked per launch from
//     what shared memory holds, two blocks an SM where they fit: 80-170 KB
//     in flight an SM).  The one-pass counting is bound by this staging:
//     a build that only stages the tiles takes most of the kernel's time,
//     and neither dropping the adds nor halving the tiles in flight moves
//     it (PERF.md);
//   - groups whose counters fit in a block's shared memory (32K counters:
//     hist's 10,001 bins, gcp's 28,028, comp's 1001-bin spectra) are
//     counted in that one pass, by plain shared-memory atomics (warp
//     aggregation by __match_any_sync measured slower on the H100, even
//     with 70% of the adds on one bin), and each block adds its non-zero
//     counters to the output at the end;
//   - a larger group (comp's 1,002,001 bins) is partitioned.  The first
//     pass also counts each range of 2^rb bins (2^14 for one request, 2^13
//     for two or three: a range's counters fill half an SM's shared
//     memory) in shared memory and adds the counts to the ranges' totals.
//     A one-block plan kernel scans the totals into each range's slice of
//     a word buffer and cuts ranges that hold more than their share of
//     the words into pieces.  A second pass re-reads the keys, packs each
//     element's word (bin within its range | the group's request bits <<
//     29), ranks it in its range by the shared atomic's return value,
//     sorts the tile's words by range in shared memory and writes each
//     range's run to its slice (one atomic per range and tile claims it).
//     A count kernel gives each range (or piece) to one block, two blocks
//     an SM, which counts its words in shared memory and writes every bin
//     of the range with plain stores; pieces of a cut range add their
//     non-zero bins into a range the second pass zeroed.  No add goes to
//     device memory per element: the old design's queue of u64 atomics on
//     a few dozen hot L2 addresses is gone, and the output is not
//     zero-filled first;
//   - per-block u32 counters are exact: a block counts fewer than 2^32
//     elements.
// A group is counted in one pass or partitioned whole; keys and masks are
// read once (one pass) or twice (a partitioned group).

#include <algorithm>

#include "common.cuh"

#ifndef KAT_BN_MAX_STAGES
#define KAT_BN_MAX_STAGES 6  // tiles a block stages (one counted, the rest
#endif                       // in flight); a benchmark builds fewer
// Timing probes a benchmark builds (the counts are then wrong): 1 adds to
// the first pass's counters without atomics, 2 does not add at all, 3 only
// stages the tiles (no element is read).
#ifndef KAT_BN_PROBE
#define KAT_BN_PROBE 0
#endif

namespace {

constexpr int BN_THREADS = 512;
constexpr int BN_ITEMS = 8;
constexpr int BN_TILE = BN_THREADS * BN_ITEMS;  // elements a tile
constexpr int BN_MAX_REQ = 3;
constexpr int BN_MAX_MASKS = 3;
constexpr int BN_KEY_BYTES = BN_TILE * 4 + 16;  // a tile's keys, staged
constexpr int BN_MASK_BYTES = BN_TILE + 16;     // a tile's mask plane
constexpr int BN_SMALL = 32 * 1024;      // one-pass counters a block holds
constexpr int BN_MAX_RANGES = 4096;      // ranges of all large groups
constexpr int BN_COUNT_BUDGET = 24 * 1024;  // a range's counters (96 KB)
constexpr int BN_COUNT_THREADS = 512;
constexpr int BN_QBIT = 29;              // a word's request bits start here
constexpr int BN_SMEM_MAX = 225 * 1024;  // dynamic shared memory a block
constexpr int BN_TWO_PER_SM = 113 * 1024;  // a block's, two blocks an SM

static_assert(BN_KEY_BYTES % 16 == 0 && BN_MASK_BYTES % 16 == 0,
              "stages stay 16-byte aligned");

// Requests with the same (div, mod).
struct Group {
  uint32_t dmul, mmul;  // magic multipliers (0: a divisor of one)
  int dsh, msh;
  int32_t mod;
  int nq;                       // requests in the group
  int mask[BN_MAX_REQ];         // request q's mask plane
  int64_t out_off[BN_MAX_REQ];  // where request q's bins start in out
  int win_off;                  // one-pass: request 0's first counter
  int rb, wb;                   // partitioned: range bits, count window bits
  int roff, nr;                 // partitioned: first range, ranges
};

// Groups [0, n_small) are counted in one pass, the rest partitioned.
struct Plan {
  int n_masks, n_groups, n_small, win_total, R, max_nr, count_smem;
  int stage_bytes;  // a staged tile: its keys and n_masks planes
  int stages;       // tiles a block of this launch stages
  Group g[BN_MAX_REQ];
};

// What the partitioned groups keep in device memory between launches.
struct Scratch {
  uint32_t* tot;                  // [R] words of each range
  unsigned long long* start;      // [R + 1] each range's slice of words
  unsigned long long* cursor;     // [R] the next free word of each slice
  uint32_t* item_start;           // [R + 1] each range's first piece
  uint32_t* psize;                // [R] words a piece of the range
  uint32_t* words;
};

struct Src {
  const int32_t* keys;
  const uint8_t* masks;
  int n_masks;
  int64_t n;
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ uint32_t div_by(uint32_t x, uint32_t mul,
                                           int sh) {
  return mul ? __umulhi(x, mul) >> sh : x;
}

__device__ __forceinline__ uint32_t bin_of(uint32_t key, const Group& g) {
  const uint32_t q = div_by(key, g.dmul, g.dsh);
  return q - div_by(q, g.mmul, g.msh) * (uint32_t)g.mod;
}

// The requests of g whose mask is set among the element's planes `bits`.
__device__ __forceinline__ uint32_t request_bits(uint32_t bits,
                                                 const Group& g) {
  uint32_t qb = 0;
#pragma unroll
  for (int q = 0; q < BN_MAX_REQ; q++)
    if (q < g.nq && ((bits >> g.mask[q]) & 1u)) qb |= 1u << q;
  return qb;
}

__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies the aligned 16-byte chunks that cover [src, src + len) to dst:
// byte src[j] lands at dst[(src & 15) + j].  A chunk never leaves its
// aligned 16 bytes, so it never touches a page the range does not.
__device__ __forceinline__ void stage_range(uint8_t* dst, const uint8_t* src,
                                            int len) {
  const uintptr_t a0 = (uintptr_t)src & ~(uintptr_t)15;
  const int chunks = (int)(((uintptr_t)src + len + 15 - a0) >> 4);
  for (int c = threadIdx.x; c < chunks; c += BN_THREADS)
    cp16(dst + 16 * c, (const void*)(a0 + 16 * (uintptr_t)c));
}

__device__ __forceinline__ void stage_tile(uint8_t* st, const Src& s,
                                           int64_t t0) {
  const int len = (int)min64(BN_TILE, s.n - t0);
  stage_range(st, reinterpret_cast<const uint8_t*>(s.keys + t0), 4 * len);
  for (int m = 0; m < s.n_masks; m++)
    stage_range(st + BN_KEY_BYTES + m * BN_MASK_BYTES,
                s.masks + m * s.n + t0, len);
}

// Where a staged tile's elements lie in its stage: element j's key at
// key[4 * j], its mask m byte at mask[m][j] (len elements are real).
struct TileView {
  const uint8_t* key;
  const uint8_t* mask[BN_MAX_MASKS];
  int len;
};

__device__ __forceinline__ TileView view_of(const uint8_t* st, const Src& s,
                                            int64_t t0) {
  TileView v;
  v.key = st + ((uintptr_t)(s.keys + t0) & 15);
#pragma unroll
  for (int m = 0; m < BN_MAX_MASKS; m++)
    v.mask[m] = st + BN_KEY_BYTES + m * BN_MASK_BYTES +
                ((uintptr_t)(s.masks + m * s.n + t0) & 15);
  v.len = (int)min64(BN_TILE, s.n - t0);
  return v;
}

// Element j's key, and in *bits the planes whose mask is set (none for a
// slot past the tile's end or a negative key).
__device__ __forceinline__ uint32_t element(const TileView& v, int n_masks,
                                            int j, uint32_t* bits) {
  *bits = 0;
  if (j >= v.len) return 0;
  const int32_t key = *reinterpret_cast<const int32_t*>(v.key + 4 * j);
  if (key < 0) return 0;
  uint32_t b = 0;
#pragma unroll
  for (int m = 0; m < BN_MAX_MASKS; m++)
    if (m < n_masks && v.mask[m][j]) b |= 1u << m;
  *bits = b;
  return (uint32_t)key;
}

// Waits until at most n of the thread's copy groups are in flight.
__device__ __forceinline__ void cp_wait_dyn(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    case 3: cp_wait<3>(); break;
    case 4: cp_wait<4>(); break;
    default: cp_wait<5>(); break;
  }
}

// Exclusive scan of cnt[0, nr) in place, by the block; for every range
// with words, gbase[r] gets where its slot 0 in the tile lands in the word
// buffer (its slice claimed from cursor).  Returns the tile's words.
__device__ __forceinline__ uint32_t scan_claim(uint32_t* cnt, int nr,
                                               unsigned long long* gbase,
                                               unsigned long long* cursor) {
  const int per = (nr + BN_THREADS - 1) / BN_THREADS;
  const int r0 = threadIdx.x * per;
  uint32_t sum = 0;
  for (int e = 0; e < per && r0 + e < nr; e++) sum += cnt[r0 + e];
  uint32_t total;
  uint32_t off = kat::block_exclusive_scan(sum, &total);
  for (int e = 0; e < per && r0 + e < nr; e++) {
    const int r = r0 + e;
    const uint32_t c = cnt[r];
    if (c) gbase[r] = atomicAdd(cursor + r, (unsigned long long)c) - off;
    cnt[r] = off;
    off += c;
  }
  return total;
}

// The partitioned group that range r belongs to.
__device__ __forceinline__ Group group_of(const Plan& p, int r) {
  Group g = p.g[BN_MAX_REQ - 1];
#pragma unroll
  for (int gi = BN_MAX_REQ - 2; gi >= 0; gi--)
    if (gi >= p.n_small && gi < p.n_groups &&
        r < p.g[gi].roff + p.g[gi].nr)
      g = p.g[gi];
  return g;
}

// The first pass (SCATTER false): counts the one-pass groups and each
// partitioned range's elements; the second (SCATTER true): writes the
// partitioned groups' words into their ranges' slices.  Persistent blocks,
// tiles blockIdx.x, + gridDim.x, ...; the next p.stages - 1 tiles are
// copied in while one is counted.
template <bool SCATTER>
__global__ void __launch_bounds__(BN_THREADS, 2)
binned_pass_kernel(Src src, Plan p, Scratch sc,
                   unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* s_cnt =
      reinterpret_cast<uint32_t*>(smem + p.stages * p.stage_bytes);
  const int tid = threadIdx.x;

  if constexpr (!SCATTER) {
    for (int j = tid; j < p.win_total + p.R; j += BN_THREADS) s_cnt[j] = 0;
  } else {
    // a range cut into pieces is added into by its pieces: zero it first
    for (int r = blockIdx.x; r < p.R; r += gridDim.x) {
      if (sc.item_start[r + 1] - sc.item_start[r] < 2) continue;
      const Group g = group_of(p, r);
      const int64_t lbase = (int64_t)(r - g.roff) << g.rb;
      const int64_t span = min64(int64_t(1) << g.rb, g.mod - lbase);
      for (int q = 0; q < g.nq; q++)
        for (int64_t j = tid; j < span; j += BN_THREADS)
          out[g.out_off[q] + lbase + j] = 0;
    }
  }
  // SCATTER's tile buffers after the range counts
  unsigned long long* s_gbase =
      reinterpret_cast<unsigned long long*>(s_cnt + ((p.max_nr + 1) & ~1));
  uint32_t* s_words = reinterpret_cast<uint32_t*>(s_gbase + p.max_nr);
  uint16_t* s_rng = reinterpret_cast<uint16_t*>(s_words + BN_TILE);
  uint32_t* s_rhist = s_cnt + p.win_total;

  const int64_t n_tiles = (src.n + BN_TILE - 1) / BN_TILE;
  uint32_t probe = 0;  // KAT_BN_PROBE 2's sink
  int64_t t = blockIdx.x;
  for (int a = 0; a < p.stages - 1; a++) {  // the first tiles in flight
    const int64_t ta = t + (int64_t)a * gridDim.x;
    if (ta < n_tiles) stage_tile(smem + a * p.stage_bytes, src,
                                 ta * BN_TILE);
    cp_commit();
  }
  for (int it = 0; t < n_tiles; it++, t += gridDim.x) {
    const int64_t ta = t + (int64_t)(p.stages - 1) * gridDim.x;
    if (ta < n_tiles)
      stage_tile(smem + ((it + p.stages - 1) % p.stages) * p.stage_bytes,
                 src, ta * BN_TILE);
    cp_commit();
    cp_wait_dyn(p.stages - 1);
    __syncthreads();
    const TileView tv = view_of(smem + (it % p.stages) * p.stage_bytes, src,
                                t * BN_TILE);
    if constexpr (!SCATTER) {
#pragma unroll
      for (int k = 0; k < (KAT_BN_PROBE == 3 ? 0 : BN_ITEMS); k++) {
        uint32_t bits;
        const uint32_t key =
            element(tv, src.n_masks, tid + k * BN_THREADS, &bits);
#pragma unroll
        for (int gi = 0; gi < BN_MAX_REQ; gi++) {
          if (gi >= p.n_groups) break;
          const Group& g = p.g[gi];
          const uint32_t qb = request_bits(bits, g);
          if (!qb) continue;
          const uint32_t b = bin_of(key, g);
#if KAT_BN_PROBE == 0
          if (gi < p.n_small) {
#pragma unroll
            for (int q = 0; q < BN_MAX_REQ; q++)
              if ((qb >> q) & 1u)
                atomicAdd(&s_cnt[g.win_off + q * g.mod + b], 1u);
          } else {
            atomicAdd(&s_rhist[g.roff + (b >> g.rb)], 1u);
          }
#elif KAT_BN_PROBE == 1
          *(gi < p.n_small ? &s_cnt[g.win_off + b]
                           : &s_rhist[g.roff + (b >> g.rb)]) += 1u;
#else
          probe += b;
#endif
        }
      }
    } else {
#pragma unroll
      for (int gi = 0; gi < BN_MAX_REQ; gi++) {
        if (gi >= p.n_groups) break;
        if (gi < p.n_small) continue;
        const Group& g = p.g[gi];
        for (int r = tid; r < g.nr; r += BN_THREADS) s_cnt[r] = 0;
        __syncthreads();
        // each element's word, its range and its rank there (any order)
        uint32_t wd[BN_ITEMS], rk[BN_ITEMS];
        int rg[BN_ITEMS];
#pragma unroll
        for (int k = 0; k < BN_ITEMS; k++) {
          uint32_t bits;
          const uint32_t key =
              element(tv, src.n_masks, tid + k * BN_THREADS, &bits);
          const uint32_t qb = request_bits(bits, g);
          const uint32_t b = bin_of(key, g);
          rg[k] = qb ? (int)(b >> g.rb) : -1;
          wd[k] = (b & ((1u << g.rb) - 1u)) | (qb << BN_QBIT);
          rk[k] = qb ? atomicAdd(&s_cnt[rg[k]], 1u) : 0u;
        }
        __syncthreads();
        const uint32_t total =
            scan_claim(s_cnt, g.nr, s_gbase, sc.cursor + g.roff);
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BN_ITEMS; k++) {
          if (rg[k] < 0) continue;
          const uint32_t pos = s_cnt[rg[k]] + rk[k];
          s_words[pos] = wd[k];
          s_rng[pos] = (uint16_t)rg[k];
        }
        __syncthreads();
        for (uint32_t i = tid; i < total; i += BN_THREADS)
          sc.words[s_gbase[s_rng[i]] + i] = s_words[i];
        __syncthreads();
      }
    }
    __syncthreads();  // every thread is done with this tile's stage
  }
  cp_wait<0>();
  if constexpr (!SCATTER) {
    if (probe == 0xFFFFFFFFu) s_cnt[0] = probe;
    __syncthreads();
#pragma unroll
    for (int gi = 0; gi < BN_MAX_REQ; gi++) {
      if (gi >= p.n_small) break;
      const Group& g = p.g[gi];
      for (int q = 0; q < g.nq; q++)
        for (int j = tid; j < g.mod; j += BN_THREADS) {
          const uint32_t c = s_cnt[g.win_off + q * g.mod + j];
          if (c) atomicAdd(out + g.out_off[q] + j, (unsigned long long)c);
        }
    }
    for (int r = tid; r < p.R; r += BN_THREADS)
      if (s_rhist[r]) atomicAdd(sc.tot + r, s_rhist[r]);
  }
}

// One block: each range's slice of the word buffer (an exclusive scan of
// the totals) and its pieces: a range holding more words than a block's
// share of them (and more than twice its counters) is cut into pieces of
// about that share, so that no block of the count kernel waits on one hot
// range alone.
__global__ void __launch_bounds__(1024)
binned_plan_kernel(Plan p, Scratch sc, int blocks) {
  const int R = p.R;
  const int per = (R + 1023) / 1024;  // at most BN_MAX_RANGES / 1024
  const int r0 = threadIdx.x * per;
  unsigned long long sum = 0;
  for (int e = 0; e < per && r0 + e < R; e++) sum += sc.tot[r0 + e];
  unsigned long long total;
  unsigned long long off = kat::block_exclusive_scan(sum, &total);
  uint32_t psum = 0;
  for (int e = 0; e < per && r0 + e < R; e++) {
    const int r = r0 + e;
    const uint32_t w = sc.tot[r];
    sc.start[r] = sc.cursor[r] = off;
    off += w;
    const Group g = group_of(p, r);
    const int64_t share = max64((int64_t)((total + blocks - 1) / blocks),
                                (int64_t)(2 * g.nq) << g.rb);
    const uint32_t pieces = (uint32_t)max64(1, w / share);
    sc.psize[r] = (uint32_t)(((unsigned long long)w + pieces - 1) / pieces);
    sc.item_start[r] = pieces;  // counts for now
    psum += pieces;
  }
  if (threadIdx.x == 0) sc.start[R] = total;
  uint32_t items;
  uint32_t poff = kat::block_exclusive_scan(psum, &items);
  for (int e = 0; e < per && r0 + e < R; e++) {
    const uint32_t c = sc.item_start[r0 + e];
    sc.item_start[r0 + e] = poff;
    poff += c;
  }
  if (threadIdx.x == 0) sc.item_start[R] = items;
}

// Each block takes pieces (a range, or a piece of a cut range) in turn,
// counts the piece's words in shared memory, one window of 2^wb bins at a
// time (one window unless a range was widened past 2^wb bins to keep the
// ranges at most BN_MAX_RANGES), and writes the window's bins: every bin
// with a plain store for a whole range, the non-zero ones by an add for a
// piece.
__global__ void __launch_bounds__(BN_COUNT_THREADS, 2)
binned_count_kernel(Plan p, Scratch sc, unsigned long long* __restrict__ out) {
  extern __shared__ uint32_t s_cnt[];
  __shared__ int s_r;
  const int tid = threadIdx.x;
  const uint32_t items = sc.item_start[p.R];
  for (uint32_t it = blockIdx.x; it < items; it += gridDim.x) {
    if (tid == 0) {  // the last range whose first piece is at most it
      int lo = 0, hi = p.R - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (sc.item_start[mid] <= it) lo = mid;
        else hi = mid - 1;
      }
      s_r = lo;
    }
    __syncthreads();
    const int r = s_r;
    const Group g = group_of(p, r);
    const bool cut = sc.item_start[r + 1] - sc.item_start[r] > 1;
    const unsigned long long w0 =
        sc.start[r] + (unsigned long long)(it - sc.item_start[r]) *
                          sc.psize[r];
    const unsigned long long w1 =
        (unsigned long long)min64((int64_t)sc.start[r + 1],
                                  (int64_t)(w0 + sc.psize[r]));
    const int64_t lbase = (int64_t)(r - g.roff) << g.rb;
    const uint32_t lmask = (1u << g.rb) - 1u, wmask = (1u << g.wb) - 1u;
    const int wins = 1 << (g.rb - g.wb);
    for (int w = 0; w < wins; w++) {
      const int64_t wlo = lbase + ((int64_t)w << g.wb);
      if (wlo >= g.mod) break;
      for (int j = tid; j < (g.nq << g.wb); j += BN_COUNT_THREADS)
        s_cnt[j] = 0;
      __syncthreads();
#pragma unroll 8
      for (unsigned long long i = w0 + tid; i < w1; i += BN_COUNT_THREADS) {
        const uint32_t wd = sc.words[i];
        const uint32_t local = wd & lmask;
        if ((int)(local >> g.wb) != w) continue;
        const uint32_t c = local & wmask;
#pragma unroll
        for (int q = 0; q < BN_MAX_REQ; q++)
          if ((wd >> (BN_QBIT + q)) & 1u) atomicAdd(&s_cnt[(q << g.wb) + c],
                                                    1u);
      }
      __syncthreads();
      const int span = (int)min64(int64_t(1) << g.wb, g.mod - wlo);
      for (int q = 0; q < g.nq; q++) {
        unsigned long long* dst = out + g.out_off[q] + wlo;
        for (int j = tid; j < span; j += BN_COUNT_THREADS) {
          const uint32_t c = s_cnt[(q << g.wb) + j];
          if (!cut) dst[j] = c;
          else if (c) atomicAdd(dst + j, (unsigned long long)c);
        }
      }
      __syncthreads();
    }
    __syncthreads();  // every thread has read s_r
  }
}

// x / d == umulhi(x, *mul) >> *sh for every x < 2^31 (*mul 0: d == 1).
void magic(uint32_t d, uint32_t* mul, int* sh) {
  if (d == 1) {
    *mul = 0;
    *sh = 0;
    return;
  }
  int l = 0;
  while ((uint64_t(1) << l) < d) l++;
  *mul = (uint32_t)(((uint64_t(1) << (31 + l)) + d - 1) / d);
  *sh = l - 1;
}

// The plan of n_req requests: groups of equal (div, mod), the smallest
// counted in one pass while their counters fit, the rest partitioned into
// ranges.  Returns false for a request the kernel does not take.
bool make_plan(const int64_t* req, int n_req, int n_masks, Plan* p) {
  if (n_req < 1 || n_req > BN_MAX_REQ || n_masks < 1 ||
      n_masks > BN_MAX_MASKS)
    return false;
  Group gs[BN_MAX_REQ] = {};
  int ng = 0;
  int64_t off = 0;
  for (int r = 0; r < n_req; r++) {
    const int64_t div = req[3 * r], mod = req[3 * r + 1], m = req[3 * r + 2];
    if (div < 1 || div > INT32_MAX || mod < 1 || mod > INT32_MAX || m < 0 ||
        m >= n_masks)
      return false;
    int gi = 0;
    while (gi < ng && !(gs[gi].mod == mod && gs[gi].dsh == (int)div)) gi++;
    if (gi == ng) {  // dsh holds the divisor until the magic is taken
      gs[ng] = Group{};
      gs[ng].mod = (int32_t)mod;
      gs[ng].dsh = (int)div;
      ng++;
    }
    Group& g = gs[gi];
    g.mask[g.nq] = (int)m;
    g.out_off[g.nq] = off;
    g.nq++;
    off += mod;
  }
  for (int gi = 0; gi < ng; gi++) {
    Group& g = gs[gi];
    magic((uint32_t)g.dsh, &g.dmul, &g.dsh);
    magic((uint32_t)g.mod, &g.mmul, &g.msh);
  }
  // the cheapest groups first: counted in one pass while they fit
  int order[BN_MAX_REQ];
  for (int gi = 0; gi < ng; gi++) order[gi] = gi;
  std::stable_sort(order, order + ng, [&](int a, int b) {
    return (int64_t)gs[a].nq * gs[a].mod < (int64_t)gs[b].nq * gs[b].mod;
  });
  *p = Plan{};
  p->n_masks = n_masks;
  p->n_groups = ng;
  p->stage_bytes = BN_KEY_BYTES + n_masks * BN_MASK_BYTES;
  for (int j = 0; j < ng; j++) {
    const Group& g = gs[order[j]];
    const int64_t cost = (int64_t)g.nq * g.mod;
    if (p->n_small == j && p->win_total + cost <= BN_SMALL) {
      p->g[j] = g;
      p->g[j].win_off = p->win_total;
      p->g[j].roff = INT32_MAX;
      p->win_total += (int)cost;
      p->n_small++;
    } else {
      p->g[j] = g;
      p->g[j].wb = g.nq == 1 ? 14 : 13;  // at most BN_COUNT_BUDGET
      p->g[j].rb = p->g[j].wb;
    }
  }
  // widen the largest group's ranges until at most BN_MAX_RANGES
  for (;;) {
    int R = 0, widest = -1;
    for (int j = p->n_small; j < ng; j++) {
      Group& g = p->g[j];
      g.nr = (int)((g.mod + (int64_t(1) << g.rb) - 1) >> g.rb);
      if (widest < 0 || g.nr > p->g[widest].nr) widest = j;
      R += g.nr;
    }
    if (R <= BN_MAX_RANGES) break;
    p->g[widest].rb++;
  }
  for (int j = p->n_small; j < ng; j++) {
    Group& g = p->g[j];
    g.roff = p->R;
    p->R += g.nr;
    p->max_nr = std::max(p->max_nr, g.nr);
    p->count_smem = std::max(p->count_smem, (g.nq << g.wb) * 4);
  }
  return true;
}

size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

// Bytes of scratch the partitioned groups need (0: none), in the order
// Scratch lists them.
size_t scratch_bytes(const Plan& p, int64_t n, size_t* at) {
  if (p.R == 0) return 0;
  const size_t R = p.R;
  size_t b = 0;
  at[0] = b; b = align16(b + 4 * R);
  at[1] = b; b = align16(b + 8 * (R + 1));
  at[2] = b; b = align16(b + 8 * R);
  at[3] = b; b = align16(b + 4 * (R + 1));
  at[4] = b; b = align16(b + 4 * R);
  at[5] = b;
  return b + 4 * (size_t)n * (size_t)(p.n_groups - p.n_small);
}

// Shared memory a pass kernel takes besides its stages.
size_t pass_extra(const Plan& p, bool scatter) {
  if (!scatter) return 4 * (size_t)(p.win_total + p.R);
  const size_t nr = p.max_nr;
  return 4 * ((nr + 1) & ~size_t(1)) + 8 * nr + 4 * BN_TILE + 2 * BN_TILE;
}

// The stages of a pass kernel (p->stages) and its blocks an SM: two
// blocks of at least three stages where they fit, else one with as many
// as fit (at least two).
int pick_stages(Plan* p, bool scatter) {
  const size_t extra = pass_extra(*p, scatter);
  const int two = (int)std::min<int64_t>(
      KAT_BN_MAX_STAGES,
      ((int64_t)BN_TWO_PER_SM - (int64_t)extra) / p->stage_bytes);
  if (two >= std::min(3, KAT_BN_MAX_STAGES)) {
    p->stages = two;
    return 2;
  }
  p->stages = (int)std::max<int64_t>(2, std::min<int64_t>(
      KAT_BN_MAX_STAGES,
      ((int64_t)BN_SMEM_MAX - (int64_t)extra) / p->stage_bytes));
  return extra + (size_t)p->stages * p->stage_bytes <= BN_TWO_PER_SM ? 2 : 1;
}

}  // namespace

// Counters a block of the one-pass groups holds.
extern "C" int kat_binned_sums_window() { return BN_SMALL; }

// int64 scratch elements kat_binned_sums needs for these requests over n
// keys (0: none; -1: a request it does not take).
extern "C" int64_t kat_binned_sums_scratch(int64_t n, const int64_t* req,
                                           int n_req, int n_masks) {
  Plan p;
  if (!make_plan(req, n_req, n_masks, &p)) return -1;
  size_t at[6];
  return (int64_t)((scratch_bytes(p, n, at) + 7) / 8);
}

// n_req (1-3) requests over the same n keys, each three host int64 values
// (div >= 1, mod >= 1, both below 2^31, mask index < n_masks) in `req`;
// masks are n_masks (1-3) byte planes of n elements, back to back
// (non-zero = count), at any byte offset.  out holds the requests' bins
// back to back (sum of mod int64 values); it need not be zero.  scratch:
// kat_binned_sums_scratch's int64 elements.  Keys must be >= 0; a
// negative key adds nothing.
extern "C" int kat_binned_sums(const int32_t* keys, const uint8_t* masks,
                               int n_masks, int64_t n, const int64_t* req,
                               int n_req, int64_t* out, int64_t* scratch,
                               void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  Plan p;
  if (n < 0 || n >= (int64_t(1) << 32) ||
      !make_plan(req, n_req, n_masks, &p))
    return (int)cudaErrorInvalidValue;
  static int sms1[kat::MAX_DEVICES] = {}, sms2[kat::MAX_DEVICES] = {},
             sms3[kat::MAX_DEVICES] = {};
  int sms;
  cudaError_t err = kat::prepare(binned_pass_kernel<false>, BN_SMEM_MAX,
                                 sms1, &sms);
  if (err == cudaSuccess)
    err = kat::prepare(binned_pass_kernel<true>, BN_SMEM_MAX, sms2, &sms);
  if (err == cudaSuccess)
    err = kat::prepare(binned_count_kernel, 4 * BN_COUNT_BUDGET, sms3, &sms);
  if (err != cudaSuccess) return (int)err;
  // once per device, all of an SM's unified memory as shared memory, so
  // that two blocks of 113 KB fit side by side whatever carveout CUDA
  // would pick
  static int carved[kat::MAX_DEVICES] = {};
  int device;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess && !carved[device]) {
    for (const void* k : {(const void*)binned_pass_kernel<false>,
                          (const void*)binned_pass_kernel<true>,
                          (const void*)binned_count_kernel})
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            k, cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared);
    carved[device] = err == cudaSuccess;
  }
  if (err != cudaSuccess) return (int)err;
  unsigned long long* o = reinterpret_cast<unsigned long long*>(out);
  if (n == 0) {
    int64_t total = 0;
    for (int r = 0; r < n_req; r++) total += req[3 * r + 1];
    return (int)cudaMemsetAsync(out, 0, 8 * total, stream);
  }
  for (int gi = 0; gi < p.n_small; gi++)
    for (int q = 0; q < p.g[gi].nq; q++) {
      err = cudaMemsetAsync(out + p.g[gi].out_off[q], 0, 8 * p.g[gi].mod,
                            stream);
      if (err != cudaSuccess) return (int)err;
    }
  Scratch sc = {};
  if (p.R) {
    size_t at[6];
    scratch_bytes(p, n, at);
    uint8_t* base = reinterpret_cast<uint8_t*>(scratch);
    sc.tot = reinterpret_cast<uint32_t*>(base + at[0]);
    sc.start = reinterpret_cast<unsigned long long*>(base + at[1]);
    sc.cursor = reinterpret_cast<unsigned long long*>(base + at[2]);
    sc.item_start = reinterpret_cast<uint32_t*>(base + at[3]);
    sc.psize = reinterpret_cast<uint32_t*>(base + at[4]);
    sc.words = reinterpret_cast<uint32_t*>(base + at[5]);
    err = cudaMemsetAsync(sc.tot, 0, 4 * (size_t)p.R, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const Src src = {keys, masks, n_masks, n};
  const int64_t n_tiles = (n + BN_TILE - 1) / BN_TILE;
  const int per1 = pick_stages(&p, false);
  binned_pass_kernel<false><<<(unsigned)std::min<int64_t>(
                                  (int64_t)sms * per1, n_tiles),
                              BN_THREADS,
                              pass_extra(p, false) +
                                  (size_t)p.stages * p.stage_bytes,
                              stream>>>(src, p, sc, o);
  KAT_CHECK_LAUNCH();
  if (p.R == 0) return 0;
  binned_plan_kernel<<<1, 1024, 0, stream>>>(p, sc, 2 * sms);
  KAT_CHECK_LAUNCH();
  const int per2 = pick_stages(&p, true);
  binned_pass_kernel<true><<<(unsigned)std::min<int64_t>(
                                 (int64_t)sms * per2,
                                 std::max<int64_t>(n_tiles, p.R)),
                             BN_THREADS,
                             pass_extra(p, true) +
                                 (size_t)p.stages * p.stage_bytes,
                             stream>>>(src, p, sc, o);
  KAT_CHECK_LAUNCH();
  binned_count_kernel<<<(unsigned)(2 * sms), BN_COUNT_THREADS, p.count_smem,
                        stream>>>(p, sc, o);
  KAT_CHECK_LAUNCH();
  return 0;
}

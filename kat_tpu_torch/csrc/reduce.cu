// K3: reduce-by-key of a sorted (key, weight) stream, compacted to the front.
//
// Replaces kat_tpu/ops/reduce_kernel.py::_reduce_kernel (reached through
// reduce_compact_sorted), the last step of the counting flush
// (kat_tpu/core/counting.py:357).  Contract kept from the TPU kernel: emit
// each run's key with its summed weight, in stream order, at the front of
// out_size slots padded with SENTINEL / 0; never emit a sentinel run, even
// an interior one; report the true number of runs in n_unique even when it
// exceeds out_size (the caller then grows the table and replays).  Writes
// at or past out_size are dropped.
//
// What bounds it on the H100: device-memory traffic, one read of the
// stream (12 bytes per element) and one write of each output slot (12
// bytes).  The TPU kernel walks its tiles in order on one core and carries
// the open run's key, partial sum and output cursor from tile to tile in
// SMEM (reduce_kernel.py:169-273).  Here blocks run in no order, so the
// carry is a segmented sum found in the same single pass by decoupled
// look-back (common.cuh, shared with K1):
//   - element i ends a run when i = n-1 or key[i] != key[i+1], and emits it
//     when its key is not SENTINEL;
//   - a span's aggregate is (runs it emits, whether any run ends in it, the
//     weight after its last run end); spans combine left to right as
//     (c1, e1, s1) then (c2, e2, s2) = (c1 + c2, e1 | e2, e2 ? s2 : s1 + s2);
//   - a block takes its tile number from an atomic counter, stages the tile
//     and the next tile's first key in shared memory with 16-byte loads,
//     scans its threads' aggregates, publishes the tile's aggregate in ONE
//     64-bit status word (2 flag bits, a 30-bit run count, the 32-bit open
//     sum; flag 1 or 2: aggregate without or with a run end, 3: inclusive
//     prefix), looks back with one warp for the sum of the tiles below (32
//     words a round trip), publishes its prefix, and writes each of its
//     runs once, key and count at the run's rank: the runs go through
//     shared memory first, so that the stores leave in rank order,
//     consecutive threads on consecutive runs (written straight from each
//     thread's registers, a warp's stores scattered over ~5 sectors each
//     and the kernel measured 17% slower);
//   - the tile holding the last element writes n_unique, and a second,
//     small launch pads [n_unique, out_size) with SENTINEL / 0.  The
//     scratch is the tile counter and the status words, zeroed by one
//     memset.
// A thread's ITEMS elements lie contiguous in shared memory with 16 bytes
// of padding after them, so its 16-byte reads meet no bank conflict.
//
// Counts are int32 and sums are taken mod 2^32, as the plain version's
// int64 sum cut to int32.  kat_tpu's uint32 counts wrap past 2^32; a count
// past 2^31 - 1 is out of scope here (a k-mer seen 2 billion times).  Run
// counts travel in 30 bits, so the wrapper refuses n >= 2^30 (K1's limit);
// a longer stream is reduced in pieces that end where the key changes,
// each piece's outputs written from its offset in the table
// (core/counting.reduce_stream), so outputs may start at any element.

#include <algorithm>

#include "common.cuh"

#ifndef KAT_RD_THREADS
#define KAT_RD_THREADS 256
#endif
#ifndef KAT_RD_ITEMS
#define KAT_RD_ITEMS 16
#endif

namespace {

constexpr int THREADS = KAT_RD_THREADS;
constexpr int ITEMS = KAT_RD_ITEMS;
constexpr int TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;
static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps");
static_assert(ITEMS % 8 == 0 && ITEMS <= 32,
              "a thread's run-end bits fit one word; padded reads need "
              "ITEMS % 8 == 0 to be free of bank conflicts");

// shared memory: thread t's keys at [t * KEY_STRIDE, + ITEMS), its weights
// at [t * W_STRIDE, + ITEMS); key TILE (the next tile's first) follows
constexpr int KEY_STRIDE = ITEMS + 2;
constexpr int W_STRIDE = ITEMS + 4;
constexpr int KEY_SLOTS = (THREADS + 1) * KEY_STRIDE;
constexpr int SMEM = KEY_SLOTS * 8 + THREADS * W_STRIDE * 4;

struct KeySlot {
  __device__ int operator()(int j) const { return j + 2 * (j / ITEMS); }
};
struct WeightSlot {
  __device__ int operator()(int j) const { return j + 4 * (j / ITEMS); }
};

// A segmented sum: runs emitted (bit 31: a run ends inside) and the weight
// after the last run end, mod 2^32.
struct Seg {
  uint32_t runs;
  uint32_t sum;
};
constexpr uint32_t CLOSED = 1u << 31;
constexpr uint32_t RUNS_MASK = (1u << 30) - 1;

__device__ __forceinline__ Seg seg_combine(Seg a, Seg b) {  // a, then b
  return {((a.runs & ~CLOSED) + (b.runs & ~CLOSED)) |
              ((a.runs | b.runs) & CLOSED),
          (b.runs & CLOSED) ? b.sum : a.sum + b.sum};
}

// status word: flag << 62 | runs << 32 | sum
constexpr uint64_t AGG_OPEN = 1, AGG_CLOSED = 2, PREFIX = 3;

__device__ __forceinline__ uint64_t pack(uint64_t flag, Seg v) {
  return flag << 62 | (uint64_t)(v.runs & RUNS_MASK) << 32 | v.sum;
}

struct SegStatus {
  using Word = uint64_t;
  using Value = Seg;
  static constexpr Word NOTHING = PREFIX << 62;
  __device__ static Value identity() { return {0u, 0u}; }
  __device__ static bool ready(Word w) { return (w >> 62) != 0; }
  __device__ static bool prefix(Word w) { return (w >> 62) == PREFIX; }
  __device__ static Value value(Word w) {
    return {((uint32_t)(w >> 32) & RUNS_MASK) |
                ((w >> 62) == AGG_CLOSED ? CLOSED : 0u),
            (uint32_t)w};
  }
  __device__ static Value combine(Value a, Value b) {
    return seg_combine(a, b);
  }
  __device__ static Value shfl(Value v, int src) {
    return {__shfl_sync(0xffffffffu, v.runs, src),
            __shfl_sync(0xffffffffu, v.sum, src)};
  }
};

__device__ __forceinline__ Seg shfl_up(Seg v, int d) {
  return {__shfl_up_sync(0xffffffffu, v.runs, d),
          __shfl_up_sync(0xffffffffu, v.sum, d)};
}

__device__ __forceinline__ Seg warp_inclusive(Seg v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Seg u = shfl_up(v, d);
    if (lane >= d) v = seg_combine(u, v);
  }
  return v;
}

// What a block's warps share about its tile.
struct TileShared {
  Seg warp_pre[WARPS];  // each warp's aggregate, then its exclusive prefix
                        // with the tiles below
  Seg before, total;    // the tiles below; this tile
  uint32_t tile;
};

__global__ void __launch_bounds__(THREADS)
reduce_tiles(const int64_t* __restrict__ keys, const int32_t* __restrict__ w,
             int64_t n, int64_t tiles, int64_t* __restrict__ out_keys,
             int32_t* __restrict__ out_counts, int64_t out_size,
             uint32_t* next_tile, uint64_t* status, int64_t* n_unique) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* sk = reinterpret_cast<int64_t*>(smem);
  int32_t* sw = reinterpret_cast<int32_t*>(sk + KEY_SLOTS);
  __shared__ TileShared sh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  kat::take_tile(next_tile, &sh.tile);
  __syncthreads();
  const int64_t tile = sh.tile;
  const int64_t base = tile * TILE;
  const int valid = (int)min((int64_t)TILE, n - base);

  // 1. stage the tile's weights and keys, and the next tile's first key
  {
    kat::Chunks<int64_t, THREADS, ITEMS / 2 + 1> ck;
    kat::Chunks<int32_t, THREADS, ITEMS / 4 + 1> cw;
    const int klen = (int)min((int64_t)TILE + 1, n - base);
    ck.load(keys + base, klen);
    cw.load(w + base, valid);
    ck.store(sk, klen, KeySlot());
    cw.store(sw, valid, WeightSlot());
  }
  __syncthreads();

  // 2. this thread's run ends and aggregate
  const int j0 = tid * ITEMS;
  const int64_t* mk = sk + tid * KEY_STRIDE;  // key j0 + e at mk[e]
  const int32_t* mw = sw + tid * W_STRIDE;
  int64_t k[ITEMS + 1];
#pragma unroll
  for (int v = 0; v < ITEMS / 2; v++) {
    const longlong2 p = reinterpret_cast<const longlong2*>(mk)[v];
    k[2 * v] = p.x;
    k[2 * v + 1] = p.y;
  }
  k[ITEMS] = mk[KEY_STRIDE];  // key j0 + ITEMS: the next thread's first
  uint32_t ends = 0, emits = 0;
  Seg mine = {0u, 0u};
#pragma unroll
  for (int v = 0; v < ITEMS / 4; v++) {
    const int4 q = reinterpret_cast<const int4*>(mw)[v];
    const int32_t wq[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; i++) {
      const int e = 4 * v + i;
      if (j0 + e < valid) {
        mine.sum += (uint32_t)wq[i];
        if (base + j0 + e == n - 1 || k[e] != k[e + 1]) {
          ends |= 1u << e;
          mine.runs |= CLOSED;
          mine.sum = 0;
          if (k[e] != KAT_SENTINEL) {
            emits |= 1u << e;
            mine.runs++;
          }
        }
      }
    }
  }

  // 3. the warps' scans; then warp 0 scans the warps' aggregates,
  //    publishes the tile's, looks back (a warp reading 32 words at a
  //    time), publishes the tile's prefix and leaves each warp its own
  const Seg inc = warp_inclusive(mine);
  if (lane == 31) sh.warp_pre[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Seg t = lane < WARPS ? sh.warp_pre[lane] : SegStatus::identity();
    t = warp_inclusive(t);
    const Seg total = SegStatus::shfl(t, WARPS - 1);
    Seg before = SegStatus::identity();
    if (tile > 0) {
      if (lane == 0)
        kat::st_relaxed(status + tile,
                        pack(total.runs & CLOSED ? AGG_CLOSED : AGG_OPEN,
                             total));
      before = kat::look_back<SegStatus, 1, 32>(status + tile, tile, 1);
    }
    if (lane == 0) {
      kat::st_relaxed(status + tile,
                      pack(PREFIX, seg_combine(before, total)));
      if (tile == tiles - 1)
        *n_unique = (int64_t)((before.runs & RUNS_MASK) +
                              (total.runs & RUNS_MASK));
      sh.before = before;
      sh.total = total;
    }
    Seg ex = shfl_up(t, 1);
    if (lane == 0) ex = SegStatus::identity();
    if (lane < WARPS) sh.warp_pre[lane] = seg_combine(before, ex);
  }
  __syncthreads();

  // 4. each run once, key and count at its rank: through shared memory
  //    (keys and weights come back into registers only now: held across
  //    the look-back they cost the third block on an SM), then out in rank
  //    order, consecutive threads on consecutive runs
  Seg ex = shfl_up(inc, 1);
  if (lane == 0) ex = SegStatus::identity();
  const Seg start = seg_combine(sh.warp_pre[warp], ex);
  const uint32_t r0 = sh.before.runs & RUNS_MASK;
  const uint32_t count = sh.total.runs & RUNS_MASK;
  uint32_t r = (start.runs & RUNS_MASK) - r0;
  uint32_t s = start.sum;
  int32_t wt[ITEMS];
#pragma unroll
  for (int v = 0; v < ITEMS / 2; v++) {
    const longlong2 p = reinterpret_cast<const longlong2*>(mk)[v];
    k[2 * v] = p.x;
    k[2 * v + 1] = p.y;
  }
#pragma unroll
  for (int v = 0; v < ITEMS / 4; v++) {
    const int4 q = reinterpret_cast<const int4*>(mw)[v];
    wt[4 * v] = q.x;
    wt[4 * v + 1] = q.y;
    wt[4 * v + 2] = q.z;
    wt[4 * v + 3] = q.w;
  }
  __syncthreads();  // every thread has read the tile and sh
#pragma unroll
  for (int e = 0; e < ITEMS; e++) {
    s += (uint32_t)wt[e];
    if (ends >> e & 1u) {
      if (emits >> e & 1u) {
        sk[r] = k[e];
        sw[r] = (int32_t)s;
        r++;
      }
      s = 0;
    }
  }
  __syncthreads();
  for (uint32_t i = tid; i < count && r0 + i < out_size; i += THREADS) {
    out_keys[r0 + i] = sk[i];
    out_counts[r0 + i] = sw[i];
  }
}

// Slots [min(n_unique, out_size), out_size) get SENTINEL / 0, four at a
// time where both outputs are 16-byte aligned (a piece's outputs may start
// anywhere: then one at a time).
__device__ __forceinline__ void pad_slots(int64_t* __restrict__ out_keys,
                                          int32_t* __restrict__ out_counts,
                                          int64_t out_size,
                                          const int64_t* __restrict__
                                              n_unique) {
  const int64_t first = min(*n_unique, out_size);
  const int64_t groups = (out_size + 3) / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const bool aligned =
      (((uintptr_t)out_keys | (uintptr_t)out_counts) & 15) == 0;
  for (int64_t g = first / 4 + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const int64_t s = 4 * g;
    if (aligned && s >= first && s + 4 <= out_size) {
      const longlong2 sent = {KAT_SENTINEL, KAT_SENTINEL};
      reinterpret_cast<longlong2*>(out_keys + s)[0] = sent;
      reinterpret_cast<longlong2*>(out_keys + s)[1] = sent;
      *reinterpret_cast<int4*>(out_counts + s) = make_int4(0, 0, 0, 0);
    } else {
      for (int e = 0; e < 4; e++) {
        if (s + e >= first && s + e < out_size) {
          out_keys[s + e] = KAT_SENTINEL;
          out_counts[s + e] = 0;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(256)
reduce_pad(int64_t* __restrict__ out_keys, int32_t* __restrict__ out_counts,
           int64_t out_size, const int64_t* __restrict__ n_unique) {
  pad_slots(out_keys, out_counts, out_size, n_unique);
}

// ---------------------------------------------------------------------------
// Wide keys: a sorted stream of W int64 words a key, [W][n] planes.
//
// Replaces the same TPU kernel with W key planes: the reduce of the wide
// flush and of wide tables built off it (kat_tpu/core/wide.py:232, :62).
// The one-word kernel's single pass, tile and look-back, with the key
// planes taken one at a time so that neither shared memory nor registers
// grow with W: each plane of the tile (and the next tile's first key) is
// staged in the same padded buffer, and each thread ORs into one bit mask
// where its keys differ from the next ones (a run ends where ANY word
// differs) and notes which are SENTINEL (word 0).  Runs leave through
// shared memory in rank order as before, as a count and the run end's
// position in the tile; each plane of their keys is then gathered from the
// tile, which the flag pass just read (L2), and stored in rank order.
// What bounds it: device memory, 8W + 4 bytes a stream element in, the same
// per output slot out.

// Blocks an SM the W-word tile pass is built for.  3 (the one-word pass's
// occupancy) holds it to 80 registers with 40 bytes spilled; 2 lets it
// take 100 and spill nothing, and measured 10% faster at the k = 41
// flush's shape (benchmarks/sweep_wide_kernels.py --blocks).
#ifndef KAT_RD_WORDS_BLOCKS
#define KAT_RD_WORDS_BLOCKS 2
#endif

template <int W>
__global__ void __launch_bounds__(THREADS, KAT_RD_WORDS_BLOCKS)
reduce_words_tiles(const int64_t* __restrict__ keys, int64_t ks,
                   const int32_t* __restrict__ w, int64_t n, int64_t tiles,
                   int64_t* __restrict__ out_keys, int64_t os,
                   int32_t* __restrict__ out_counts, int64_t out_size,
                   uint32_t* next_tile, uint64_t* status, int64_t* n_unique) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* sk = reinterpret_cast<int64_t*>(smem);
  int32_t* sw = reinterpret_cast<int32_t*>(sk + KEY_SLOTS);
  uint16_t* spos = reinterpret_cast<uint16_t*>(smem);  // over sk, at the end
  __shared__ TileShared sh;
  static_assert(TILE <= 1 << 16, "a position in the tile must fit 16 bits");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  kat::take_tile(next_tile, &sh.tile);
  __syncthreads();
  const int64_t tile = sh.tile;
  const int64_t base = tile * TILE;
  const int valid = (int)min((int64_t)TILE, n - base);
  const int klen = (int)min((int64_t)TILE + 1, n - base);
  const int j0 = tid * ITEMS;
  const int64_t* mk = sk + tid * KEY_STRIDE;  // key j0 + e at mk[e]
  const int32_t* mw = sw + tid * W_STRIDE;

  // 1. the weights; then plane by plane, where each key differs from the
  //    next, and (plane 0) which keys are SENTINEL
  {
    kat::Chunks<int32_t, THREADS, ITEMS / 4 + 1> cw;
    cw.load(w + base, valid);
    cw.store(sw, valid, WeightSlot());
  }
  uint32_t diff = 0, sent = 0;
#pragma unroll 1
  for (int q = 0; q < W; q++) {
    if (q > 0) __syncthreads();  // every thread is done with the last plane
    {
      kat::Chunks<int64_t, THREADS, ITEMS / 2 + 1> ck;
      ck.load(keys + q * ks + base, klen);
      ck.store(sk, klen, KeySlot());
    }
    __syncthreads();
    int64_t k[ITEMS + 1];
#pragma unroll
    for (int v = 0; v < ITEMS / 2; v++) {
      const longlong2 p = reinterpret_cast<const longlong2*>(mk)[v];
      k[2 * v] = p.x;
      k[2 * v + 1] = p.y;
    }
    k[ITEMS] = mk[KEY_STRIDE];  // key j0 + ITEMS: the next thread's first
#pragma unroll
    for (int e = 0; e < ITEMS; e++) {
      diff |= (uint32_t)(k[e] != k[e + 1]) << e;
      if (q == 0) sent |= (uint32_t)(k[e] == KAT_SENTINEL) << e;
    }
  }

  // 2. this thread's run ends and aggregate
  uint32_t ends = 0, emits = 0;
  Seg mine = {0u, 0u};
#pragma unroll
  for (int v = 0; v < ITEMS / 4; v++) {
    const int4 qv = reinterpret_cast<const int4*>(mw)[v];
    const int32_t wq[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
    for (int i = 0; i < 4; i++) {
      const int e = 4 * v + i;
      if (j0 + e < valid) {
        mine.sum += (uint32_t)wq[i];
        if (base + j0 + e == n - 1 || (diff >> e & 1u)) {
          ends |= 1u << e;
          mine.runs |= CLOSED;
          mine.sum = 0;
          if (!(sent >> e & 1u)) {
            emits |= 1u << e;
            mine.runs++;
          }
        }
      }
    }
  }

  // 3. scans, publish, look back: as reduce_tiles
  const Seg inc = warp_inclusive(mine);
  if (lane == 31) sh.warp_pre[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Seg t = lane < WARPS ? sh.warp_pre[lane] : SegStatus::identity();
    t = warp_inclusive(t);
    const Seg total = SegStatus::shfl(t, WARPS - 1);
    Seg before = SegStatus::identity();
    if (tile > 0) {
      if (lane == 0)
        kat::st_relaxed(status + tile,
                        pack(total.runs & CLOSED ? AGG_CLOSED : AGG_OPEN,
                             total));
      before = kat::look_back<SegStatus, 1, 32>(status + tile, tile, 1);
    }
    if (lane == 0) {
      kat::st_relaxed(status + tile,
                      pack(PREFIX, seg_combine(before, total)));
      if (tile == tiles - 1)
        *n_unique = (int64_t)((before.runs & RUNS_MASK) +
                              (total.runs & RUNS_MASK));
      sh.before = before;
      sh.total = total;
    }
    Seg ex = shfl_up(t, 1);
    if (lane == 0) ex = SegStatus::identity();
    if (lane < WARPS) sh.warp_pre[lane] = seg_combine(before, ex);
  }
  __syncthreads();

  // 4. each run once, in rank order: its count and its end's position in
  //    the tile through shared memory, then each plane of the keys
  Seg ex = shfl_up(inc, 1);
  if (lane == 0) ex = SegStatus::identity();
  const Seg start = seg_combine(sh.warp_pre[warp], ex);
  const uint32_t r0 = sh.before.runs & RUNS_MASK;
  const uint32_t count = sh.total.runs & RUNS_MASK;
  uint32_t r = (start.runs & RUNS_MASK) - r0;
  uint32_t s = start.sum;
  int32_t wt[ITEMS];
#pragma unroll
  for (int v = 0; v < ITEMS / 4; v++) {
    const int4 qv = reinterpret_cast<const int4*>(mw)[v];
    wt[4 * v] = qv.x;
    wt[4 * v + 1] = qv.y;
    wt[4 * v + 2] = qv.z;
    wt[4 * v + 3] = qv.w;
  }
  __syncthreads();  // every thread has read the weights and sh
#pragma unroll
  for (int e = 0; e < ITEMS; e++) {
    s += (uint32_t)wt[e];
    if (ends >> e & 1u) {
      if (emits >> e & 1u) {
        spos[r] = (uint16_t)(j0 + e);
        sw[r] = (int32_t)s;
        r++;
      }
      s = 0;
    }
  }
  __syncthreads();
  const int64_t room = out_size - (int64_t)r0;
  const int m = (int)min((int64_t)count, max(room, (int64_t)0));
  for (int i = tid; i < m; i += THREADS) out_counts[r0 + i] = sw[i];
#pragma unroll 1
  for (int q = 0; q < W; q++) {
    const int64_t* src = keys + q * ks + base;
    int64_t* dst = out_keys + q * os + r0;
    for (int i = tid; i < m; i += THREADS) dst[i] = src[spos[i]];
  }
}

// Slots [min(n_unique, out_size), out_size) of every plane get SENTINEL,
// and of the counts 0.
__global__ void __launch_bounds__(256)
reduce_pad_words(int64_t* __restrict__ out_keys, int64_t os, int words,
                 int32_t* __restrict__ out_counts, int64_t out_size,
                 const int64_t* __restrict__ n_unique) {
  const int64_t first = min(*n_unique, out_size);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t s = first + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       s < out_size; s += stride) {
    for (int q = 0; q < words; q++) out_keys[q * os + s] = KAT_SENTINEL;
    out_counts[s] = 0;
  }
}

int64_t tiles_for(int64_t n) { return (n + TILE - 1) / TILE; }

// ---------------------------------------------------------------------------
// K2 + K3 fused: the counting flush's merge of the resident table with the
// sorted fresh keys, reduced by key straight into the new table's slots.
//
// Fuses K2 (kat_tpu/ops/merge_kernel.py:73, csrc/merge.cu) with K3
// (kat_tpu/ops/reduce_kernel.py:147, above) for core/counting's narrow
// flush on a card.  Apart, K2 writes the merged stream, (na + nb) x 12
// bytes, and K3 reads it back.  What bounds the fused pass: device-memory
// traffic, the table read once (key and count, 12 bytes an entry), the
// fresh keys read once (8 bytes each), each output slot written once (12
// bytes) and the run count: 12 na + 8 nb + 12 out_size + 8 bytes.  The
// merged stream exists only a tile at a time, in shared memory and
// registers.  One call is a memset and three launches:
//   merge_reduce_partition  K2's partition at this tile, over the real
//     keys alone: a warp a block finds where each side's SENTINEL tail
//     starts (the flush's fresh keys end in ~26% SENTINEL, one run that is
//     never emitted, so no tile merges it), then one thread per tile
//     boundary finds by a merge-path search how many table entries precede
//     output d = tile * MR_TILE;
//   merge_reduce_tiles  a block takes its tile number from the counter (so
//     that it only ever waits for tiles already running; tiles past the
//     real keys return at once), stages its slices of the table's keys
//     and counts and of the fresh keys with 16-byte loads, and reads the
//     key that follows the tile on the merge path (the smaller of the two
//     heads), which says whether the tile's last run ends inside it.  It
//     also asks L2 for the slices of the tile one round of resident blocks
//     ahead, which some block stages about when this one is done: their
//     DRAM latency passes while this tile merges, looks back and writes.
//     Each thread finds its MR_ITEMS outputs' start by a merge-path search
//     in shared memory and merges them into registers, with the key that
//     follows them, so that it knows its run ends, emits and (runs, any
//     end, open sum) aggregate at once.  Then K3's tile logic: the block
//     scan, ONE 64-bit status word a tile, the look-back (by the whole
//     block, 32 status words a warp a round trip: with one warp the
//     look-back alone held the kernel to 32 tiles a round trip), and each
//     run, key and count, written once at its rank through shared memory
//     (the staged slices are done with by then), so that the stores leave
//     in rank order; the tile numbered last writes n_unique;
//   merge_reduce_pad  [n_unique, out_size) gets SENTINEL / 0, as in K3.
// The fresh keys weigh (key != SENTINEL); ties take the table first, and
// sums wrap mod 2^32, as K2 then K3 give them.  Runs travel in 30 bits,
// so the wrapper refuses na + nb >= 2^30 (core/counting then takes K2 and
// K3, in pieces).

// 256 x 16 outputs a block, registers bounded for 3 blocks an SM: the
// fastest at chr14.hist's last flushes (2^28 slots) of the variants that
// benchmarks/sweep_flush_kernels.py --tiles --fused builds; with no bound
// (90-100 registers, 2 blocks) the kernel was ~20% slower
#ifndef KAT_MR_THREADS
#define KAT_MR_THREADS 256
#endif
#ifndef KAT_MR_ITEMS
#define KAT_MR_ITEMS 16
#endif
#ifndef KAT_MR_BLOCKS
#define KAT_MR_BLOCKS 3
#endif

constexpr int MR_THREADS = KAT_MR_THREADS;
constexpr int MR_ITEMS = KAT_MR_ITEMS;
constexpr int MR_TILE = MR_THREADS * MR_ITEMS;
constexpr int MR_WARPS = MR_THREADS / 32;
static_assert(MR_THREADS % 32 == 0 && MR_THREADS <= 1024, "whole warps");
static_assert(MR_ITEMS % 2 == 0 && MR_ITEMS <= 32,
              "whole 16-byte key chunks; a thread's run-end bits fit one "
              "word");

// shared memory: the staged key slices (the table's, then the fresh
// keys'), then the table's counts, each as many slots as its 16-byte
// chunks can fill; on the way out the tile's runs, keys and counts, in
// rank order in the same slots
constexpr int MR_KEY_SLOTS = MR_THREADS * (MR_ITEMS / 2 + 1) * 2;
constexpr int MR_W_SLOTS = MR_THREADS * (MR_ITEMS / 4 + 1) * 4;
constexpr int MR_SMEM = MR_KEY_SLOTS * 8 + MR_W_SLOTS * 4;

__host__ __device__ __forceinline__ int64_t mr_tiles(int64_t n) {
  return (n + MR_TILE - 1) / MR_TILE;
}

// What a block of the fused kernel shares about its tile.
struct MergeReduceShared {
  Seg warp[MR_WARPS];  // each warp's aggregate, then its exclusive prefix
  Seg total;           // the tile's aggregate
  Seg found_val[MR_WARPS];  // the look-back's scratch
  int found[MR_WARPS];
  int64_t next;  // the key after the tile on the merge path, if has_next
  bool has_next;
  uint32_t tile;
  int64_t ahead[2];  // the splits of the tile `ahead`, or -1
};

// The block asks L2 for tile t's slices (a[i0, i1) and its counts, b's
// part), a 128-byte line a request, and goes on.
__device__ __forceinline__ void prefetch_tile(const int64_t* a,
                                              const int32_t* aw,
                                              const int64_t* b, int64_t n,
                                              int64_t t, int64_t i0,
                                              int64_t i1) {
  const int64_t d0 = t * MR_TILE, d1 = min(d0 + MR_TILE, n);
  const char* src[3] = {reinterpret_cast<const char*>(a + i0),
                        reinterpret_cast<const char*>(aw + i0),
                        reinterpret_cast<const char*>(b + (d0 - i0))};
  const int64_t bytes[3] = {(i1 - i0) * 8, (i1 - i0) * 4,
                            ((d1 - i1) - (d0 - i0)) * 8};
#pragma unroll
  for (int q = 0; q < 3; q++) {
    // every line the range touches, from the one holding its first byte
    const uintptr_t first = (uintptr_t)src[q] & ~(uintptr_t)127;
    const int lines =
        bytes[q] > 0
            ? (int)(((uintptr_t)src[q] + bytes[q] - 1 - first) / 128 + 1)
            : 0;
    for (int i = threadIdx.x; i < lines; i += MR_THREADS)
      asm volatile("prefetch.global.L2 [%0];"
                   :: "l"(first + (uintptr_t)i * 128));
  }
}

// The index of the first SENTINEL in sorted x[0, n), n if there is none,
// found by the calling warp, 32 probes a step (six steps at n = 2^30).
__device__ __forceinline__ int64_t sentinel_start(
    const int64_t* __restrict__ x, int64_t n) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = n;  // x[lo - 1] is real, x[hi] is SENTINEL or past n
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t p = lo + (lane + 1) * step - 1;
    const unsigned sent =
        __ballot_sync(0xffffffffu, p >= hi || x[p] == KAT_SENTINEL);
    if (sent == 0) return hi;  // the last probe was x[hi - 1], real
    const int f = __ffs(sent) - 1;
    hi = min(lo + (f + 1) * step - 1, hi);
    lo += f * step;
  }
  return lo;
}

// Every block's warp 0 finds each side's real (non-SENTINEL) length; the
// merge then covers the real keys alone (the SENTINEL tails form one run,
// which is never emitted).  Thread 0 of the launch keeps the lengths for
// the tile kernel, and the run count when there are none.
__global__ void __launch_bounds__(256)
merge_reduce_partition(const int64_t* __restrict__ a, int64_t na,
                       const int64_t* __restrict__ b, int64_t nb,
                       int64_t tiles, int64_t* __restrict__ splits,
                       int64_t* __restrict__ real, int64_t* n_unique) {
  __shared__ int64_t s_real[2];
  if (threadIdx.x < 32) {
    const int64_t ra = sentinel_start(a, na);
    const int64_t rb = sentinel_start(b, nb);
    if (threadIdx.x == 0) {
      s_real[0] = ra;
      s_real[1] = rb;
    }
  }
  __syncthreads();
  const int64_t ra = s_real[0], rb = s_real[1];
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t == 0) {
    real[0] = ra;
    real[1] = rb;
    if (ra + rb == 0) *n_unique = 0;
  }
  if (t <= tiles)
    splits[t] = kat::merge_path(a, ra, b, rb, min(t * MR_TILE, ra + rb));
}

__global__ void __launch_bounds__(MR_THREADS, KAT_MR_BLOCKS)
merge_reduce_tiles(const int64_t* __restrict__ a,
                   const int32_t* __restrict__ aw,
                   const int64_t* __restrict__ b,
                   const int64_t* __restrict__ real,
                   const int64_t* __restrict__ splits,
                   int64_t* __restrict__ out_keys,
                   int32_t* __restrict__ out_counts, int64_t out_size,
                   uint32_t* next_tile, uint64_t* status, int64_t* n_unique,
                   int64_t ahead) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* sk = reinterpret_cast<int64_t*>(smem);
  int32_t* sw = reinterpret_cast<int32_t*>(sk + MR_KEY_SLOTS);
  __shared__ MergeReduceShared sh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  kat::take_tile(next_tile, &sh.tile);
  __syncthreads();
  const int64_t tile = sh.tile;
  // the real keys' lengths: the launch has a block for every tile of all
  // the keys, and those past the real keys' tiles have nothing to do
  const int64_t na = real[0], nb = real[1];
  const int64_t tiles = mr_tiles(na + nb);
  if (tile >= tiles) return;
  const int64_t d0 = tile * MR_TILE;
  const int64_t i0 = splits[tile], i1 = splits[tile + 1];
  const int len = (int)(min(d0 + MR_TILE, na + nb) - d0);
  const int la = (int)(i1 - i0);
  const int lb = len - la;
  const int64_t j0 = d0 - i0, j1 = j0 + lb;

  // 1. stage a[i0, i1) with its counts and b[j0, j1); the key after them;
  //    where the tile `ahead` lies
  int fa, fb, fw;
  {
    kat::Chunks<int64_t, MR_THREADS, MR_ITEMS / 2 + 1> ck;
    kat::Chunks<int32_t, MR_THREADS, MR_ITEMS / 4 + 1> cw;
    ck.load(a + i0, la, b + j0, lb);
    cw.load(aw + i0, la);
    if (tid == 0) {
      const int64_t t = tile + ahead;
      sh.ahead[0] = t < tiles ? __ldg(splits + t) : -1;
      sh.ahead[1] = t < tiles ? __ldg(splits + t + 1) : -1;
      bool has = false;
      int64_t next = 0;
      if (i1 < na) {
        next = a[i1];
        has = true;
      }
      if (j1 < nb) {
        next = has ? min(next, b[j1]) : b[j1];
        has = true;
      }
      sh.next = next;
      sh.has_next = has;
    }
    ck.store(sk);
    cw.store(sw);
    fa = ck.first(0);
    fb = ck.first(1);
    fw = cw.first(0);
  }
  __syncthreads();
  const int64_t* sa = sk + fa;
  const int64_t* sb = sk + fb;
  const int32_t* sc = sw + fw;

  // 2. this thread's outputs start at local diagonal dt: merge them into
  //    registers (slots past an end are staged memory, never taken), with
  //    the key that follows them
  const int dt = min(tid * MR_ITEMS, len);
  int lo = max(0, dt - lb);
  int hi = min(dt, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sa[mid] <= sb[dt - 1 - mid]) lo = mid + 1;
    else hi = mid;
  }
  int ia = lo, ib = dt - lo;
  int64_t ka = sa[ia], kb = sb[ib];
  int64_t k[MR_ITEMS + 1];
  uint32_t wt[MR_ITEMS];
#pragma unroll
  for (int e = 0; e < MR_ITEMS; e++) {
    const bool take_a = ia < la && (ib >= lb || ka <= kb);
    k[e] = take_a ? ka : kb;
    wt[e] = take_a ? (uint32_t)sc[ia] : (uint32_t)(kb != KAT_SENTINEL);
    if (take_a) ka = sa[++ia];
    else kb = sb[++ib];
  }
  k[MR_ITEMS] = ia < la && (ib >= lb || ka <= kb) ? ka : kb;

  // 3. run ends and this thread's aggregate; the tile's last output ends
  //    a run unless the key after the tile equals it
  const int valid = min(MR_ITEMS, len - dt);
  const bool holds_last = dt + MR_ITEMS >= len;
  uint32_t ends = 0, emits = 0;
  Seg mine = {0u, 0u};
#pragma unroll
  for (int e = 0; e < MR_ITEMS; e++) {
    if (e < valid) {
      mine.sum += wt[e];
      const bool end = holds_last && e == valid - 1
                           ? !sh.has_next || sh.next != k[e]
                           : k[e] != k[e + 1];
      if (end) {
        ends |= 1u << e;
        mine.runs |= CLOSED;
        mine.sum = 0;
        if (k[e] != KAT_SENTINEL) {
          emits |= 1u << e;
          mine.runs++;
        }
      }
    }
  }

  // 4. the warps' scans; warp 0 scans the warps' aggregates and publishes
  //    the tile's; the whole block looks back; thread 0 publishes the
  //    tile's prefix
  const Seg inc = warp_inclusive(mine);
  if (lane == 31) sh.warp[warp] = inc;
  __syncthreads();  // also: every thread is done with the staged slices
  if (warp == 0) {
    Seg t = lane < MR_WARPS ? sh.warp[lane] : SegStatus::identity();
    t = warp_inclusive(t);
    const Seg total = SegStatus::shfl(t, MR_WARPS - 1);
    if (lane == 0) {
      if (tile > 0)
        kat::st_relaxed(status + tile,
                        pack(total.runs & CLOSED ? AGG_CLOSED : AGG_OPEN,
                             total));
      sh.total = total;
    }
    Seg ex = shfl_up(t, 1);
    if (lane == 0) ex = SegStatus::identity();
    if (lane < MR_WARPS) sh.warp[lane] = ex;  // the warp's exclusive prefix
  }
  __syncthreads();
  if (sh.ahead[0] >= 0)
    prefetch_tile(a, aw, b, na + nb, tile + ahead, sh.ahead[0], sh.ahead[1]);
  const Seg total = sh.total;
  const Seg before =
      tile > 0 ? kat::look_back_block<SegStatus, MR_WARPS>(
                     status + tile, tile, sh.found_val, sh.found)
               : SegStatus::identity();
  if (tid == 0) {
    kat::st_relaxed(status + tile, pack(PREFIX, seg_combine(before, total)));
    if (tile == tiles - 1)
      *n_unique = (int64_t)((before.runs & RUNS_MASK) +
                            (total.runs & RUNS_MASK));
  }

  // 5. each run once, key and count at its rank: through shared memory,
  //    then out in rank order, consecutive threads on consecutive runs
  Seg ex = shfl_up(inc, 1);
  if (lane == 0) ex = SegStatus::identity();
  const Seg start = seg_combine(seg_combine(before, sh.warp[warp]), ex);
  const uint32_t r0 = before.runs & RUNS_MASK;
  const uint32_t count = total.runs & RUNS_MASK;
  uint32_t r = (start.runs & RUNS_MASK) - r0;
  uint32_t s = start.sum;
#pragma unroll
  for (int e = 0; e < MR_ITEMS; e++) {
    s += wt[e];
    if (ends >> e & 1u) {
      if (emits >> e & 1u) {
        sk[r] = k[e];
        sw[r] = (int32_t)s;
        r++;
      }
      s = 0;
    }
  }
  __syncthreads();
  for (uint32_t i = tid; i < count && r0 + i < out_size; i += MR_THREADS) {
    out_keys[r0 + i] = sk[i];
    out_counts[r0 + i] = sw[i];
  }
}

__global__ void __launch_bounds__(256)
merge_reduce_pad(int64_t* __restrict__ out_keys,
                 int32_t* __restrict__ out_counts, int64_t out_size,
                 const int64_t* __restrict__ n_unique) {
  pad_slots(out_keys, out_counts, out_size, n_unique);
}

// Blocks of the tile kernel resident on the device at once (one round),
// asked once per device.
cudaError_t mr_resident(int sms, int64_t* resident) {
  static int64_t resident_of[kat::MAX_DEVICES] = {};
  int device, per_sm;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (resident_of[device] == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, merge_reduce_tiles, MR_THREADS, MR_SMEM);
    if (err != cudaSuccess) return err;
    resident_of[device] = (int64_t)per_sm * sms;
  }
  *resident = resident_of[device];
  return cudaSuccess;
}

}  // namespace

// Elements a thread block of kat_reduce_by_key takes.
extern "C" int kat_reduce_by_key_tile() { return TILE; }

// int64 scratch words kat_reduce_by_key needs: the tile counter, then one
// status word per tile.
extern "C" int64_t kat_reduce_by_key_scratch(int64_t n) {
  return 1 + tiles_for(n);
}

// Reduce the sorted stream (keys, w)[0:n) into out_keys/out_counts
// [0:out_size); n_unique[0] gets the true number of non-sentinel runs.
// Requires n < 2^30.
extern "C" int kat_reduce_by_key(const int64_t* keys, const int32_t* w,
                                 int64_t n, int64_t* out_keys,
                                 int32_t* out_counts, int64_t out_size,
                                 int64_t* scratch, int64_t* n_unique,
                                 void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  static int sms_of[kat::MAX_DEVICES] = {};
  int sms;
  cudaError_t err = kat::prepare(reduce_tiles, SMEM, sms_of, &sms);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = tiles_for(n);
  if (tiles == 0) {
    err = cudaMemsetAsync(n_unique, 0, sizeof(int64_t), stream);
  } else {
    err = cudaMemsetAsync(scratch, 0,
                          kat_reduce_by_key_scratch(n) * sizeof(int64_t),
                          stream);
  }
  if (err != cudaSuccess) return (int)err;
  if (tiles > 0) {
    reduce_tiles<<<(unsigned)tiles, THREADS, SMEM, stream>>>(
        keys, w, n, tiles, out_keys, out_counts, out_size,
        reinterpret_cast<uint32_t*>(scratch),
        reinterpret_cast<uint64_t*>(scratch + 1), n_unique);
    KAT_CHECK_LAUNCH();
  }
  if (out_size > 0) {
    const int64_t blocks =
        std::min((out_size + 1023) / 1024, (int64_t)sms * 8);
    reduce_pad<<<(unsigned)blocks, 256, 0, stream>>>(out_keys, out_counts,
                                                     out_size, n_unique);
    KAT_CHECK_LAUNCH();
  }
  return 0;
}

// reduce_by_key over `words` (2-9) key planes keys[q * ks + i]; outputs
// key planes out_keys[q * os + i] (i < out_size) and [out_size] counts;
// scratch as kat_reduce_by_key_scratch(n).  Requires n < 2^30.
extern "C" int kat_reduce_by_key_words(const int64_t* keys, int64_t ks,
                                       int words, const int32_t* w,
                                       int64_t n, int64_t* out_keys,
                                       int64_t os, int32_t* out_counts,
                                       int64_t out_size, int64_t* scratch,
                                       int64_t* n_unique, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  using Kernel = void (*)(const int64_t*, int64_t, const int32_t*, int64_t,
                          int64_t, int64_t*, int64_t, int32_t*, int64_t,
                          uint32_t*, uint64_t*, int64_t*);
  static const Kernel kernels[] = {
      reduce_words_tiles<2>, reduce_words_tiles<3>, reduce_words_tiles<4>,
      reduce_words_tiles<5>, reduce_words_tiles<6>, reduce_words_tiles<7>,
      reduce_words_tiles<8>, reduce_words_tiles<9>};
  if (words < 2 || words > 9) return (int)cudaErrorInvalidValue;
  const Kernel kernel = kernels[words - 2];
  static int sms_of[8][kat::MAX_DEVICES] = {};
  int sms;
  cudaError_t err = kat::prepare(kernel, SMEM, sms_of[words - 2], &sms);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = tiles_for(n);
  if (tiles == 0) {
    err = cudaMemsetAsync(n_unique, 0, sizeof(int64_t), stream);
  } else {
    err = cudaMemsetAsync(scratch, 0,
                          kat_reduce_by_key_scratch(n) * sizeof(int64_t),
                          stream);
  }
  if (err != cudaSuccess) return (int)err;
  if (tiles > 0) {
    kernel<<<(unsigned)tiles, THREADS, SMEM, stream>>>(
        keys, ks, w, n, tiles, out_keys, os, out_counts, out_size,
        reinterpret_cast<uint32_t*>(scratch),
        reinterpret_cast<uint64_t*>(scratch + 1), n_unique);
    KAT_CHECK_LAUNCH();
  }
  if (out_size > 0) {
    const int64_t blocks =
        std::min((out_size + 1023) / 1024, (int64_t)sms * 8);
    reduce_pad_words<<<(unsigned)blocks, 256, 0, stream>>>(
        out_keys, os, words, out_counts, out_size, n_unique);
    KAT_CHECK_LAUNCH();
  }
  return 0;
}

// Outputs (merged elements) a thread block of kat_merge_reduce takes.
extern "C" int kat_merge_reduce_tile() { return MR_TILE; }

// int64 scratch words kat_merge_reduce needs for na + nb = n: the tile
// counter, one status word per tile, the tile splits, the real lengths.
extern "C" int64_t kat_merge_reduce_scratch(int64_t n) {
  return 2 * (mr_tiles(n) + 1) + 2;
}

// Reduce the stable merge of (a, aw)[0:na) with (b, b != SENTINEL)[0:nb)
// into out_keys/out_counts[0:out_size); n_unique[0] gets the true number
// of non-sentinel runs.  Requires na + nb < 2^30.
extern "C" int kat_merge_reduce(const int64_t* a, const int32_t* aw,
                                int64_t na, const int64_t* b, int64_t nb,
                                int64_t* out_keys, int32_t* out_counts,
                                int64_t out_size, int64_t* scratch,
                                int64_t* n_unique, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  static int sms_of[kat::MAX_DEVICES] = {};
  int sms;
  cudaError_t err = kat::prepare(merge_reduce_tiles, MR_SMEM, sms_of, &sms);
  if (err != cudaSuccess) return (int)err;
  int64_t resident;
  err = mr_resident(sms, &resident);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = mr_tiles(na + nb);
  if (tiles == 0) {
    err = cudaMemsetAsync(n_unique, 0, sizeof(int64_t), stream);
  } else {
    err = cudaMemsetAsync(scratch, 0, (1 + tiles) * sizeof(int64_t), stream);
  }
  if (err != cudaSuccess) return (int)err;
  if (tiles > 0) {
    int64_t* splits = scratch + 1 + tiles;
    int64_t* real = splits + tiles + 1;
    merge_reduce_partition<<<(unsigned)((tiles + 256) / 256), 256, 0,
                             stream>>>(a, na, b, nb, tiles, splits, real,
                                       n_unique);
    KAT_CHECK_LAUNCH();
    merge_reduce_tiles<<<(unsigned)tiles, MR_THREADS, MR_SMEM, stream>>>(
        a, aw, b, real, splits, out_keys, out_counts, out_size,
        reinterpret_cast<uint32_t*>(scratch),
        reinterpret_cast<uint64_t*>(scratch + 1), n_unique, resident);
    KAT_CHECK_LAUNCH();
  }
  if (out_size > 0) {
    const int64_t blocks =
        std::min((out_size + 1023) / 1024, (int64_t)sms * 8);
    merge_reduce_pad<<<(unsigned)blocks, 256, 0, stream>>>(
        out_keys, out_counts, out_size, n_unique);
    KAT_CHECK_LAUNCH();
  }
  return 0;
}

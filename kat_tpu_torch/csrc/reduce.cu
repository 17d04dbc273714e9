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
__global__ void __launch_bounds__(256)
reduce_pad(int64_t* __restrict__ out_keys, int32_t* __restrict__ out_counts,
           int64_t out_size, const int64_t* __restrict__ n_unique) {
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

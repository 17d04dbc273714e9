// K6: merge of the sorted runs of one key stream into one ascending stream,
// for one int64 key (kat_merge_runs) and for W int64 words, most
// significant first (kat_merge_runs_words, 2 <= W <= 9).
//
// Replaces kat_tpu/ops/sort_kernel.py::_window_kernel in runs mode (reached
// through bitonic_merge_runs): the arrival merge of the sharded flush
// (kat_tpu/parallel/sharded.py:258), where n_shards sorted runs of
// route_cap slots, each a sorted prefix of real keys and an all-SENTINEL
// tail, become one stream; and the minimizer-bucketed flush
// (kat_tpu/core/bucketed.py:76), where a hot bucket's g sorted chunk runs
// become one.  The TPU reversed the odd runs and ran the bitonic phases
// above the run length; none of that is carried over.
//
// What bounds it on the H100: device-memory traffic.  The function must
// read every input byte once and write every output byte once (16 W bytes
// a slot); a design that reads only the real keys must still write every
// output slot.  A tree of pairwise merges (benchmarks/earlier/) reads and
// writes the whole stream once per level, sentinel tails included: 3x the
// bound for 8 runs.  Here one pass merges up to FAN_IN (16) runs, so R runs
// take ceil(log16 R) passes: one for a mesh of up to 16 shards, two for the
// bucketed flush's 128-run groups.  A pass is three launches:
//
// 0. the samples (kway_sample_kernel): the key every SAMPLE keys of each
//    run gets its exact rank in its group's merge (a search over every
//    other run), and the last real sample finds where its run's
//    all-SENTINEL tail starts.  The tiles cover only the N_real real keys;
//    output slots past N_real are written as SENTINEL without reading
//    anything.
// 1. the plan (kway_plan_kernel): one warp per output tile boundary d (a
//    multiple of TILE) of each group of runs finds the exact split of d:
//    s_r, the keys of run r among the first d of the stable merge (ties:
//    lower run first).  The samples' ranks bound s_r to a window of SAMPLE
//    keys, so the searches below start short.  Each run's window [lo_r, hi_r]
//    holding s_r shrinks round by round: Q candidate keys spread over the
//    widest window (Q = 32 / G, G the power of two at or above R), and
//    lane (q, r) counts candidate q's keys before it in run r by one
//    binary search clamped to run r's window; the G lanes of a candidate
//    sum their counts.  A sum below d puts the candidate inside the first
//    d (every run's lo rises to its count), a sum above puts it outside
//    (every hi falls to its count), a sum of d is the split.  The clamped
//    counts decide exactly: the first d keys are a prefix of the stable
//    order, so a candidate's true counts are all at most s or all at
//    least s, and clamping into windows that hold s keeps that.  One
//    search a lane keeps a round at 32 searches and the warp's registers
//    few: candidates in every window, each searched in every run, cost
//    R^2 searches a round and capped the plan's occupancy.
// 2. the merge (kway_merge_kernel): one block per tile of TILE outputs.  It
//    stages its R slices (from the plan's splits at its two boundaries)
//    side by side in shared memory, plane by plane, with cp.async, then
//    merges them there in ceil(log2 R) levels of pairwise merge-path
//    merges between two buffers (a thread finds where its ITEMS outputs
//    start by a binary search, then merges them one compare each: the top
//    words, carried with each key's staged slot; the lower words are read
//    through the slot only where top words tie), then writes each plane
//    out in output order, 16-byte stores from consecutive threads.  A
//    tile past N_real only writes SENTINEL; blocks take the tiles in a
//    stride coprime with their count, so that every wave mixes merging
//    tiles with storing ones.  The levels cost one compare an output;
//    ranking each staged key by a search in every other slice costs R - 1
//    searches a key.
//
// Any length and any run length work (the last run may be short); one run
// is a copy.  The input is not modified; a merge of more than FAN_IN runs
// ping-pongs between `tmp` and `out`.

#include <algorithm>
#include <numeric>

#include "common.cuh"

namespace {

// runs one pass merges: one pass for a mesh of up to 16 shards, two for
// the bucketed flush's groups of up to 256 chunk runs (F = 8 would take
// three); the plan's warp still holds two candidates a run
constexpr int FAN_IN = 16;
constexpr int MAX_PASSES = 16;   // 16^10 > 2^40 runs
constexpr int SAMPLE = 512;      // a run's keys from one sample to the next
constexpr int PLAN_THREADS = 128;
constexpr int PLAN_WARPS = PLAN_THREADS / 32;

// The merge's tile: TILE outputs a block, ITEMS consecutive outputs a
// thread (16 up to W = 4: a merge-path search a thread and level then
// costs less per output than at 8, measured on the H100; 4 beyond, where
// the planes fill the shared memory); its shared memory (the top words twice,
// the lower words once, each key's staged slot twice) stays under ~92 KB.
// The merged buffers hold a gap after every ITEMS keys (PAD): unpadded, a
// warp's stores would land ITEMS words apart, on two banks.
template <int W>
struct KWay {
  static constexpr int TILE = W == 1 ? 4096 : W <= 4 ? 2048 : 1024;
  static constexpr int THREADS = W == 1 ? 256 : W <= 4 ? 128 : 256;
  static constexpr int ITEMS = TILE / THREADS;
  static constexpr int PAD = TILE + TILE / ITEMS;
  static constexpr int SMEM =
      2 * PAD * 8 + (W - 1) * TILE * 8 + (W > 1 ? 2 * PAD * 2 : 0);
  __device__ static int at(int i) { return i + i / ITEMS; }
};

// One pass: groups of `fan` runs of `run_len` keys (the last group and run
// may be short), each group merged into its own span of the output.
struct Pass {
  int64_t run_len, group_len, groups, tiles;  // tiles per group
  int64_t samples;  // sample slots per run
  int64_t stride;   // tile order: coprime with tiles
  int fan;
  // the pass's scratch (int64): its plan, its samples' ranks, its runs'
  // real lengths
  int64_t plan_len() const { return groups * (tiles + 1) * FAN_IN; }
  int64_t rank_len() const { return groups * fan * samples; }
  int64_t scratch_len() const {
    return plan_len() + rank_len() + groups * fan;
  }
};

template <int W>
int plan_passes(int64_t n, int64_t run_len, Pass* out) {
  int count = 0;
  int64_t runs = (n + run_len - 1) / run_len;
  while (runs > 1) {
    const int64_t groups = (runs + FAN_IN - 1) / FAN_IN;
    const int fan = (int)((runs + groups - 1) / groups);  // balanced
    Pass p;
    p.run_len = run_len;
    p.fan = fan;
    p.group_len = run_len * fan;
    p.groups = (runs + fan - 1) / fan;
    p.tiles = (std::min(p.group_len, n) + KWay<W>::TILE - 1) / KWay<W>::TILE;
    p.samples = (run_len + SAMPLE - 1) / SAMPLE;
    // the merge takes tiles in a stride of ~0.618 tiles, so that tiles of
    // real keys and SENTINEL-only tiles (the runs' tails come last) share
    // every wave of blocks
    p.stride = std::max<int64_t>(1, p.tiles * 618 / 1000);
    while (std::gcd(p.stride, p.tiles) != 1) p.stride++;
    out[count++] = p;
    run_len = p.group_len;
    runs = p.groups;
  }
  return count;
}

// Key i of a run, whose plane q lies at p + q * s, against the W words v:
// whether it comes after v in the merge (key > v, or key >= v when
// !strict).  x0 is its top word, already loaded.
template <int W>
__device__ __forceinline__ bool after(const int64_t* __restrict__ p,
                                      int64_t i, int64_t s, int64_t x0,
                                      const int64_t (&v)[W], bool strict) {
  if (x0 != v[0]) return x0 > v[0];
#pragma unroll
  for (int q = 1; q < W; q++) {
    const int64_t x = p[q * s + i];
    if (x != v[q]) return x > v[q];
  }
  return !strict;
}

template <int W>
__device__ __forceinline__ bool is_sentinel(const int64_t* __restrict__ p,
                                            int64_t i, int64_t s) {
#pragma unroll
  for (int q = 0; q < W; q++)
    if (p[q * s + i] != KAT_SENTINEL) return false;
  return true;
}

__device__ __forceinline__ int64_t warp_sum(int64_t v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

__device__ __forceinline__ int64_t shfl(int64_t v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}

// op over the lanes whose index differs from this lane's only in the bits
// from `from` up to (not including) `to`, in every such lane.
template <class Op>
__device__ __forceinline__ int64_t lanes_reduce(int64_t v, int from, int to,
                                                Op op) {
  for (int d = from; d < to; d <<= 1)
    v = op(v, (int64_t)__shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

// Where run r of a group starts, and how many keys it holds (0 past the
// group's runs).
struct GroupRuns {
  const int64_t* base;
  int64_t ng, run_len;
  int R;
  __device__ GroupRuns(const int64_t* src, int64_t n, const Pass& pass,
                       int64_t g) {
    const int64_t gs = g * pass.group_len;
    base = src + gs;
    ng = min(pass.group_len, n - gs);
    run_len = pass.run_len;
    R = (int)min((int64_t)pass.fan, (ng + run_len - 1) / run_len);
  }
  __device__ const int64_t* run(int r) const { return base + r * run_len; }
  __device__ int64_t len(int r) const {
    return r < R ? min(run_len, ng - r * run_len) : 0;
  }
};

// The first key at or after `a` in run[a, b) that comes after v (strict:
// key > v, else key >= v); b if none.
template <int W>
__device__ __forceinline__ int64_t first_after(const int64_t* run, int64_t ss,
                                               int64_t a, int64_t b,
                                               const int64_t (&v)[W],
                                               bool strict) {
  while (a < b) {
    const int64_t mid = (a + b) >> 1;
    if (after<W>(run, mid, ss, run[mid], v, strict)) b = mid;
    else a = mid + 1;
  }
  return a;
}

// The first all-SENTINEL key of run[a, b) (b if none), keys before a real.
template <int W>
__device__ __forceinline__ int64_t first_sentinel(const int64_t* run,
                                                  int64_t ss, int64_t a,
                                                  int64_t b) {
  while (a < b) {
    const int64_t mid = (a + b) >> 1;
    if (is_sentinel<W>(run, mid, ss)) b = mid;
    else a = mid + 1;
  }
  return a;
}

// The samples: rank[(g * fan + r) * samples + j] = the stable rank, in
// group g's merge, of key j * SAMPLE of run r (INT64_MAX where it is
// SENTINEL or past the run): its index plus, for every other run, the
// count of keys before it (a search over the whole run).  G lanes (the
// power of two at or above fan) take a sample, one lane a run.  The
// group whose sample is the run's last real one also writes the run's
// real length to real[g * fan + r].
template <int W>
__global__ void __launch_bounds__(PLAN_THREADS)
kway_sample_kernel(const int64_t* __restrict__ src, int64_t ss, int64_t n,
                   Pass pass, int64_t* __restrict__ rank,
                   int64_t* __restrict__ real) {
  const int lane = threadIdx.x & 31;
  int G = 1;
  while (G < pass.fan) G *= 2;
  const int64_t sid =
      ((int64_t)blockIdx.x * PLAN_WARPS + (threadIdx.x >> 5)) * (32 / G) +
      lane / G;
  const bool valid = sid < pass.groups * pass.fan * pass.samples;
  const int64_t g = valid ? sid / (pass.fan * pass.samples) : 0;
  const int r = (int)(sid / pass.samples % pass.fan);
  const int64_t j = sid % pass.samples;
  const int r2 = lane & (G - 1);  // the run this lane counts in
  const GroupRuns runs(src, n, pass, g);
  const int64_t p = j * SAMPLE, len = runs.len(r);
  const bool has = valid && p < len;
  int64_t v[W];
  bool is_real = false;
  if (has) {
#pragma unroll
    for (int k = 0; k < W; k++) v[k] = runs.run(r)[k * ss + p];
    is_real = !is_sentinel<W>(runs.run(r), p, ss);
  }
  int64_t c = 0;
  if (is_real && r2 < runs.R) {
    // a lower run's keys equal to v come first, a higher run's after
    c = r2 == r ? p
                : first_after<W>(runs.run(r2), ss, 0, runs.len(r2), v,
                                 r2 < r);
  }
  c = lanes_reduce(c, 1, G, [](int64_t x, int64_t y) { return x + y; });
  if (valid && r2 == 0) {
    rank[sid] = is_real ? c : INT64_MAX;
    // the run's real length lies after its last real sample
    const bool last =
        is_real && (p + SAMPLE >= len ||
                    is_sentinel<W>(runs.run(r), p + SAMPLE, ss));
    if (last)
      real[g * pass.fan + r] = first_sentinel<W>(
          runs.run(r), ss, p + 1, min(p + SAMPLE, len));
    else if (has && j == 0 && !is_real)
      real[g * pass.fan + r] = 0;
  }
}

// The plan: plan[(g * (tiles + 1) + t) * FAN_IN + r] = s_r at boundary
// d = min(t * TILE, N_real) of group g; at t = tiles that is run r's real
// length.  One warp a boundary; lane l works on run r = l % G (G the
// power of two at or above R) for candidate q = l / G of Q = 32 / G, so
// that each lane runs one search a round.  The samples' ranks bound each
// run's window to SAMPLE keys before the first round.
template <int W>
__global__ void __launch_bounds__(PLAN_THREADS)
kway_plan_kernel(const int64_t* __restrict__ src, int64_t ss, int64_t n,
                 Pass pass, const int64_t* __restrict__ rank,
                 const int64_t* __restrict__ real_of,
                 int64_t* __restrict__ plan) {
  constexpr int64_t TILE = KWay<W>::TILE;
  const int lane = threadIdx.x & 31;
  const int64_t gw = (int64_t)blockIdx.x * PLAN_WARPS + (threadIdx.x >> 5);
  const int64_t g = gw / (pass.tiles + 1), t = gw % (pass.tiles + 1);
  if (g >= pass.groups) return;
  const GroupRuns runs(src, n, pass, g);
  const int R = runs.R;
  int G = 1;
  while (G < R) G *= 2;
  const int Q = 32 / G;
  const int r = lane & (G - 1), q = lane / G;
  const bool live = r < R;
  const int64_t* run = runs.run(r);
  auto sum_runs = [&](int64_t v) {  // over the runs, in every lane
    return lanes_reduce(v, 1, G, [](int64_t x, int64_t y) { return x + y; });
  };

  const int64_t real = live ? real_of[g * pass.fan + r] : 0;
  const int64_t n_real = sum_runs(real);
  const int64_t d = min(t * TILE, n_real);
  // the window [lo, hi] that holds s_r, the same in every lane of run r:
  // the samples of run r ranked below d lie inside the first d keys, the
  // first one ranked at or above d outside
  int64_t lo = 0, hi = 0;
  if (live) {
    const int64_t* rk = rank + (g * pass.fan + r) * pass.samples;
    int64_t a = 0, b = pass.samples;
    while (a < b) {
      const int64_t mid = (a + b) >> 1;
      if (rk[mid] < d) a = mid + 1;
      else b = mid;
    }
    lo = max(a > 0 ? (a - 1) * SAMPLE + 1 : 0, d - (n_real - real));
    hi = min(min(a * SAMPLE, real), d);
  }
  int64_t split;
  for (;;) {
    if (sum_runs(lo) == d) {
      split = lo;
      break;
    }
    if (sum_runs(hi) == d) {
      split = hi;
      break;
    }
    // the candidates: Q keys spread over the widest window, of run p
    const int64_t widest = lanes_reduce(
        (hi - lo) << 5 | (31 - r), 1, G,
        [](int64_t x, int64_t y) { return max(x, y); });
    const int p = 31 - (int)(widest & 31);
    const int64_t w = widest >> 5;
    const int64_t m = shfl(lo, p) + w * (q + 1) / (Q + 1);
    const int64_t* prun = runs.run(p);
    int64_t v[W];
#pragma unroll
    for (int k = 0; k < W; k++) v[k] = prun[k * ss + m];
    // run r's count of keys before the candidate, clamped to its window
    // a lower run's keys equal to v come first, a higher run's after
    const int64_t a = r == p ? m : first_after<W>(run, ss, lo, hi, v, r < p);
    const int64_t sum = sum_runs(live ? a : 0);
    const unsigned hit = __ballot_sync(0xffffffffu, sum == d);
    if (hit) {  // that candidate's counts are the split
      split = shfl(a, (__ffs(hit) - 1) / G * G + r);
      break;
    }
    // below d: the candidate (and every key before it) lies inside the
    // first d; above: outside
    const int64_t up = lanes_reduce(
        sum < d ? a + (r == p) : -1, G, 32,
        [](int64_t x, int64_t y) { return max(x, y); });
    const int64_t down = lanes_reduce(
        sum > d ? a : INT64_MAX, G, 32,
        [](int64_t x, int64_t y) { return min(x, y); });
    lo = max(lo, up);
    hi = min(hi, down);
  }
  if (live && q == 0)
    plan[(g * (pass.tiles + 1) + t) * FAN_IN + r] = split;
}

// Block-wide p[i] = value(i) for i < len, in 16-byte stores but for an
// unaligned first key and an odd last one.
template <int THREADS, class Value>
__device__ __forceinline__ void store_keys(int64_t* p, int64_t len,
                                           Value value) {
  const int64_t head = min((int64_t)(((uintptr_t)p >> 3) & 1), len);
  if (head && threadIdx.x == 0) p[0] = value(0);
  const int64_t pairs = (len - head) >> 1;
  longlong2* v = reinterpret_cast<longlong2*>(p + head);
  for (int64_t i = threadIdx.x; i < pairs; i += THREADS)
    v[i] = make_longlong2(value(head + 2 * i), value(head + 2 * i + 1));
  if ((len - head) & 1 && threadIdx.x == 0) p[len - 1] = value(len - 1);
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Whether staged keys i and j, whose top words tie, are in order (i's
// lower words at most j's): word q >= 1 of a key lies at low[(q - 1) *
// TILE + its slot].
template <int W, int TILE>
__device__ __forceinline__ bool lower_le(const int64_t* low, int si, int sj) {
#pragma unroll
  for (int q = 0; q < W - 1; q++) {
    const int64_t x = low[q * TILE + si], y = low[q * TILE + sj];
    if (x != y) return x < y;
  }
  return true;
}

template <int W>
__global__ void __launch_bounds__(KWay<W>::THREADS)
kway_merge_kernel(const int64_t* __restrict__ src, int64_t ss,
                  int64_t* __restrict__ dst, int64_t ds, int64_t n,
                  Pass pass, const int64_t* __restrict__ plan) {
  using K = KWay<W>;
  constexpr int TILE = K::TILE, ITEMS = K::ITEMS, THREADS = K::THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  // the top words and the slots ping-pong between two buffers, padded
  int64_t* top = reinterpret_cast<int64_t*>(smem);         // [PAD]
  int64_t* top2 = top + K::PAD;                            // [PAD]
  int64_t* low = top2 + K::PAD;                            // [W - 1][TILE]
  uint16_t* slot = reinterpret_cast<uint16_t*>(low + (W - 1) * TILE);
  uint16_t* slot2 = slot + K::PAD;
  __shared__ int s_off[FAN_IN + 1];
  __shared__ int64_t s_start[FAN_IN];
  __shared__ int64_t s_real;

  const int64_t g = blockIdx.x / pass.tiles;
  const int64_t t = blockIdx.x % pass.tiles * pass.stride % pass.tiles;
  const int64_t gs = g * pass.group_len;
  const int64_t ng = min(pass.group_len, n - gs);
  const int64_t d0 = t * TILE;
  if (d0 >= ng) return;  // the short last group needs fewer tiles
  const int64_t d1 = min(d0 + TILE, ng);
  const int R = (int)min((int64_t)pass.fan,
                         (ng + pass.run_len - 1) / pass.run_len);
  const int64_t* p0 = plan + (g * (pass.tiles + 1) + t) * FAN_IN;
  const int64_t* p_real = plan + (g * (pass.tiles + 1) + pass.tiles) * FAN_IN;
  if (threadIdx.x < 32) {
    const int r = threadIdx.x;
    const int64_t start = r < R ? p0[r] : 0;
    const int len = r < R ? (int)(p0[FAN_IN + r] - start) : 0;
    const int64_t real = warp_sum(r < R ? p_real[r] : 0);
    int inc = len;  // inclusive scan of the slice lengths
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, k);
      if (r >= k) inc += y;
    }
    if (r < FAN_IN) {
      s_start[r] = start;
      s_off[r + 1] = inc;
    }
    if (r == 0) {
      s_off[0] = 0;
      s_real = real;
    }
  }
  __syncthreads();
  const int64_t real_end = min(d1, s_real);
  const int64_t* run0 = src + gs;
  int64_t* out = dst + gs;

  if (d0 < real_end) {
    const int m = (int)(real_end - d0);
    // 1. stage every run's slice side by side, plane by plane, the copies
    //    in flight together; a key's slot is where its lower words lie
#pragma unroll
    for (int q = 0; q < W; q++) {
      for (int r = 0; r < R; r++) {
        const int o = s_off[r], len = s_off[r + 1] - o;
        const int64_t* from = run0 + q * ss + r * pass.run_len + s_start[r];
        for (int i = threadIdx.x; i < len; i += THREADS)
          cp_async8(q == 0 ? &top[K::at(o + i)] : &low[(q - 1) * TILE + o + i],
                    from + i);
      }
    }
    if constexpr (W > 1)
      for (int i = threadIdx.x; i < m; i += THREADS)
        slot[K::at(i)] = (uint16_t)i;
    cp_async_wait_all();
    __syncthreads();

    // 2. a tree of merges: at level l, neighbouring sorted spans of 2^l
    //    slices merge pairwise (the lower slices first on ties) from one
    //    buffer into the other; each thread finds where its ITEMS
    //    consecutive outputs start on the merge path and merges them, the
    //    two spans' next keys in registers
    auto le = [&](int i, int j) {  // staged keys at i and j in order
      const int64_t x = top[K::at(i)], y = top[K::at(j)];
      if (x != y) return x < y;
      if constexpr (W > 1)
        return lower_le<W, TILE>(low, slot[K::at(i)], slot[K::at(j)]);
      return true;
    };
    for (int width = 1; width < R; width *= 2) {
      const int j0 = threadIdx.x * ITEMS;
      const int j_end = min(j0 + ITEMS, m);
      int j = j0;
      while (j < j_end) {
        // the pair of spans whose merge holds output j
        int p = 0;
        while (s_off[min((p + 1) * 2 * width, R)] <= j) p++;
        const int a0 = s_off[p * 2 * width];
        const int b0 = s_off[min(p * 2 * width + width, R)];
        const int e0 = s_off[min((p + 1) * 2 * width, R)];
        const int diag = j - a0;
        int lo = max(0, diag - (e0 - b0)), hi = min(diag, b0 - a0);
        while (lo < hi) {  // merge path: a-keys among the first diag
          const int mid = (lo + hi) >> 1;
          if (le(a0 + mid, b0 + diag - 1 - mid)) lo = mid + 1;
          else hi = mid;
        }
        int ia = a0 + lo, ib = b0 + diag - lo;
        int64_t ka = ia < b0 ? top[K::at(ia)] : 0;
        int64_t kb = ib < e0 ? top[K::at(ib)] : 0;
        for (const int stop = min(j_end, e0); j < stop; j++) {
          bool take_a = ib >= e0;
          if (ia < b0 && ib < e0) {
            take_a = ka < kb;
            if constexpr (W > 1) {
              if (ka == kb)
                take_a = lower_le<W, TILE>(low, slot[K::at(ia)],
                                           slot[K::at(ib)]);
            } else {
              take_a |= ka == kb;
            }
          }
          if (take_a) {
            top2[K::at(j)] = ka;
            if constexpr (W > 1) slot2[K::at(j)] = slot[K::at(ia)];
            if (++ia < b0) ka = top[K::at(ia)];
          } else {
            top2[K::at(j)] = kb;
            if constexpr (W > 1) slot2[K::at(j)] = slot[K::at(ib)];
            if (++ib < e0) kb = top[K::at(ib)];
          }
        }
      }
      __syncthreads();  // this level is written before the next reads it
      int64_t* tt = top;
      top = top2;
      top2 = tt;
      uint16_t* ts = slot;
      slot = slot2;
      slot2 = ts;
    }

    // 3. every plane out in output order
    store_keys<THREADS>(out + d0, m,
                        [&](int64_t i) { return top[K::at(i)]; });
#pragma unroll
    for (int q = 1; q < W; q++) {
      const int64_t* plane = low + (q - 1) * TILE;
      store_keys<THREADS>(out + q * ds + d0, m,
                          [&](int64_t i) { return plane[slot[K::at(i)]]; });
    }
  }
  // 4. the slots past the real keys: SENTINEL, nothing read
  const int64_t f0 = max(d0, s_real);
  if (f0 < d1) {
#pragma unroll
    for (int q = 0; q < W; q++)
      store_keys<THREADS>(out + q * ds + f0, d1 - f0,
                          [](int64_t) { return (int64_t)KAT_SENTINEL; });
  }
}

template <int W>
int64_t scratch_len(int64_t n, int64_t run_len) {
  Pass passes[MAX_PASSES];
  const int count = plan_passes<W>(n, run_len, passes);
  int64_t most = 0;
  for (int i = 0; i < count; i++)
    most = std::max(most, passes[i].scratch_len());
  return most;
}

template <int W>
int launch_kway(const int64_t* keys, int64_t sk, int64_t* out, int64_t* tmp,
                int64_t* scratch, int64_t n, int64_t run_len,
                cudaStream_t stream) {
  Pass passes[MAX_PASSES];
  const int count = plan_passes<W>(n, run_len, passes);
  if (count == 0)  // one run: a copy of each plane
    return (int)cudaMemcpy2DAsync(out, sizeof(int64_t) * n, keys,
                                  sizeof(int64_t) * sk, sizeof(int64_t) * n,
                                  W, cudaMemcpyDeviceToDevice, stream);
  if ((count > 1 && tmp == nullptr) || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  static int sms_of[kat::MAX_DEVICES] = {};
  int sms;
  const cudaError_t err = kat::prepare(kway_merge_kernel<W>, KWay<W>::SMEM,
                                       sms_of, &sms);
  if (err != cudaSuccess) return (int)err;
  const int64_t* src = keys;
  int64_t ss = sk;
  for (int i = 0; i < count; i++) {
    const Pass& p = passes[i];
    // the last pass lands in `out`; earlier ones alternate backwards
    int64_t* dst = (count - 1 - i) % 2 == 0 ? out : tmp;
    int fan_lanes = 1;  // G: the lanes of one sample
    while (fan_lanes < p.fan) fan_lanes *= 2;
    const int64_t per_block = (int64_t)PLAN_WARPS * (32 / fan_lanes);
    const int64_t sample_blocks =
        (p.groups * p.fan * p.samples + per_block - 1) / per_block;
    const int64_t plan_blocks =
        (p.groups * (p.tiles + 1) + PLAN_WARPS - 1) / PLAN_WARPS;
    const int64_t blocks = p.groups * p.tiles;
    if (sample_blocks >= (int64_t{1} << 31) ||
        plan_blocks >= (int64_t{1} << 31) || blocks >= (int64_t{1} << 31))
      return (int)cudaErrorInvalidValue;
    int64_t* rank = scratch + p.plan_len();
    int64_t* real = rank + p.rank_len();
    kway_sample_kernel<W><<<(unsigned)sample_blocks, PLAN_THREADS, 0,
                            stream>>>(src, ss, n, p, rank, real);
    KAT_CHECK_LAUNCH();
    kway_plan_kernel<W><<<(unsigned)plan_blocks, PLAN_THREADS, 0, stream>>>(
        src, ss, n, p, rank, real, scratch);
    KAT_CHECK_LAUNCH();
    kway_merge_kernel<W><<<(unsigned)blocks, KWay<W>::THREADS, KWay<W>::SMEM,
                           stream>>>(src, ss, dst, n, n, p, scratch);
    KAT_CHECK_LAUNCH();
    src = dst;
    ss = n;
  }
  return 0;
}

}  // namespace

#define KAT_FOR_WORDS(X) \
  X(2)                   \
  X(3)                   \
  X(4)                   \
  X(5)                   \
  X(6)                   \
  X(7)                   \
  X(8)                   \
  X(9)

// Outputs one merge block takes for keys of `words` words (1-9).
extern "C" int kat_merge_runs_tile(int words) {
  switch (words) {
#define KAT_TILE(W) \
  case W:           \
    return KWay<W>::TILE;
    KAT_TILE(1)
    KAT_FOR_WORDS(KAT_TILE)
#undef KAT_TILE
    default:
      return 0;
  }
}

// int64 elements of the scratch (each pass's plan, samples' ranks and
// runs' real lengths) for n keys of `words` words (1-9).
extern "C" int64_t kat_merge_runs_scratch(int64_t n, int64_t run_len,
                                          int words) {
  if (n < 1 || run_len < 1) return 0;
  switch (words) {
#define KAT_SCRATCH(W) \
  case W:              \
    return scratch_len<W>(n, run_len);
    KAT_SCRATCH(1)
    KAT_FOR_WORDS(KAT_SCRATCH)
#undef KAT_SCRATCH
    default:
      return 0;
  }
}

// out[0:n) = the ascending merge of the sorted runs keys[r*run_len :
// (r+1)*run_len) of keys[0:n) (the last may be short).  `scratch` holds
// kat_merge_runs_scratch(n, run_len, 1) elements; `tmp` (n keys) may be
// null when the merge takes one pass.  keys is not modified.
extern "C" int kat_merge_runs(const int64_t* keys, int64_t* out, int64_t* tmp,
                              int64_t* scratch, int64_t n, int64_t run_len,
                              void* stream_ptr) {
  if (n < 0 || run_len < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  return launch_kway<1>(keys, n, out, tmp, scratch, n, run_len,
                        (cudaStream_t)stream_ptr);
}

// out[q * n + i] for i < n = the ascending lexicographic merge of the sorted
// runs [r*run_len, (r+1)*run_len) of the `words`-word (2-9) keys whose
// plane q lies at keys + q * sk; `out` and `tmp` hold `words` contiguous
// planes of n keys, `scratch` kat_merge_runs_scratch(n, run_len, words)
// elements; tmp may be null when the merge takes one pass.  keys is not
// modified.
extern "C" int kat_merge_runs_words(const int64_t* keys, int64_t sk,
                                    int64_t* out, int64_t* tmp,
                                    int64_t* scratch, int64_t n,
                                    int64_t run_len, int words,
                                    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n < 0 || run_len < 1 || (n > 1 && sk < n))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  switch (words) {
#define KAT_MERGE_RUNS_WORDS(W) \
  case W:                       \
    return launch_kway<W>(keys, sk, out, tmp, scratch, n, run_len, stream);
    KAT_FOR_WORDS(KAT_MERGE_RUNS_WORDS)
#undef KAT_MERGE_RUNS_WORDS
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K2: merge-path merge of the sorted count table with the sorted fresh keys.
//
// Replaces kat_tpu/ops/sort_kernel.py::_window_kernel in final-phase mode,
// reached through kat_tpu/ops/merge_kernel.py::merge_sorted_kernel, the
// table merge of the counting flush (kat_tpu/core/counting.py:351).  The
// TPU laid the two runs out as [reversed(b) | a | pad] and ran the last
// phase of a bitonic network over it; none of that layout is carried over.
//
// What bounds it on the H100: device-memory traffic, one read of both
// inputs and one write of the output (int64 key + int32 weight: 12 bytes
// each way per element).  One merge is two launches:
//   merge_partition  one thread per tile boundary finds, by binary search
//     on the merge path, how many a-elements precede output d = tile *
//     TILE; all the searches run at once, so no tile waits on ~26
//     dependent loads of its own before it can stage anything;
//   merge_tiles      one block per TILE consecutive outputs reads its two
//     splits, stages a's and b's slices (keys and planes) in dynamic
//     shared memory with 16-byte loads, every load issued before any
//     store; each thread finds its ITEMS outputs' start by a merge-path
//     search in shared memory and merges them from there; the outputs go
//     back through shared memory (ITEMS a thread, padded so that neither
//     side meets a bank conflict) and out as 16-byte stores.
//
// Ties take the table element first, so the merge is stable; the fresh
// keys' weight is (key != SENTINEL), as at counting.py:349-350.  The
// output is exactly na + nb long.
//
// kat_merge_sorted_payload is the same body carrying 1-3 int32 planes
// from BOTH sides: the table/query merge of the sort-merge join
// (kat_tpu/ops/join.py:130, payload (count, idx); :199, payload
// (count_a, count_b, source); the port's join carries one plane, the
// query's position, and its dual join two).  What bounds it: device-memory
// traffic, 8 + 4P bytes in and the same out per element.  The join relies
// on the tie rule: a table row leads the queries that equal its key.

#include "common.cuh"

// 384 x 8 outputs a block: benchmarks/sweep_flush_kernels.py --tiles
// rebuilds this file with other values
#ifndef KAT_MG_THREADS
#define KAT_MG_THREADS 384
#endif
#ifndef KAT_MG_ITEMS
#define KAT_MG_ITEMS 8
#endif

namespace {

constexpr int THREADS = KAT_MG_THREADS;
constexpr int ITEMS = KAT_MG_ITEMS;
constexpr int TILE = THREADS * ITEMS;  // outputs per block
constexpr int MAX_PLANES = 3;
static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps");
static_assert(ITEMS % 8 == 0, "padded outputs need ITEMS % 8 == 0 to be "
                              "free of bank conflicts");
static_assert(TILE <= 1 << 16, "a source index must fit 16 bits");

// shared memory: the staged keys (at most TILE + 4 slots), then per plane
// the staged values (TILE + 8); on the way out thread t's keys sit at
// [t * KEY_STRIDE, + ITEMS) and its plane values at [t * P_STRIDE, + ITEMS)
constexpr int KEY_STRIDE = ITEMS + 2;
constexpr int P_STRIDE = ITEMS + 4;
constexpr int KEY_SLOTS = THREADS * KEY_STRIDE;
constexpr int P_SLOTS = THREADS * P_STRIDE;
constexpr uint32_t FROM_B = 1u << 16;

struct PlanesIn {
  const int32_t* p[MAX_PLANES];
};
struct PlanesOut {
  int32_t* p[MAX_PLANES];
};

// One thread per tile boundary t: the merge-path split of output d = t *
// TILE.  (A warp per boundary testing 32 cut points a step took ~6 steps
// but nine times the loads, and measured three times slower.)
__global__ void __launch_bounds__(256)
merge_partition(const int64_t* __restrict__ a, int64_t na,
                const int64_t* __restrict__ b, int64_t nb, int64_t tiles,
                int64_t* __restrict__ splits) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t <= tiles)
    splits[t] = kat::merge_path(a, na, b, nb, min(t * TILE, na + nb));
}

// P payload planes ride with the keys.  With B_WEIGHT (P == 1) the b side
// has no plane in memory: its value is (key != SENTINEL).
template <int P, bool B_WEIGHT>
__global__ void __launch_bounds__(THREADS)
merge_tiles(const int64_t* __restrict__ a, PlanesIn ap, int64_t na,
            const int64_t* __restrict__ b, PlanesIn bp, int64_t nb,
            const int64_t* __restrict__ splits,
            int64_t* __restrict__ out_keys, PlanesOut op) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* sk = reinterpret_cast<int64_t*>(smem);
  int32_t* sp = reinterpret_cast<int32_t*>(sk + KEY_SLOTS);  // [P][P_SLOTS]
  const int tid = threadIdx.x;
  const int64_t d0 = (int64_t)blockIdx.x * TILE;
  const int64_t i0 = splits[blockIdx.x];
  const int len = (int)(min(d0 + TILE, na + nb) - d0);
  const int la = (int)(splits[blockIdx.x + 1] - i0);
  const int lb = len - la;
  const int64_t j0 = d0 - i0;

  // 1. stage a[i0, i0 + la) and b[j0, j0 + lb)
  kat::Chunks<int64_t, THREADS, ITEMS / 2 + 1> ck;
  kat::Chunks<int32_t, THREADS, ITEMS / 4 + 1> cp[P];
  ck.load(a + i0, la, b + j0, lb);
#pragma unroll
  for (int q = 0; q < P; q++) {
    if constexpr (B_WEIGHT) cp[q].load(ap.p[q] + i0, la);
    else cp[q].load(ap.p[q] + i0, la, bp.p[q] + j0, lb);
  }
  ck.store(sk);
#pragma unroll
  for (int q = 0; q < P; q++) cp[q].store(sp + q * P_SLOTS);
  __syncthreads();
  const int64_t* sa = sk + ck.first(0);
  const int64_t* sb = sk + ck.first(1);

  // 2. this thread's outputs start at local diagonal dt
  const int dt = min(tid * ITEMS, len);
  int lo = max(0, dt - lb);
  int hi = min(dt, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sa[mid] <= sb[dt - 1 - mid]) lo = mid + 1;
    else hi = mid;
  }
  int ia = lo, ib = dt - lo;
  int64_t ka = sa[ia], kb = sb[ib];  // the heads (slots past an end are
                                     // staged memory, never taken)
  int64_t rk[ITEMS];
  uint32_t src[ITEMS];
#pragma unroll
  for (int e = 0; e < ITEMS; e++) {
    const bool take_a = ia < la && (ib >= lb || ka <= kb);
    rk[e] = take_a ? ka : kb;
    src[e] = take_a ? (uint32_t)ia : FROM_B | (uint32_t)ib;
    if (take_a) ka = sa[++ia];
    else kb = sb[++ib];
  }
  int32_t rp[P][ITEMS];
#pragma unroll
  for (int q = 0; q < P; q++) {
    const int32_t* pa = sp + q * P_SLOTS + cp[q].first(0);
    const int32_t* pb = sp + q * P_SLOTS + cp[q].first(1);
#pragma unroll
    for (int e = 0; e < ITEMS; e++) {
      const int i = (int)(src[e] & (FROM_B - 1));
      if constexpr (B_WEIGHT)
        rp[q][e] = src[e] & FROM_B ? rk[e] != KAT_SENTINEL : pa[i];
      else
        rp[q][e] = src[e] & FROM_B ? pb[i] : pa[i];
    }
  }
  __syncthreads();  // every thread is done reading the staged inputs

  // 3. back through shared memory, padded, and out 16 bytes at a time
  {
    longlong2* mk = reinterpret_cast<longlong2*>(sk + tid * KEY_STRIDE);
#pragma unroll
    for (int v = 0; v < ITEMS / 2; v++)
      mk[v] = make_longlong2(rk[2 * v], rk[2 * v + 1]);
#pragma unroll
    for (int q = 0; q < P; q++) {
      int4* mp = reinterpret_cast<int4*>(sp + q * P_SLOTS + tid * P_STRIDE);
#pragma unroll
      for (int v = 0; v < ITEMS / 4; v++)
        mp[v] = make_int4(rp[q][4 * v], rp[q][4 * v + 1], rp[q][4 * v + 2],
                          rp[q][4 * v + 3]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int v = 0; v < ITEMS / 2; v++) {
    const int j = 2 * (v * THREADS + tid);
    if (j >= len) continue;
    const longlong2 x =
        *reinterpret_cast<const longlong2*>(sk + j + 2 * (j / ITEMS));
    if (j + 2 <= len) {
      *reinterpret_cast<longlong2*>(out_keys + d0 + j) = x;
    } else {
      out_keys[d0 + j] = x.x;
    }
  }
#pragma unroll
  for (int q = 0; q < P; q++) {
    const int32_t* mp = sp + q * P_SLOTS;
#pragma unroll
    for (int v = 0; v < ITEMS / 4; v++) {
      const int j = 4 * (v * THREADS + tid);
      if (j >= len) continue;
      const int4 x = *reinterpret_cast<const int4*>(mp + j + 4 * (j / ITEMS));
      if (j + 4 <= len) {
        *reinterpret_cast<int4*>(op.p[q] + d0 + j) = x;
      } else {
        const int32_t xs[4] = {x.x, x.y, x.z, x.w};
        for (int e = 0; j + e < len; e++) op.p[q][d0 + j + e] = xs[e];
      }
    }
  }
}

int64_t tiles_for(int64_t n) { return (n + TILE - 1) / TILE; }

template <int P, bool B_WEIGHT>
int launch_merge(const int64_t* a, PlanesIn ap, int64_t na, const int64_t* b,
                 PlanesIn bp, int64_t nb, int64_t* out_keys, PlanesOut op,
                 int64_t* splits, cudaStream_t stream) {
  const int64_t n = na + nb;
  if (n <= 0) return 0;
  uintptr_t outs = (uintptr_t)out_keys;
  for (int q = 0; q < P; q++) outs |= (uintptr_t)op.p[q];
  if ((outs & 15) != 0) return (int)cudaErrorMisalignedAddress;
  constexpr int SMEM = KEY_SLOTS * 8 + P * P_SLOTS * 4;
  static int sms_of[kat::MAX_DEVICES] = {};
  int sms;
  const cudaError_t err =
      kat::prepare(merge_tiles<P, B_WEIGHT>, SMEM, sms_of, &sms);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = tiles_for(n);
  merge_partition<<<(unsigned)((tiles + 256) / 256), 256, 0, stream>>>(
      a, na, b, nb, tiles, splits);
  KAT_CHECK_LAUNCH();
  merge_tiles<P, B_WEIGHT><<<(unsigned)tiles, THREADS, SMEM, stream>>>(
      a, ap, na, b, bp, nb, splits, out_keys, op);
  KAT_CHECK_LAUNCH();
  return 0;
}

// ---------------------------------------------------------------------------
// Wide keys: W int64 words a key, plane q of a stream at ptr + q * stride.
//
// Replaces the same TPU merge with W key planes and a count plane: the
// table merge of the wide flush (kat_tpu/core/wide.py:228).  The same two
// launches as the one-word merge, the compares lexicographic over the
// words (most significant first, ties take a).  What bounds it: device
// memory, 8W + 4 bytes in and out per element.  A block stages the W planes
// of both slices (one plane's 16-byte loads in flight at a time) and a's
// counts; each thread finds its start on the merge path and merges its
// ITEMS outputs, recording each output's source (a or b, index) in shared
// memory; then each plane goes out from the staged slices in output order,
// 8-byte stores (a plane of [W][n] outputs is 8-byte aligned), consecutive
// threads on consecutive outputs.  The tile shrinks with W so that the
// staged planes stay under ~82 KB (two blocks an SM): 3072 outputs at W = 2,
// 2048 at W <= 4, 1024 beyond.
//
// kat_merge_sorted_words_payload is the same body carrying 1-3 int32
// planes from BOTH sides: the table/query merge of the wide join
// (kat_tpu/ops/join.py:130 with W key planes, payload (count, idx); :199,
// payload (count_a, count_b, source); the port's join carries one plane,
// the query's position, and its dual join two).  A plane's slices of both
// sides are staged like a's counts, TILE + 16 slots a plane (two ranges,
// each with up to 3 elements of skew and a partial chunk), 98.5 KB a block
// at three planes, so two blocks still fit an SM for every W.  What bounds
// it: device memory, 8W + 4P bytes in and out per element.

constexpr int MW_THREADS = 256;

template <int W>
struct MergeWords {
  static constexpr int ITEMS = W <= 2 ? 12 : W <= 4 ? 8 : 4;
  static constexpr int TILE = MW_THREADS * ITEMS;
};

// a[ia] <= b[ib], lexicographically over W planes in device memory
template <int W>
__device__ __forceinline__ bool words_le(const int64_t* a, int64_t sa,
                                         int64_t ia, const int64_t* b,
                                         int64_t sb, int64_t ib) {
#pragma unroll
  for (int q = 0; q < W; q++) {
    const int64_t x = a[q * sa + ia], y = b[q * sb + ib];
    if (x != y) return x < y;
  }
  return true;
}

template <int W>
__global__ void __launch_bounds__(256)
merge_words_partition(const int64_t* __restrict__ a, int64_t sa, int64_t na,
                      const int64_t* __restrict__ b, int64_t sb, int64_t nb,
                      int64_t tiles, int64_t* __restrict__ splits) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t > tiles) return;
  const int64_t diag = min(t * MergeWords<W>::TILE, na + nb);
  int64_t lo = diag > nb ? diag - nb : 0;
  int64_t hi = diag < na ? diag : na;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (words_le<W>(a, sa, mid, b, sb, diag - 1 - mid)) lo = mid + 1;
    else hi = mid;
  }
  splits[t] = lo;
}

// P planes ride with the keys.  With B_WEIGHT (P == 1) the b side has no
// plane in memory: its value is (key != SENTINEL).
template <int W, int P, bool B_WEIGHT>
__global__ void __launch_bounds__(MW_THREADS)
merge_words_tiles(const int64_t* __restrict__ a, int64_t sa, PlanesIn ap,
                  int64_t na, const int64_t* __restrict__ b, int64_t sb,
                  PlanesIn bp, int64_t nb,
                  const int64_t* __restrict__ splits,
                  int64_t* __restrict__ out, int64_t so, PlanesOut op) {
  constexpr int ITEMS = MergeWords<W>::ITEMS;
  constexpr int TILE = MergeWords<W>::TILE;
  constexpr int SLOTS = TILE + 4;    // a key plane's staged slices
  constexpr int PSLOTS = TILE + 16;  // a payload plane's
  static_assert(TILE <= 1 << 16, "a source index must fit 16 bits");
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* sk = reinterpret_cast<int64_t*>(smem);             // [W][SLOTS]
  int32_t* sp = reinterpret_cast<int32_t*>(sk + W * SLOTS);   // [P][PSLOTS]
  uint32_t* ssrc = reinterpret_cast<uint32_t*>(sp + P * PSLOTS);  // [TILE]
  const int tid = threadIdx.x;
  const int64_t d0 = (int64_t)blockIdx.x * TILE;
  const int64_t i0 = splits[blockIdx.x];
  const int len = (int)(min(d0 + TILE, na + nb) - d0);
  const int la = (int)(splits[blockIdx.x + 1] - i0);
  const int lb = len - la;
  const int64_t j0 = d0 - i0;

  // 1. stage every plane of a[i0, i0 + la) and b[j0, j0 + lb), and the
  //    payload planes (a's alone with B_WEIGHT); key plane q's a element i
  //    sits at sk[fa[q] + i], payload plane q's at sp[pa[q] + i]
  int fa[W], fb[W];
#pragma unroll
  for (int q = 0; q < W; q++) {
    kat::Chunks<int64_t, MW_THREADS, ITEMS / 2 + 1> ck;
    ck.load(a + q * sa + i0, la, b + q * sb + j0, lb);
    ck.store(sk + q * SLOTS);
    fa[q] = q * SLOTS + ck.first(0);
    fb[q] = q * SLOTS + ck.first(1);
  }
  int pa[P], pb[P];
#pragma unroll
  for (int q = 0; q < P; q++) {
    kat::Chunks<int32_t, MW_THREADS, ITEMS / 4 + 1> cw;
    if constexpr (B_WEIGHT) cw.load(ap.p[q] + i0, la);
    else cw.load(ap.p[q] + i0, la, bp.p[q] + j0, lb);
    cw.store(sp + q * PSLOTS);
    pa[q] = q * PSLOTS + cw.first(0);
    pb[q] = q * PSLOTS + cw.first(1);
  }
  __syncthreads();
  auto a_le_b = [&](int i, int j) {
#pragma unroll
    for (int q = 0; q < W; q++) {
      const int64_t x = sk[fa[q] + i], y = sk[fb[q] + j];
      if (x != y) return x < y;
    }
    return true;
  };

  // 2. this thread's outputs start at local diagonal dt; merge them
  const int dt = min(tid * ITEMS, len);
  int lo = max(0, dt - lb);
  int hi = min(dt, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a_le_b(mid, dt - 1 - mid)) lo = mid + 1;
    else hi = mid;
  }
  int ia = lo, ib = dt - lo;
#pragma unroll
  for (int e = 0; e < ITEMS; e++) {
    if (dt + e >= len) break;
    const bool take_a = ia < la && (ib >= lb || a_le_b(ia, ib));
    ssrc[dt + e] = take_a ? (uint32_t)ia++ : FROM_B | (uint32_t)ib++;
  }
  __syncthreads();

  // 3. every key plane, then the payload planes, out in output order
#pragma unroll
  for (int q = 0; q < W; q++) {
    for (int j = tid; j < len; j += MW_THREADS) {
      const uint32_t s = ssrc[j];
      const int i = (int)(s & (FROM_B - 1));
      out[q * so + d0 + j] = sk[(s & FROM_B ? fb[q] : fa[q]) + i];
    }
  }
#pragma unroll
  for (int q = 0; q < P; q++) {
    for (int j = tid; j < len; j += MW_THREADS) {
      const uint32_t s = ssrc[j];
      const int i = (int)(s & (FROM_B - 1));
      if constexpr (B_WEIGHT)
        op.p[q][d0 + j] =
            s & FROM_B ? sk[fb[0] + i] != KAT_SENTINEL : sp[pa[q] + i];
      else
        op.p[q][d0 + j] = sp[(s & FROM_B ? pb[q] : pa[q]) + i];
    }
  }
}

template <int W, int P, bool B_WEIGHT>
int launch_merge_words(const int64_t* a, int64_t sa, PlanesIn ap, int64_t na,
                       const int64_t* b, int64_t sb, PlanesIn bp, int64_t nb,
                       int64_t* out, int64_t so, PlanesOut op,
                       int64_t* splits, cudaStream_t stream) {
  const int64_t n = na + nb;
  if (n <= 0) return 0;
  constexpr int TILE = MergeWords<W>::TILE;
  constexpr int SMEM = W * (TILE + 4) * 8 + P * (TILE + 16) * 4 + TILE * 4;
  static int sms_of[kat::MAX_DEVICES] = {};
  int sms;
  const cudaError_t err =
      kat::prepare(merge_words_tiles<W, P, B_WEIGHT>, SMEM, sms_of, &sms);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (n + TILE - 1) / TILE;
  merge_words_partition<W><<<(unsigned)((tiles + 256) / 256), 256, 0,
                             stream>>>(a, sa, na, b, sb, nb, tiles, splits);
  KAT_CHECK_LAUNCH();
  merge_words_tiles<W, P, B_WEIGHT>
      <<<(unsigned)tiles, MW_THREADS, SMEM, stream>>>(
          a, sa, ap, na, b, sb, bp, nb, splits, out, so, op);
  KAT_CHECK_LAUNCH();
  return 0;
}

int words_tile(int words) {
  switch (words) {
    case 2: return MergeWords<2>::TILE;
    case 3: case 4: return MergeWords<4>::TILE;
    default: return MergeWords<9>::TILE;
  }
}

}  // namespace

// Outputs a thread block of the merge takes.
extern "C" int kat_merge_sorted_tile() { return TILE; }

// int64 scratch words a merge of n outputs needs: the tile splits.
extern "C" int64_t kat_merge_sorted_scratch(int64_t n) {
  return tiles_for(n) + 1;
}

// out[0:na+nb) = stable merge of (a, aw) with (b, b != SENTINEL).  Outputs
// must be 16-byte aligned.
extern "C" int kat_merge_sorted(const int64_t* a, const int32_t* aw,
                                int64_t na, const int64_t* b, int64_t nb,
                                int64_t* out_keys, int32_t* out_w,
                                int64_t* scratch, void* stream_ptr) {
  const PlanesIn ap = {{aw, nullptr, nullptr}};
  const PlanesIn bp = {{nullptr, nullptr, nullptr}};
  const PlanesOut op = {{out_w, nullptr, nullptr}};
  return launch_merge<1, true>(a, ap, na, b, bp, nb, out_keys, op, scratch,
                               (cudaStream_t)stream_ptr);
}

// out[0:na+nb) = stable merge of (a, a0..a2) with (b, b0..b2), n_planes
// (1-3) int32 planes on each side; unused plane pointers may be null.
extern "C" int kat_merge_sorted_payload(
    const int64_t* a, const int32_t* a0, const int32_t* a1, const int32_t* a2,
    int64_t na, const int64_t* b, const int32_t* b0, const int32_t* b1,
    const int32_t* b2, int64_t nb, int n_planes, int64_t* out_keys,
    int32_t* o0, int32_t* o1, int32_t* o2, int64_t* scratch,
    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const PlanesIn ap = {{a0, a1, a2}};
  const PlanesIn bp = {{b0, b1, b2}};
  const PlanesOut op = {{o0, o1, o2}};
  switch (n_planes) {
    case 1:
      return launch_merge<1, false>(a, ap, na, b, bp, nb, out_keys, op,
                                    scratch, stream);
    case 2:
      return launch_merge<2, false>(a, ap, na, b, bp, nb, out_keys, op,
                                    scratch, stream);
    case 3:
      return launch_merge<3, false>(a, ap, na, b, bp, nb, out_keys, op,
                                    scratch, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Outputs a thread block of kat_merge_sorted_words takes for `words` words.
extern "C" int kat_merge_sorted_words_tile(int words) {
  return words_tile(words);
}

// int64 scratch words a W-word merge of n outputs needs: the tile splits.
extern "C" int64_t kat_merge_sorted_words_scratch(int64_t n, int words) {
  return (n + words_tile(words) - 1) / words_tile(words) + 1;
}

// out[:, 0:na+nb) = stable merge of (a, aw) with (b, b != SENTINEL) over
// `words` (2-9) key planes: plane q of a at a + q * sa, of b at b + q * sb,
// of out at out + q * so; ties take a.
extern "C" int kat_merge_sorted_words(const int64_t* a, int64_t sa,
                                      const int32_t* aw, int64_t na,
                                      const int64_t* b, int64_t sb,
                                      int64_t nb, int words, int64_t* out,
                                      int64_t so, int32_t* out_w,
                                      int64_t* scratch, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const PlanesIn ap = {{aw, nullptr, nullptr}};
  const PlanesIn bp = {{nullptr, nullptr, nullptr}};
  const PlanesOut op = {{out_w, nullptr, nullptr}};
#define KAT_MERGE_WORDS(W)                                                \
  case W:                                                                 \
    return launch_merge_words<W, 1, true>(a, sa, ap, na, b, sb, bp, nb,   \
                                          out, so, op, scratch, stream);
  switch (words) {
    KAT_MERGE_WORDS(2)
    KAT_MERGE_WORDS(3)
    KAT_MERGE_WORDS(4)
    KAT_MERGE_WORDS(5)
    KAT_MERGE_WORDS(6)
    KAT_MERGE_WORDS(7)
    KAT_MERGE_WORDS(8)
    KAT_MERGE_WORDS(9)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef KAT_MERGE_WORDS
}

// out[:, 0:na+nb) = stable merge of (a, a0..a2) with (b, b0..b2) over
// `words` (2-9) key planes (strides as kat_merge_sorted_words), n_planes
// (1-3) int32 planes on each side, o0..o2 the output planes; unused plane
// pointers may be null; ties take a.  Scratch as
// kat_merge_sorted_words_scratch.
extern "C" int kat_merge_sorted_words_payload(
    const int64_t* a, int64_t sa, const int32_t* a0, const int32_t* a1,
    const int32_t* a2, int64_t na, const int64_t* b, int64_t sb,
    const int32_t* b0, const int32_t* b1, const int32_t* b2, int64_t nb,
    int words, int n_planes, int64_t* out, int64_t so, int32_t* o0,
    int32_t* o1, int32_t* o2, int64_t* scratch, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const PlanesIn ap = {{a0, a1, a2}};
  const PlanesIn bp = {{b0, b1, b2}};
  const PlanesOut op = {{o0, o1, o2}};
  if (n_planes < 1 || n_planes > MAX_PLANES) return (int)cudaErrorInvalidValue;
#define KAT_MERGE_WORDS_P(W)                                               \
  case W:                                                                  \
    switch (n_planes) {                                                    \
      case 1:                                                              \
        return launch_merge_words<W, 1, false>(a, sa, ap, na, b, sb, bp,   \
                                               nb, out, so, op, scratch,   \
                                               stream);                    \
      case 2:                                                              \
        return launch_merge_words<W, 2, false>(a, sa, ap, na, b, sb, bp,   \
                                               nb, out, so, op, scratch,   \
                                               stream);                    \
      default:                                                             \
        return launch_merge_words<W, 3, false>(a, sa, ap, na, b, sb, bp,   \
                                               nb, out, so, op, scratch,   \
                                               stream);                    \
    }
  switch (words) {
    KAT_MERGE_WORDS_P(2)
    KAT_MERGE_WORDS_P(3)
    KAT_MERGE_WORDS_P(4)
    KAT_MERGE_WORDS_P(5)
    KAT_MERGE_WORDS_P(6)
    KAT_MERGE_WORDS_P(7)
    KAT_MERGE_WORDS_P(8)
    KAT_MERGE_WORDS_P(9)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef KAT_MERGE_WORDS_P
}

// Shared pieces of the kat_tpu_torch kernels: the key sentinel, the error
// convention of the C entry points, warp/block scans, the merge path
// search, and what a single-pass kernel's blocks share (tile counter,
// relaxed status words, decoupled look-back, the once-per-device setup).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Keys are int64 k-mers (k <= 31, so at most 62 bits); INT64_MAX marks
// invalid windows and padding and sorts after every real key.
#define KAT_SENTINEL 0x7FFFFFFFFFFFFFFFLL

// Every C entry point returns cudaGetLastError() after each launch, so a
// refused launch (bad configuration, too much shared memory) is reported
// to the Python wrapper, which raises.
#define KAT_CHECK_LAUNCH()                              \
  do {                                                  \
    cudaError_t kat_err_ = cudaGetLastError();          \
    if (kat_err_ != cudaSuccess) return (int)kat_err_;  \
  } while (0)

namespace kat {

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    T u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// Exclusive scan of one value per thread across the block (blockDim.x a
// multiple of 32).  Every thread of the block must call it; *total gets
// the block's sum.
template <typename T>
__device__ __forceinline__ T block_exclusive_scan(T v, T* total) {
  __shared__ T warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  T inc = warp_inclusive_scan(v);
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T s = lane < nw ? warp_sums[lane] : T(0);
    s = warp_inclusive_scan(s);
    if (lane < nw) warp_sums[lane] = s;
  }
  __syncthreads();
  T off = warp ? warp_sums[warp - 1] : T(0);
  *total = warp_sums[nw - 1];
  __syncthreads();  // warp_sums may be reused by the next call
  return off + inc - v;
}

// Merge path: the number of a-elements among the first `diag` outputs of
// the stable merge of sorted a[0:na) and b[0:nb) (a first on ties).
__device__ __forceinline__ int64_t merge_path(const int64_t* __restrict__ a,
                                              int64_t na,
                                              const int64_t* __restrict__ b,
                                              int64_t nb, int64_t diag) {
  int64_t lo = diag > nb ? diag - nb : 0;
  int64_t hi = diag < na ? diag : na;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] <= b[diag - 1 - mid]) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// One block scans `data` in place, carrying the running sum from chunk to
// chunk; *total (if given) gets the sum.
template <typename T>
__global__ void __launch_bounds__(1024)
scan_single_block(T* data, int64_t n, T* total) {
  __shared__ T carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  constexpr int ITEMS = 4;
  const int64_t chunk = (int64_t)blockDim.x * ITEMS;
  for (int64_t base = 0; base < n; base += chunk) {
    const int64_t first = base + (int64_t)threadIdx.x * ITEMS;
    T v[ITEMS];
    T s = 0;
#pragma unroll
    for (int e = 0; e < ITEMS; e++) {
      v[e] = first + e < n ? data[first + e] : T(0);
      s += v[e];
    }
    T tot;
    T ex = block_exclusive_scan(s, &tot) + carry;
#pragma unroll
    for (int e = 0; e < ITEMS; e++) {
      if (first + e < n) data[first + e] = ex;
      ex += v[e];
    }
    __syncthreads();  // every thread has read carry
    if (threadIdx.x == 0) carry += tot;
    __syncthreads();
  }
  if (threadIdx.x == 0 && total != nullptr) *total = carry;
}

// Element e of a 16-byte chunk of int64 (e < 2) or int32 (e < 4) values.
template <typename T>
__device__ __forceinline__ T chunk_elem(const uint4& c, int e) {
  if constexpr (sizeof(T) == 8) {
    return (T)(e == 0 ? (uint64_t)c.y << 32 | c.x
                      : (uint64_t)c.w << 32 | c.z);
  } else {
    return (T)(e == 0 ? c.x : e == 1 ? c.y : e == 2 ? c.z : c.w);
  }
}

// A block's staging of one or two ranges of T, src0[0, len0) then
// src1[0, len1), in 16-byte chunks of the aligned memory that covers each
// range: every load of the block is issued before any store, SLOTS chunks
// a thread.  A range's first chunk starts skew[q] elements before it; a
// chunk reaches at most 15 bytes past either end of its range and never
// leaves its aligned 16 bytes, so it never touches a page the range does
// not.
template <typename T, int THREADS, int SLOTS>
struct Chunks {
  static constexpr int PER = 16 / sizeof(T);
  uint4 r[SLOTS];
  int skew[2], count[2];

  __device__ __forceinline__ void load(const T* src0, int len0,
                                       const T* src1 = nullptr,
                                       int len1 = 0) {
    const T* src[2] = {src0, src1};
    const int len[2] = {len0, len1};
    const uint4* c[2];
#pragma unroll
    for (int q = 0; q < 2; q++) {
      skew[q] = (int)(((uintptr_t)src[q] & 15) / sizeof(T));
      count[q] = len[q] > 0 ? (len[q] + skew[q] + PER - 1) / PER : 0;
      c[q] = reinterpret_cast<const uint4*>((uintptr_t)src[q] &
                                            ~(uintptr_t)15);
    }
#pragma unroll
    for (int v = 0; v < SLOTS; v++) {
      const int u = v * THREADS + threadIdx.x;
      if (u < count[0]) r[v] = __ldg(c[0] + u);
      else if (u < count[0] + count[1]) r[v] = __ldg(c[1] + (u - count[0]));
    }
  }

  // Whole chunks in a row from dst (16-byte aligned): range 0's element j
  // lands at dst[skew[0] + j], range 1's at dst[first(1) + j].
  __device__ __forceinline__ int first(int q) const {
    return q == 0 ? skew[0] : count[0] * PER + skew[1];
  }
  __device__ __forceinline__ void store(T* dst) const {
#pragma unroll
    for (int v = 0; v < SLOTS; v++) {
      const int u = v * THREADS + threadIdx.x;
      if (u < count[0] + count[1])
        *reinterpret_cast<uint4*>(dst + u * PER) = r[v];
    }
  }

  // Range 0 alone, its element j to dst[slot(j)]: an aligned chunk wholly
  // in range goes as one 16-byte store (slot must keep the PER elements of
  // such a chunk contiguous and 16-byte aligned), any other element alone.
  template <class Slot>
  __device__ __forceinline__ void store(T* dst, int len, Slot slot) const {
#pragma unroll
    for (int v = 0; v < SLOTS; v++) {
      const int u = v * THREADS + threadIdx.x;
      if (u >= count[0]) continue;
      const int j0 = u * PER - skew[0];
      if (skew[0] == 0 && j0 + PER <= len) {
        *reinterpret_cast<uint4*>(dst + slot(j0)) = r[v];
        continue;
      }
#pragma unroll
      for (int e = 0; e < PER; e++)
        if (j0 + e >= 0 && j0 + e < len)
          dst[slot(j0 + e)] = chunk_elem<T>(r[v], e);
    }
  }
};

// Relaxed loads and stores at device scope: strong operations, served by
// L2 (never by a stale L1 line) and never hoisted out of a spin loop.  The
// look-backs below pass nothing between blocks but such one-word status
// values, so they need no release/acquire ordering: a reader cannot see a
// flag without the value stored beside it in the same word.
__device__ __forceinline__ uint32_t ld_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint64_t ld_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void st_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// A block's tile number from the launch's counter (thread 0 writes it to
// *s_tile; the caller synchronises before reading it).  Numbers are handed
// out in the order blocks start, so a block only ever waits for tiles that
// are already running, whatever order the hardware schedules blocks in.
__device__ __forceinline__ void take_tile(uint32_t* counter,
                                          uint32_t* s_tile) {
  if (threadIdx.x == 0) *s_tile = atomicAdd(counter, 1u);
}

// Decoupled look-back (Merrill and Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", 2016): the combined value of every tile
// below `tile`, read from their status words, which lie `stride` words
// apart below `mine`.  It stops at the first word that holds its tile's
// inclusive prefix; a word read early stays true.  Two ways to walk:
//   GROUP == 1: one thread reads DEPTH words a step (in flight together)
//     and waits on each in turn (K1: a thread per digit);
//   GROUP == 32, DEPTH == 1: a warp reads 32 words a step, waits until all
//     are published, and combines those up to the nearest prefix with a
//     shuffle tree; every lane gets the result (K3: a warp per tile).
// Status supplies:
//   Word, Value           the status word and the value carried;
//   NOTHING               a ready prefix of no tiles (below tile 0);
//   ready(w), prefix(w)   whether w is published, and as a prefix;
//   value(w)              the value w carries;
//   combine(a, b)         the value of a's tiles followed by b's;
//   shfl(v, src)          (GROUP == 32) __shfl_sync of a Value.
template <class Status, int DEPTH, int GROUP = 1>
__device__ __forceinline__ typename Status::Value look_back(
    const typename Status::Word* mine, int64_t tile, int64_t stride) {
  static_assert(GROUP == 1 || (GROUP == 32 && DEPTH == 1),
                "one thread, or one warp reading a word a lane");
  using Word = typename Status::Word;
  using Value = typename Status::Value;
  const int lane = GROUP == 1 ? 0 : (int)(threadIdx.x & 31);
  Value acc = Status::identity();
  const Word* theirs = mine;
  int64_t left = tile;  // lower tiles not yet read
  for (;;) {
    Word word[DEPTH];
#pragma unroll
    for (int b = 0; b < DEPTH; b++) {
      const int64_t d = (int64_t)b * GROUP + lane;
      word[b] = d < left ? ld_relaxed(theirs - (d + 1) * stride)
                         : Status::NOTHING;
    }
    if constexpr (GROUP == 1) {
      bool found = false;
#pragma unroll
      for (int b = 0; b < DEPTH; b++) {
        if (found) continue;
        while (!Status::ready(word[b]))
          word[b] = ld_relaxed(theirs - (b + 1) * stride);
        acc = Status::combine(Status::value(word[b]), acc);
        found = Status::prefix(word[b]);
      }
      if (found) return acc;
    } else {
      while (__any_sync(0xffffffffu, !Status::ready(word[0]))) {
        if (!Status::ready(word[0]))
          word[0] = ld_relaxed(theirs - (lane + 1) * stride);
      }
      // lane 0 holds the nearest tile; keep lanes up to the first prefix
      const unsigned prefixes =
          __ballot_sync(0xffffffffu, Status::prefix(word[0]));
      const int last = prefixes ? __ffs(prefixes) - 1 : 31;
      Value v = lane <= last ? Status::value(word[0]) : Status::identity();
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const Value u = Status::shfl(v, min(lane + d, 31));  // farther
        if (lane + d < 32) v = Status::combine(u, v);
      }
      acc = Status::combine(Status::shfl(v, 0), acc);
      if (prefixes) return acc;
    }
    theirs -= (int64_t)DEPTH * GROUP * stride;
    left -= (int64_t)DEPTH * GROUP;
  }
}

// The same look-back walked by a whole block of NW warps: each warp reads
// 32 status words a step, so that one round trip covers NW * 32 tiles (a
// warp alone covers 32, and once the look-back sets the pace the tiles
// finish at most 32 a round trip).  Each warp waits until its words are
// published and combines those up to its nearest prefix; every thread then
// combines the warps', nearest first, up to the first warp that met a
// prefix.  Every thread of the block must call it and gets the result;
// s_val and s_found are NW-long shared scratch.
template <class Status, int NW>
__device__ __forceinline__ typename Status::Value look_back_block(
    const typename Status::Word* mine, int64_t tile,
    typename Status::Value* s_val, int* s_found) {
  using Word = typename Status::Word;
  using Value = typename Status::Value;
  const int lane = (int)(threadIdx.x & 31);
  const int warp = (int)(threadIdx.x >> 5);
  Value acc = Status::identity();
  for (int64_t base = 0;; base += NW * 32) {
    const int64_t d = base + warp * 32 + lane;  // reads tile - 1 - d
    Word word = d < tile ? ld_relaxed(mine - (d + 1)) : Status::NOTHING;
    while (__any_sync(0xffffffffu, !Status::ready(word))) {
      if (!Status::ready(word)) word = ld_relaxed(mine - (d + 1));
    }
    const unsigned prefixes =
        __ballot_sync(0xffffffffu, Status::prefix(word));
    const int last = prefixes ? __ffs(prefixes) - 1 : 31;
    Value v = lane <= last ? Status::value(word) : Status::identity();
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const Value u = Status::shfl(v, min(lane + s, 31));  // farther
      if (lane + s < 32) v = Status::combine(u, v);
    }
    if (lane == 0) {
      s_val[warp] = v;
      s_found[warp] = prefixes != 0;
    }
    __syncthreads();
    Value r = Status::identity();
    bool found = false;
#pragma unroll
    for (int w = 0; w < NW; w++) {
      if (found) continue;
      r = Status::combine(s_val[w], r);
      found = s_found[w] != 0;
    }
    __syncthreads();  // every thread has read the scratch
    acc = Status::combine(r, acc);
    if (found) return acc;
  }
}

// Division by a run-time divisor d as a multiply-high and a shift: the
// host computes m = ceil(2^(31 + l) / d), l = ceil(log2 d), and then
// x / d == umulhi(x, m) >> (l - 1) for every x < 2^31 (Granlund and
// Montgomery 1994, theorem 4.2: m * d - 2^(31 + l) < d <= 2^l); d == 1
// gives *mul = 0, which div_by takes as no division.
inline void magic(uint32_t d, uint32_t* mul, int* sh) {
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

__device__ __forceinline__ uint32_t div_by(uint32_t x, uint32_t mul,
                                           int sh) {
  return mul ? __umulhi(x, mul) >> sh : x;
}

// What a launcher asks of the current device once per kernel, not per
// call: the device's SM count, after leave for `kernel` to take `smem`
// bytes of dynamic shared memory there.  `cache` is the launcher's own
// table (0: not asked yet; two threads that both ask write the same
// answer).
constexpr int MAX_DEVICES = 64;

template <typename Kernel>
inline cudaError_t prepare(Kernel kernel, int smem, int* cache, int* sms) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cache[device] == 0) {
    int n;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    cache[device] = n;
  }
  *sms = cache[device];
  return cudaSuccess;
}

}  // namespace kat

// K5: independent ascending sort of every aligned chunk of int64 keys.
//
// Replaces kat_tpu/ops/sort_kernel.py::_window_kernel in chunk mode (reached
// through bitonic_sort_chunks, sort_kernel.py:512), the per-chunk sort of
// the minimizer-bucketed counting flush (kat_tpu/core/bucketed.py:134,192).
// What is carried over from the TPU kernel is its point, not its network: a
// chunk fits in on-chip memory, so the whole sort costs ONE read and ONE
// write of device memory.  One thread block holds a tile of up to 2^14
// int64 keys (one chunk of 2^14, or several smaller chunks) in its shared
// memory (128 KB, above the 48 KB a block gets without asking, so the limit
// is raised once per device).
//
// What bounds it on the H100: by bytes, 16 B per key once (0.16 ms for the
// bucketed flush's 2048 chunks of 2^14 keys).  The bitonic network this
// replaced (benchmarks/earlier/chunk_sort_bitonic.cu) did O(n log^2 n)
// compare-exchanges, 105 rounds at 2^14 keys, each a 64-bit compare and two
// 64-bit selects, and read its chunk before sorting it, so an SM read
// nothing while it sorted.  This is a merge sort, O(n log n):
//   - persistent blocks, one a tile of 2^14 keys an SM; while a block sorts
//     a tile it asks L2 for its next one (one 128-byte prefetch a thread),
//     so that load is served from L2;
//   - each of the tile's 1024 threads loads its 16 keys with all 16 loads
//     in flight together, striped over its chunk so that a warp's loads
//     are coalesced (a chunk's order does not matter to its sort);
//   - the chunk's SENTINELs (INT64_MAX, the flush's empty slots: ~30%) are
//     counted and dropped: a block scan of each thread's real keys packs
//     them to the front of the chunk in shared memory and fills the tail
//     with SENTINEL, and threads whose 16 slots lie in that tail sit out
//     every later step;
//   - each live thread sorts its 16 slots in registers (a bitonic network
//     of 80 compare-exchanges, no memory traffic);
//   - merge-path levels in shared memory then double the sorted runs up to
//     the chunk, 10 levels at 2^14 keys: each live thread finds where its
//     16 outputs start in the two runs by a binary search (the merge path;
//     ties go to the left run) and merges them serially, one key read and
//     one compare an output; the 5 levels whose run pairs lie inside one
//     warp's 512 keys wait on the warp, not the block;
//   - runs live in shared memory with every 16-byte pair of keys XOR-
//     swizzled inside its 128 bytes, so that a thread's 16-byte stores of
//     its run and a warp's reads of consecutive keys are free of bank
//     conflicts;
//   - the sorted tile leaves with coalesced 8-byte stores.
// The merge levels take ~60% of the time at 2^14 keys, bound by their
// instructions and dependent shared-memory reads: reads free of bank
// conflicts save ~5% (PERF.md).
// Keys compare as SIGNED int64: the sentinel INT64_MAX ends up at each
// chunk's tail, and the bit-63-flipped key' form of k = 29
// (kat_tpu_torch/core/minimizer.py) orders as kat_tpu's unsigned planes do.
// Equal keys are indistinguishable, so stability is moot.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int CS_ITEMS = 16;        // keys a thread
constexpr int CS_MIN_LOG = 5;       // chunks of 2^5 .. 2^14 keys
constexpr int CS_MAX_LOG = 14;
constexpr int CS_MIN_TILE_LOG = 9;  // a tile is at least one warp's keys

// Key i of the tile lies at s[swz(i)]: the 16-byte pair i / 2 XORed with
// bits 4-6 of i inside its 128-byte line.
__device__ __forceinline__ int swz(int i) { return i ^ (((i >> 4) & 7) << 1); }

__device__ __forceinline__ void cmpx(int64_t& a, int64_t& b) {
  const bool sw = a > b;
  const int64_t lo = sw ? b : a;
  const int64_t hi = sw ? a : b;
  a = lo;
  b = hi;
}

// Ascending bitonic sort of v in registers.
__device__ __forceinline__ void sort_items(int64_t (&v)[CS_ITEMS]) {
#pragma unroll
  for (int k = 2; k <= CS_ITEMS; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < CS_ITEMS; i++) {
        const int l = i ^ j;
        if (l > i) {
          if ((i & k) == 0) cmpx(v[i], v[l]);
          else cmpx(v[l], v[i]);
        }
      }
    }
  }
}

// The thread's run, keys [16t, 16t + 16) of the tile, as 16-byte stores.
__device__ __forceinline__ void store_run(int64_t* s, int t,
                                          const int64_t (&v)[CS_ITEMS]) {
#pragma unroll
  for (int u = 0; u < CS_ITEMS / 2; u++) {
    longlong2 pair;
    pair.x = v[2 * u];
    pair.y = v[2 * u + 1];
    *reinterpret_cast<longlong2*>(s + swz(CS_ITEMS * t + 2 * u)) = pair;
  }
}

__device__ __forceinline__ void load_run(const int64_t* s, int t,
                                         int64_t (&v)[CS_ITEMS]) {
#pragma unroll
  for (int u = 0; u < CS_ITEMS / 2; u++) {
    const longlong2 pair =
        *reinterpret_cast<const longlong2*>(s + swz(CS_ITEMS * t + 2 * u));
    v[2 * u] = pair.x;
    v[2 * u + 1] = pair.y;
  }
}

__global__ void __launch_bounds__(1024, 1)
chunk_sort_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                  int64_t n, int log_c, int log_tile, int64_t n_tiles) {
  extern __shared__ __align__(16) int64_t s[];
  int* s_pref = reinterpret_cast<int*>(s + (1 << log_tile));  // [T + 1]
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int c_threads = 1 << (log_c - 4);  // a chunk's threads
  const int ct0 = t & ~(c_threads - 1);    // the chunk's first thread
  const int cbase = ct0 * CS_ITEMS;        // the chunk's first slot
  const int mine = CS_ITEMS * t - cbase;   // my first slot in the chunk
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t base = tile << log_tile;
    const int64_t next = base + ((int64_t)gridDim.x << log_tile) +
                         (int64_t)CS_ITEMS * t;
    if (next < n)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(in + next));
    // the thread's 16 keys, striped over its chunk; past n, SENTINEL (the
    // tile's padding, a whole number of chunks, never written back)
    int64_t v[CS_ITEMS];
    int n_real = 0;
#pragma unroll
    for (int k = 0; k < CS_ITEMS; k++) {
      const int64_t i = base + cbase + (t & (c_threads - 1)) +
                        (int64_t)k * c_threads;
      v[k] = i < n ? __ldg(in + i) : KAT_SENTINEL;
      n_real += v[k] != KAT_SENTINEL;
    }
    // the chunk's real keys to its front, SENTINEL behind them
    int total;
    const int before = kat::block_exclusive_scan(n_real, &total);
    s_pref[t] = before;
    if (t == T - 1) s_pref[T] = total;
    __syncthreads();
    const int real_c = s_pref[ct0 + c_threads] - s_pref[ct0];
    int pos = cbase + before - s_pref[ct0];
#pragma unroll
    for (int k = 0; k < CS_ITEMS; k++)
      if (v[k] != KAT_SENTINEL) s[swz(pos++)] = v[k];
#pragma unroll
    for (int j = 0; j < CS_ITEMS; j++)
      if (mine + j >= real_c) s[swz(CS_ITEMS * t + j)] = KAT_SENTINEL;
    __syncthreads();
    const bool live = mine < real_c;  // my slots hold a real key
    if (live) {
      load_run(s, t, v);
      sort_items(v);
      store_run(s, t, v);
    }
    __syncthreads();

    const int c_elems = 1 << log_c;
    for (int run = CS_ITEMS; run < c_elems; run <<= 1) {
      if (live) {
        const int d0 = CS_ITEMS * t;
        const int a0 = d0 & ~(2 * run - 1);  // left run; the right at +run
        const int b0 = a0 + run;
        const int diag = d0 - a0;
        int lo = diag > run ? diag - run : 0;
        int hi = diag < run ? diag : run;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s[swz(a0 + mid)] <= s[swz(b0 + diag - 1 - mid)]) lo = mid + 1;
          else hi = mid;
        }
        int ia = a0 + lo, ib = b0 + diag - lo;
        const int ea = b0, eb = b0 + run;
        int64_t ka = s[swz(min(ia, ea - 1))];
        int64_t kb = s[swz(min(ib, eb - 1))];
#pragma unroll
        for (int j = 0; j < CS_ITEMS; j++) {
          const bool take_a = ib >= eb || (ia < ea && ka <= kb);
          v[j] = take_a ? ka : kb;
          const int64_t x =
              s[swz(take_a ? min(ia + 1, ea - 1) : min(ib + 1, eb - 1))];
          if (take_a) {
            ia++;
            ka = x;
          } else {
            ib++;
            kb = x;
          }
        }
      }
      // every thread has read the level's runs, then stored its outputs
      // before the next level reads them; where those run pairs lie
      // inside one warp's 512 keys, the warp alone waits
      if (2 * run <= 32 * CS_ITEMS) __syncwarp();
      else __syncthreads();
      if (live) store_run(s, t, v);
      if (4 * run <= 32 * CS_ITEMS) __syncwarp();
      else __syncthreads();
    }
    __syncthreads();

    for (int i = t; i < T * CS_ITEMS; i += T) {
      const int64_t g = base + i;
      if (g < n) out[g] = s[swz(i)];
    }
    __syncthreads();  // before the next tile overwrites s and s_pref
  }
}

}  // namespace

// Sort each of the n_chunks aligned spans of 2^log_c keys of in[] ascending
// into out[], another buffer.  5 <= log_c <= 14.  A block sorts tiles of
// 2^14 keys (fewer for a shorter input, but at least one chunk and one
// warp's 512 keys), 16 keys a thread; as many blocks as the SMs hold.
extern "C" int kat_sort_chunks(const int64_t* in, int64_t* out,
                               int64_t n_chunks, int log_c,
                               void* stream_ptr) {
  if (log_c < CS_MIN_LOG || log_c > CS_MAX_LOG || n_chunks < 0 ||
      n_chunks >= (int64_t{1} << 31))
    return (int)cudaErrorInvalidValue;
  constexpr int max_smem = (8 << CS_MAX_LOG) + 4 * ((1 << CS_MAX_LOG) /
                                                    CS_ITEMS + 4);
  static int sms_of[kat::MAX_DEVICES] = {};
  int sms;
  cudaError_t err = kat::prepare(chunk_sort_kernel, max_smem, sms_of, &sms);
  if (err != cudaSuccess) return (int)err;
  if (n_chunks == 0) return 0;
  const int64_t n = n_chunks << log_c;
  int log_n = 0;
  while ((int64_t{1} << log_n) < n) log_n++;
  int log_tile = log_n < CS_MAX_LOG ? log_n : CS_MAX_LOG;
  if (log_tile < log_c) log_tile = log_c;
  if (log_tile < CS_MIN_TILE_LOG) log_tile = CS_MIN_TILE_LOG;
  const int threads = 1 << (log_tile - 4);
  const int smem = (8 << log_tile) + 4 * (threads + 4);
  const int64_t n_tiles = (n + (int64_t{1} << log_tile) - 1) >> log_tile;
  int per_sm = 1;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, chunk_sort_kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t grid =
      std::min<int64_t>(n_tiles, (int64_t)sms * std::max(per_sm, 1));
  chunk_sort_kernel<<<(unsigned)grid, threads, smem,
                      (cudaStream_t)stream_ptr>>>(in, out, n, log_c,
                                                  log_tile, n_tiles);
  KAT_CHECK_LAUNCH();
  return 0;
}

// K5 before its redesign (csrc/chunk_sort.cu's first design): a bitonic
// network in shared memory, one chunk a block.  Kept only so that
// chip_smoke.py can time the merge sort against it on the same card; the
// port never calls it.  Its design notes are below, as they were.
//
// K5: independent ascending sort of every aligned chunk of int64 keys.
//
// Replaces kat_tpu/ops/sort_kernel.py::_window_kernel in chunk mode (reached
// through bitonic_sort_chunks), the per-chunk sort of the minimizer-bucketed
// counting flush (kat_tpu/core/bucketed.py:134,192).  What is carried over
// from the TPU kernel is its point, not its blocks: a chunk fits in on-chip
// memory, so the whole sort costs ONE read and ONE write of device memory.
// The TPU held a 2^16-2^17 slot chunk in VMEM; here one thread block holds
// a chunk of up to 2^14 int64 keys in its shared memory (128 KB, above the
// 48 KB a block gets without asking, so the limit is raised per launch).
//
// What bounds it on the H100: by bytes, 16 B per slot once.  In practice
// the compare-exchange rounds inside the block: a bitonic network over
// 2^c keys has c(c+1)/2 rounds (105 at c = 14).  The design keeps the trips
// through shared memory few:
//   - rounds whose stride is below 32 run inside a warp with
//     __shfl_xor_sync on a key held in a register (lane = index mod 32), so
//     phases 1-5 and the last five rounds of every later phase cost one
//     shared-memory read and write together;
//   - rounds with larger strides are taken up to three at a time: a thread
//     loads the 8 keys that differ in three consecutive stride bits, runs
//     the three rounds in registers, and stores them.  Strides >= 32 keep a
//     warp's 8-byte accesses on consecutive addresses, free of bank
//     conflicts.
// At c = 14 that is 28 trips through shared memory instead of 105.
//
// Keys compare as SIGNED int64: the sentinel INT64_MAX ends up at each
// chunk's tail, and the bit-63-flipped key' form of k = 29
// (kat_tpu_torch/core/minimizer.py) orders as kat_tpu's unsigned planes do.
// Equal keys are indistinguishable, so the network's instability is moot.

#include "common.cuh"

namespace {

constexpr int CS_MAX_THREADS = 1024;
constexpr int CS_MIN_LOG = 5;   // a chunk is at least one warp wide
constexpr int CS_MAX_LOG = 14;  // 2^14 keys = 128 KB of shared memory

__device__ __forceinline__ void cmpx(int64_t& a, int64_t& b, bool asc) {
  const bool sw = (a > b) == asc;
  const int64_t lo = sw ? b : a;
  const int64_t hi = sw ? a : b;
  a = lo;
  b = hi;
}

// The rounds of phase `phase` with strides 2^top .. 1 (top <= 4) on the
// key of element i, held by lane i mod 32.
__device__ __forceinline__ int64_t warp_rounds(int64_t v, int i, int phase,
                                               int top) {
  const bool asc = ((i >> phase) & 1) == 0;
  for (int r = top; r >= 0; --r) {
    const int64_t o = __shfl_xor_sync(0xffffffffu, v, 1 << r);
    const bool lower = ((i >> r) & 1) == 0;
    v = (lower == asc) ? min(v, o) : max(v, o);
  }
  return v;
}

// R rounds of phase `phase` with strides 2^(low+R-1) .. 2^low, in
// registers: each thread owns the 2^R keys that differ in those bits.
template <int R>
__device__ __forceinline__ void reg_rounds(int64_t* s, int c_elems,
                                           int phase, int low) {
  constexpr int Q = 1 << R;
  for (int i = threadIdx.x; i < (c_elems >> R); i += blockDim.x) {
    const int base = ((i >> low) << (low + R)) | (i & ((1 << low) - 1));
    const bool asc = ((base >> phase) & 1) == 0;
    int64_t v[Q];
#pragma unroll
    for (int q = 0; q < Q; q++) v[q] = s[base + (q << low)];
#pragma unroll
    for (int r = R - 1; r >= 0; --r) {
#pragma unroll
      for (int q = 0; q < Q; q++) {
        if (!(q & (1 << r))) cmpx(v[q], v[q | (1 << r)], asc);
      }
    }
#pragma unroll
    for (int q = 0; q < Q; q++) s[base + (q << low)] = v[q];
  }
}

__global__ void __launch_bounds__(CS_MAX_THREADS)
chunk_sort_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                  int log_c) {
  extern __shared__ int64_t s[];
  const int c_elems = 1 << log_c;
  const int64_t base = (int64_t)blockIdx.x * c_elems;
  const int first = log_c < 5 ? log_c : 5;

  // load; phases 1..5 never leave the warp
  for (int i = threadIdx.x; i < c_elems; i += blockDim.x) {
    int64_t v = in[base + i];
    for (int p = 1; p <= first; p++) v = warp_rounds(v, i, p, p - 1);
    if (log_c <= 5) out[base + i] = v;
    else s[i] = v;
  }
  if (log_c <= 5) return;
  __syncthreads();

  for (int p = 6; p <= log_c; p++) {
    int b = p;  // stride bits [5, b) are still to do
    while (b > 5) {
      const int r = b - 5 < 3 ? b - 5 : 3;
      if (r == 3) reg_rounds<3>(s, c_elems, p, b - 3);
      else if (r == 2) reg_rounds<2>(s, c_elems, p, b - 2);
      else reg_rounds<1>(s, c_elems, p, b - 1);
      b -= r;
      __syncthreads();
    }
    // strides 16..1; the last phase stores straight to device memory
    for (int i = threadIdx.x; i < c_elems; i += blockDim.x) {
      const int64_t v = warp_rounds(s[i], i, p, 4);
      if (p == log_c) out[base + i] = v;
      else s[i] = v;
    }
    __syncthreads();
  }
}

}  // namespace

// Sort each of the n_chunks aligned spans of 2^log_c keys of in[] ascending
// into out[], another buffer.  5 <= log_c <= 14.  Threads per block: 1/32 of
// the chunk, which measured fastest on the H100 at 2^12 and 2^13 keys
// (several blocks share an SM and overlap their loads with another's
// rounds); a 2^14-key chunk has its SM to itself and takes 1024.
extern "C" int kat_earlier_sort_chunks(const int64_t* in, int64_t* out,
                                       int64_t n_chunks, int log_c,
                                       void* stream_ptr) {
  if (log_c < CS_MIN_LOG || log_c > CS_MAX_LOG || n_chunks < 0 ||
      n_chunks >= (int64_t{1} << 31))
    return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return 0;
  const int c_elems = 1 << log_c;
  int threads = log_c == CS_MAX_LOG ? CS_MAX_THREADS : c_elems / 32;
  threads = threads < 32 ? 32 : threads;
  const size_t smem = log_c > 5 ? sizeof(int64_t) * (size_t)c_elems : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chunk_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  chunk_sort_kernel<<<(unsigned)n_chunks, threads, smem,
                      (cudaStream_t)stream_ptr>>>(in, out, log_c);
  KAT_CHECK_LAUNCH();
  return 0;
}

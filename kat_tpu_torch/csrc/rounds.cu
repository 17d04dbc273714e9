// K7: the cost of one compare-exchange round, by the way the partner is
// reached.
//
// Replaces benchmarks/profile_roll.py::_kernel, which timed R rounds on a
// tile resident in the TPU's VMEM to price the rounds of its sort kernel
// (lane rolls, row rolls, row-pair selects, ALU only, copy only).  Here the
// rounds are those that K5's chunk sort (csrc/chunk_sort.cu) is built from:
// a block loads a tile of 2048 int64 keys ONCE (two per thread, elements t
// and t + 1024), runs R rounds, and stores once, so the difference between
// two modes at the same R is the rounds' cost alone.
//
//   copy       +1 per round: the floor (load, loop, store)
//   alu        compare and select between the thread's own two keys
//              (stride 1024 without any movement)
//   shfl-s     partner i ^ s through __shfl_xor_sync, s < 32
//   smem-s     partner i ^ s through shared memory: store, barrier, load,
//              barrier, s < 2048
//
// A round is a bitonic one: the element whose stride bit is clear keeps the
// smaller key when its direction is ascending, else the larger.  The
// direction of round r is bit (log2(s) + 1) of the global index XOR the low
// bit of r, so both partners agree on it and it alternates from round to
// round (the data keeps moving and nothing can be hoisted).  The output is
// deterministic, and a plain PyTorch version holds it exactly
// (kat_tpu_torch/benchmarks/profile_rounds.py).
//
// What bounds it: by construction not memory (16 B per key once, whatever
// R), but the throughput of the round's instructions: two 32-bit shuffles
// per key for shfl, 16 B of shared-memory traffic and two barriers for smem.

#include "common.cuh"

namespace {

constexpr int PR_THREADS = 1024;
constexpr int PR_TILE = 2 * PR_THREADS;

enum Mode { COPY = 0, ALU = 1, SHFL = 2, SMEM = 3 };

__device__ __forceinline__ int64_t keep(int64_t v, int64_t o, bool lower,
                                        bool asc) {
  return (lower == asc) ? min(v, o) : max(v, o);
}

template <int MODE>
__global__ void __launch_bounds__(PR_THREADS)
rounds_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
              int stride_log, int rounds) {
  __shared__ int64_t s[MODE == SMEM ? PR_TILE : 1];
  const int e0 = threadIdx.x, e1 = threadIdx.x + PR_THREADS;
  const int64_t g0 = (int64_t)blockIdx.x * PR_TILE + e0;
  const int64_t g1 = g0 + PR_THREADS;
  int64_t v0 = in[g0], v1 = in[g1];
  const int stride = 1 << stride_log;
  const int d0 = (int)(g0 >> (stride_log + 1)) & 1;
  const int d1 = (int)(g1 >> (stride_log + 1)) & 1;
  const bool low0 = ((e0 >> stride_log) & 1) == 0;
  const bool low1 = ((e1 >> stride_log) & 1) == 0;
  for (int r = 0; r < rounds; r++) {
    const bool asc0 = ((d0 ^ r) & 1) == 0;
    const bool asc1 = ((d1 ^ r) & 1) == 0;
    if constexpr (MODE == COPY) {
      v0 += 1;
      v1 += 1;
    } else if constexpr (MODE == ALU) {
      // stride_log == 10: e0 is the lower element, e1 its partner
      const int64_t a = keep(v0, v1, true, asc0);
      v1 = keep(v1, v0, false, asc1);
      v0 = a;
    } else if constexpr (MODE == SHFL) {
      v0 = keep(v0, __shfl_xor_sync(0xffffffffu, v0, stride), low0, asc0);
      v1 = keep(v1, __shfl_xor_sync(0xffffffffu, v1, stride), low1, asc1);
    } else {
      s[e0] = v0;
      s[e1] = v1;
      __syncthreads();
      const int64_t o0 = s[e0 ^ stride], o1 = s[e1 ^ stride];
      __syncthreads();
      v0 = keep(v0, o0, low0, asc0);
      v1 = keep(v1, o1, low1, asc1);
    }
  }
  out[g0] = v0;
  out[g1] = v1;
}

}  // namespace

// out[0:n) = in[0:n) after `rounds` rounds of `mode` (0 copy, 1 alu, 2 shfl,
// 3 smem) at stride 2^stride_log, tile by tile of 2048 keys; n must be a
// multiple of 2048.  alu takes stride_log 10, shfl 0..4, smem 0..10.
extern "C" int kat_profile_rounds(const int64_t* in, int64_t* out, int64_t n,
                                  int mode, int stride_log, int rounds,
                                  void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n < 0 || n % PR_TILE || rounds < 0 || n / PR_TILE >= (int64_t{1} << 31))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)(n / PR_TILE);
  switch (mode) {
    case COPY:
      rounds_kernel<COPY><<<blocks, PR_THREADS, 0, stream>>>(in, out, 0,
                                                             rounds);
      break;
    case ALU:
      if (stride_log != 10) return (int)cudaErrorInvalidValue;
      rounds_kernel<ALU><<<blocks, PR_THREADS, 0, stream>>>(in, out, 10,
                                                            rounds);
      break;
    case SHFL:
      if (stride_log < 0 || stride_log > 4) return (int)cudaErrorInvalidValue;
      rounds_kernel<SHFL><<<blocks, PR_THREADS, 0, stream>>>(
          in, out, stride_log, rounds);
      break;
    case SMEM:
      if (stride_log < 0 || stride_log > 10)
        return (int)cudaErrorInvalidValue;
      rounds_kernel<SMEM><<<blocks, PR_THREADS, 0, stream>>>(
          in, out, stride_log, rounds);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  KAT_CHECK_LAUNCH();
  return 0;
}

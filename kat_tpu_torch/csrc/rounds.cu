// K7: R compare-exchange rounds at one fixed stride, the ALU round, and
// the copy floor.
//
// Replaces benchmarks/profile_roll.py::_kernel, which times R rounds of one
// class on two uint32 planes (h, lo) held in a TPU's VMEM: the key (h, lo)
// is compared lexicographically and unsigned.  Here each element is one
// int64 key ((h << 32) | lo) ^ (1 << 63), so signed order is that order.
// The function, for element i of n:
//
//   cmpx   partner i ^ S; the pair's lower index a = i & ~S fixes the
//          direction d = (a >> 3) & 1 (profile_roll.py's dmi); the pair
//          swaps when (key[a + S] < key[a]) XOR d.  Every lane-s, row-s and
//          rowsel-s class is this at S = s or 128 s.
//   alu    an element swaps its own two 32-bit halves h and lo when
//          (lo, h) < (h, lo) XOR d(i).
//   copy   each 32-bit half plus 1 (mod 2^32), every round.
//
// The TPU needs lane and row rolls because a VMEM tile cannot hold a pair
// in one register.  Here the layout decides where a pair lives: the pairs
// never change from round to round, so each thread owns PR_PAIRS pairs
// for the whole launch, loads them once (a warp's lower keys and its upper
// keys are each one contiguous 256-byte run; at S = 1 a pair is one 16-byte
// load), runs all R rounds in registers with no shared memory, shuffle or
// barrier, and stores once.  The direction is applied once, before the
// loop, by holding a descending pair in swapped order.
//
// What bounds it: the integer instructions of a round (six a pair: two
// 32-bit compares for the 64-bit key, two selects, two xors),
// not memory: 16 bytes a key whatever R.  A round at a fixed stride and
// direction is idempotent and R adds fold into one, so `opaque` keeps the
// compiler from merging rounds: every one of the R rounds is executed, as
// K7 times them.

#include "common.cuh"

namespace {

// benchmarks/profile_rounds.py reads these three (its SASS check and its
// build variants)
constexpr int PR_THREADS = 256;
constexpr int PR_PAIRS = 4;  // pairs a thread
constexpr int PR_UNROLL = 4;  // rounds an iteration of the round loop
constexpr uint32_t TOP = 0x80000000u;

enum Kind { COPY = 0, ALU = 1, CMPX = 2 };

// An empty asm that "changes" v: the compiler can no longer prove that a
// round repeats the one before it.  It emits no instruction.
__device__ __forceinline__ void opaque(int64_t& v) {
  asm volatile("" : "+l"(v));
}

// x, y = min, max.  A swap keeps x ^ y, so the max is min ^ t, t = x ^ y
// fixed for the launch: one compare and one select for the min (2 ISETP +
// 2 SEL), one xor for the max (2 LOP3).  Written with two selects, in C or
// in PTX, the compiler forms min and max apart, each with its own compare
// (8 instructions).  The output is early-clobber: it must not share a
// register with an input.
__device__ __forceinline__ void cmpx(int64_t& x, int64_t& y, int64_t t) {
  int64_t lo;
  asm("{\n\t.reg .pred s;\n\t"
      "setp.lt.s64 s, %2, %1;\n\t"
      "selp.b64 %0, %2, %1, s;\n\t}"
      : "=&l"(lo)
      : "l"(x), "l"(y));
  x = lo;
  y = lo ^ t;
}

// Each 32-bit half plus 1 (2 IADD); in C the compiler forms a 64-bit add
// with the carry taken out (3).
__device__ __forceinline__ int64_t add_halves(int64_t v) {
  asm("{\n\t.reg .b32 l, h;\n\t"
      "mov.b64 {l, h}, %0;\n\t"
      "add.u32 l, l, 1;\n\t"
      "add.u32 h, h, 1;\n\t"
      "mov.b64 %0, {l, h};\n\t}"
      : "+l"(v));
  return v;
}

// The key with its halves swapped: (h, lo) -> (lo, h) in the flipped form.
__device__ __forceinline__ int64_t alu_round(int64_t k, bool d) {
  const uint32_t kh = (uint32_t)((uint64_t)k >> 32), kl = (uint32_t)k;
  const int64_t sw = (int64_t)(((uint64_t)(kl ^ TOP) << 32) | (kh ^ TOP));
  return ((sw < k) != d) ? sw : k;
}

template <int KIND>
__device__ __forceinline__ void round_all(int64_t (&x)[PR_PAIRS],
                                          int64_t (&y)[PR_PAIRS],
                                          const int64_t (&t)[PR_PAIRS],
                                          const bool (&d)[PR_PAIRS]) {
#pragma unroll
  for (int j = 0; j < PR_PAIRS; j++) {
    if constexpr (KIND == CMPX) {
      cmpx(x[j], y[j], t[j]);
    } else if constexpr (KIND == ALU) {
      x[j] = alu_round(x[j], d[j]);
      y[j] = alu_round(y[j], d[j]);
    } else {
      x[j] = add_halves(x[j]);
      y[j] = add_halves(y[j]);
    }
    opaque(x[j]);
    opaque(y[j]);
  }
}

// Pair p of n_pairs: lower index a = p with a 0 bit inserted at log2(S),
// upper a + S.  ADJ (S = 1) loads the pair as one 16-byte vector.
template <int KIND, bool ADJ>
__global__ void __launch_bounds__(PR_THREADS)
rounds_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
              int64_t n_pairs, int stride_log, int rounds) {
  const int64_t stride = int64_t{1} << stride_log;
  const int64_t p0 = (int64_t)blockIdx.x * (PR_THREADS * PR_PAIRS) +
                     threadIdx.x;
  int64_t x[PR_PAIRS], y[PR_PAIRS], t[PR_PAIRS], a[PR_PAIRS];
  bool d[PR_PAIRS];
#pragma unroll
  for (int j = 0; j < PR_PAIRS; j++) {
    const int64_t p = p0 + (int64_t)j * PR_THREADS;
    a[j] = ((p >> stride_log) << (stride_log + 1)) | (p & (stride - 1));
    d[j] = (a[j] >> 3) & 1;
    x[j] = y[j] = 0;
    if (p < n_pairs) {
      if constexpr (ADJ) {
        const longlong2 v = reinterpret_cast<const longlong2*>(in)[p];
        x[j] = v.x;
        y[j] = v.y;
      } else {
        x[j] = in[a[j]];
        y[j] = in[a[j] + stride];
      }
    }
    if (KIND == CMPX && d[j]) {  // descending: the larger key goes low
      const int64_t u = x[j];
      x[j] = y[j];
      y[j] = u;
    }
    t[j] = x[j] ^ y[j];
  }
  // copy runs one round an iteration: the assembler adds up the +1s of an
  // unrolled body, which `opaque` cannot stop (it acts before PTX)
  constexpr int unroll = KIND == COPY ? 1 : PR_UNROLL;
  int r = 0;
#pragma unroll 1
  for (; r + unroll <= rounds; r += unroll) {
#pragma unroll
    for (int u = 0; u < unroll; u++) round_all<KIND>(x, y, t, d);
  }
#pragma unroll 1
  for (; r < rounds; r++) round_all<KIND>(x, y, t, d);
#pragma unroll
  for (int j = 0; j < PR_PAIRS; j++) {
    const int64_t p = p0 + (int64_t)j * PR_THREADS;
    if (p >= n_pairs) continue;
    int64_t lo = x[j], hi = y[j];
    if (KIND == CMPX && d[j]) {
      lo = y[j];
      hi = x[j];
    }
    if constexpr (ADJ) {
      reinterpret_cast<longlong2*>(out)[p] = make_longlong2(lo, hi);
    } else {
      out[a[j]] = lo;
      out[a[j] + stride] = hi;
    }
  }
}

template <int KIND, bool ADJ>
void launch(const int64_t* in, int64_t* out, int64_t n, int stride_log,
            int rounds, cudaStream_t stream) {
  const int64_t n_pairs = n / 2;
  const int64_t per_block = (int64_t)PR_THREADS * PR_PAIRS;
  const unsigned blocks = (unsigned)((n_pairs + per_block - 1) / per_block);
  rounds_kernel<KIND, ADJ><<<blocks, PR_THREADS, 0, stream>>>(
      in, out, n_pairs, stride_log, rounds);
}

}  // namespace

// out[0:n) = in[0:n) after `rounds` rounds of `kind` (0 copy, 1 alu, 2
// compare-exchange at partner i ^ stride).  stride is a power of two; n is
// even, and for kind 2 a multiple of 2 * stride; copy and alu take
// stride 1.  in and out are 16-byte aligned and do not overlap.
extern "C" int kat_profile_rounds(const int64_t* in, int64_t* out, int64_t n,
                                  int64_t stride, int kind, int rounds,
                                  void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n < 0 || n % 2 || rounds < 0 || stride < 1 || (stride & (stride - 1)) ||
      n % (2 * stride) || (kind != CMPX && stride != 1) ||
      n / 2 / ((int64_t)PR_THREADS * PR_PAIRS) >= (int64_t{1} << 31) ||
      ((uintptr_t)in | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int stride_log = 0;
  while ((int64_t{1} << stride_log) < stride) stride_log++;
  switch (kind) {
    case COPY:
      launch<COPY, true>(in, out, n, 0, rounds, stream);
      break;
    case ALU:
      launch<ALU, true>(in, out, n, 0, rounds, stream);
      break;
    case CMPX:
      if (stride == 1)
        launch<CMPX, true>(in, out, n, 0, rounds, stream);
      else
        launch<CMPX, false>(in, out, n, stride_log, rounds, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  KAT_CHECK_LAUNCH();
  return 0;
}

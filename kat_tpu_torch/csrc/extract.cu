// Narrow k-mer extraction (k <= 31): every k-window of a [rows, L] batch
// of uint8 base codes as its int64 key, in one pass.
//
// Replaces no TPU kernel: kat_tpu extracts with jnp in
// kat_tpu/core/kmers.py::extract_kmers, which XLA fuses on the TPU.  It
// was added because the port's plain form of the same function
// (core/kmers.extract_keys_plain) runs k rounds of about eight full-size
// elementwise kernels over [rows, L - k + 1] int64 buffers: some 2.7 KB
// of device-memory traffic a window where 9 bytes do, and 90% of the
// card's busy time in a counting job.
//
// Contract: a window's key is min(forward, reverse complement) when
// canonical, else the forward key, packed as jellyfish packs it (the first
// base in the most significant bit pair); SENTINEL for a window that holds
// any code >= 4 (the reader's separator 4, its padding 5, any byte up to
// 255).  Bit for bit what extract_keys_plain gives.
//
// What bounds it on the H100: device-memory traffic, each code read once
// (1 byte) and each key written once (8 bytes): 36.9 MB, 11.0 us at 3.35
// TB/s for a [4096, 1024] batch at k = 27.  The design:
//   - a block takes TILE consecutive windows of the flattened [rows, W]
//     output (W = L - k + 1).  No window crosses a row, so the block's
//     windows read one contiguous span of codes, k - 1 codes longer for
//     each row the block enters; the host picks TILE (up to 4096, even) so
//     that the span fits the block's shared memory;
//   - the block reads the span once, a 16-byte load a thread from the
//     aligned memory around it (bytes outside the batch read as invalid),
//     and packs each 16 codes into three words in shared memory: the
//     forward stream (2 bits a base, the first base on top), the
//     reverse-complement stream (the complements, the first base at the
//     bottom) and one bit a base, set for a code >= 4;
//   - a window is then cut from the packed words in a few instructions,
//     whatever k: its forward key is the 2k bits at its place in the
//     forward stream (two funnel shifts over three words), its reverse
//     complement the 2k bits at its place in the other stream, and it is
//     invalid when one of the k bits at its place in the third is set.  A
//     thread that rolled the keys across a run of its own windows instead
//     would repeat k - 1 steps a run and would have to pass its keys
//     through shared memory to store them coalesced;
//   - a thread cuts two neighbouring windows and stores both keys with one
//     16-byte store, so a warp's stores cover 512 contiguous bytes.
// One launch a batch: no scratch, no memset, no host read.  A window's
// place in the span needs its row, found by a multiply-high division by
// W (kat::magic), which holds while W + TILE < 2^31.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_TILE = 4096;  // windows a block
constexpr int SEGS = 544;       // 16-code segments a block packs, at most
// codes of a block's span, from the aligned address below it: a cut reads
// up to three segments past its window's first (see kmer_windows)
constexpr int SPAN_CODES = 16 * (SEGS - 4);

// 16 codes (byte i is base i) -> the forward word (base 0 in bits 31-30),
// the reverse-complement word (the complement of base 0 in bits 1-0) and
// the invalid bits (bit i set when code i >= 4), four codes at a time.
__device__ __forceinline__ void pack16(const uint4& v, uint32_t* fwd,
                                       uint32_t* rc, uint32_t* bad) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t f = 0, r = 0, b = 0;
#pragma unroll
  for (int j = 0; j < 4; j++) {
    const uint32_t c = w[j] & 0x03030303u;  // each base's 2 bits, b0..b3
    // b0 << 2 | b1 in bits 0-3, b2 << 2 | b3 in bits 16-19
    const uint32_t t = (c << 2) | (c >> 8);
    f |= (((t & 0xFu) << 4) | ((t >> 16) & 0xFu)) << (24 - 8 * j);
    // the complements: ~b0 | ~b1 << 2 in bits 0-3, ~b2 | ~b3 << 2 in 16-19
    const uint32_t x = c ^ 0x03030303u;
    const uint32_t u = x | (x >> 6);
    r |= ((u & 0xFu) | ((u >> 12) & 0xF0u)) << (8 * j);
    // a byte >= 4 has a bit among bits 2-7: halved, the masked byte is at
    // most 0x7E, so adding 0x7E sets its bit 7 exactly when it is not 0,
    // with no carry into the next byte; the multiply gathers the four
    // bit 7s into bits 24-27 (every partial product lands on its own bit)
    const uint32_t h = ((w[j] & 0xFCFCFCFCu) >> 1) + 0x7E7E7E7Eu;
    b |= ((((h >> 7) & 0x01010101u) * 0x01020408u) >> 24) << (4 * j);
  }
  *fwd = f;
  *rc = r;
  *bad = b;
}

// The key of the window at place p of the packed span.
__device__ __forceinline__ int64_t cut(const uint32_t* s_fwd,
                                       const uint32_t* s_rc,
                                       const uint32_t* s_bad, int p, int k,
                                       uint64_t mask, uint32_t kbits,
                                       bool canonical) {
  const int w = p >> 4;
  const int o = 2 * (p & 15);
  // bases p.. p + 31, the first on top, then the first k of them
  const uint32_t f0 = s_fwd[w], f1 = s_fwd[w + 1], f2 = s_fwd[w + 2];
  const uint64_t fwd = ((uint64_t)__funnelshift_l(f1, f0, o) << 32 |
                        __funnelshift_l(f2, f1, o)) >> (64 - 2 * k);
  // the complements of bases p.. p + 31, the first at the bottom
  const uint32_t r0 = s_rc[w], r1 = s_rc[w + 1], r2 = s_rc[w + 2];
  const uint64_t rc = ((uint64_t)__funnelshift_r(r1, r2, o) << 32 |
                       __funnelshift_r(r0, r1, o)) & mask;
  const int bw = p >> 5;
  if (__funnelshift_r(s_bad[bw], s_bad[bw + 1], p & 31) & kbits)
    return KAT_SENTINEL;
  return (int64_t)(canonical && rc < fwd ? rc : fwd);
}

__global__ void __launch_bounds__(THREADS)
kmer_windows(const uint8_t* __restrict__ codes, int64_t n_codes,
             int64_t* __restrict__ out, int64_t n_windows, int W, int k,
             int canonical, int tile, uint32_t wmul, int wsh) {
  __shared__ uint32_t s_fwd[SEGS], s_rc[SEGS];
  __shared__ uint32_t s_bad[SEGS / 2];  // two segments' 16 bits a word
  __shared__ int64_t s_first;           // the first window's first code
  __shared__ int s_col0;                // the first window's column

  const int64_t g0 = (int64_t)blockIdx.x * tile;
  const int n = (int)min((int64_t)tile, n_windows - g0);
  if (threadIdx.x == 0) {
    const int64_t row0 = g0 / W;
    s_col0 = (int)(g0 - row0 * W);
    s_first = row0 * (W + k - 1) + s_col0;
  }
  __syncthreads();
  const int col0 = s_col0;
  const uintptr_t lo = (uintptr_t)codes;
  const uintptr_t hi = lo + (uintptr_t)n_codes;
  const uintptr_t base = (lo + (uintptr_t)s_first) & ~uintptr_t(15);
  const int skew = (int)(lo + (uintptr_t)s_first - base);
  // window lg's place in the span: each row boundary before it skips the
  // k - 1 codes that start no window of their row
  auto place = [&](int lg) {
    const uint32_t rows = kat::div_by((uint32_t)(col0 + lg), wmul, wsh);
    return skew + lg + (int)rows * (k - 1);
  };
  // a cut reads the segments of its place and the two after; the invalid
  // bits up to segment 2 (p >> 5) + 3 <= (p >> 4) + 3
  const int segs = (place(n - 1) + k - 1) / 16 + 4;
  for (int s = threadIdx.x; s < segs; s += THREADS) {
    const uintptr_t a = base + 16 * (uintptr_t)s;
    uint4 v;
    if (a >= lo && a + 16 <= hi) {
      v = *reinterpret_cast<const uint4*>(a);
    } else {
      uint8_t b[16];
#pragma unroll
      for (int i = 0; i < 16; i++)
        b[i] = a + i >= lo && a + i < hi
                   ? *reinterpret_cast<const uint8_t*>(a + i) : 4;
      v = make_uint4(b[0] | b[1] << 8 | b[2] << 16 | (uint32_t)b[3] << 24,
                     b[4] | b[5] << 8 | b[6] << 16 | (uint32_t)b[7] << 24,
                     b[8] | b[9] << 8 | b[10] << 16 | (uint32_t)b[11] << 24,
                     b[12] | b[13] << 8 | b[14] << 16 |
                         (uint32_t)b[15] << 24);
    }
    uint32_t f, r, bits;
    pack16(v, &f, &r, &bits);
    s_fwd[s] = f;
    s_rc[s] = r;
    reinterpret_cast<uint16_t*>(s_bad)[s] = (uint16_t)bits;
  }
  __syncthreads();

  const uint64_t mask = (uint64_t(1) << (2 * k)) - 1;
  const uint32_t kbits = (1u << k) - 1;
  for (int lg = 2 * threadIdx.x; lg < n; lg += 2 * THREADS) {
    const int64_t a = cut(s_fwd, s_rc, s_bad, place(lg), k, mask, kbits,
                          canonical);
    int64_t* dst = out + g0 + lg;  // 16-byte aligned: g0 and lg are even
    if (lg + 1 < n) {
      const int64_t b = cut(s_fwd, s_rc, s_bad, place(lg + 1), k, mask,
                            kbits, canonical);
      *reinterpret_cast<longlong2*>(dst) = make_longlong2(a, b);
    } else {
      *dst = a;
    }
  }
}

// Windows a block takes for rows of W windows at k: the most, a power of
// two up to MAX_TILE, whose span (plus up to 15 codes of alignment) fits
// SPAN_CODES, when the block starts anywhere in a row.
int tile_for(int64_t W, int k) {
  for (int t = MAX_TILE; t > 2; t /= 2)
    if (t - 1 + (W + t - 2) / W * (k - 1) + k + 15 <= SPAN_CODES) return t;
  return 2;
}

}  // namespace

// out[rows * (L - k + 1)] gets the key of every k-window of the [rows, L]
// codes (contiguous, at any byte offset); out must be 16-byte aligned.
// Requires 1 <= k <= 31 and k <= L < 2^31 - MAX_TILE (the division).
extern "C" int kat_extract_kmers(const uint8_t* codes, int64_t rows,
                                 int64_t L, int k, int canonical,
                                 int64_t* out, void* stream_ptr) {
  if (k < 1 || k > 31 || L < k || L >= (int64_t(1) << 31) - MAX_TILE ||
      rows < 0 || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const int64_t W = L - k + 1;
  const int64_t n = rows * W;
  if (n == 0) return 0;
  const int tile = tile_for(W, k);
  uint32_t wmul;
  int wsh;
  kat::magic((uint32_t)W, &wmul, &wsh);
  kmer_windows<<<(unsigned)((n + tile - 1) / tile), THREADS, 0,
                 (cudaStream_t)stream_ptr>>>(codes, rows * L, out, n, (int)W,
                                             k, canonical, tile, wmul, wsh);
  KAT_CHECK_LAUNCH();
  return 0;
}

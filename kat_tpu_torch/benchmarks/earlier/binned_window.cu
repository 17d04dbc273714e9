// The binned sums before their redesign (csrc/binned.cu's first design):
// block-private shared counters over a window of low bins, warp-aggregated
// u64 atomics into device memory past it, one 4-byte key and one mask byte
// a lane a step, two integer divisions an element and request.  Kept only
// so that chip_smoke.py can time the partitioned kernel against it on the
// same card; the port never calls it.  Its design notes are below, as they
// were.
//
// Binned sums: for each request r = (div, mod, mask), out_r[b] is the number
// of elements i with masks[mask][i] != 0 and (keys[i] / div) % mod == b.
//
// Replaces the binned form of K1 + K3 in kat_tpu/core/stats.py: binned_sums
// (stats.py:38-70) sorts a u32 bin plane carrying 1-3 u32 mask planes
// through kat_tpu/ops/sort_kernel.py::_window_kernel (sort_planes_padded,
// stats.py:58) and reduces the sorted bins through
// kat_tpu/ops/reduce_kernel.py::_reduce_kernel (reduce_compact_sorted,
// stats.py:63), then scatters the few run sums; monotone_packed_sums
// (stats.py:78-178) does the same for bins derived from one packed key,
// (packed // div) % mod (stats.py:124,153).  kat_tpu sorts because a
// scatter is slow on the TPU.  The H100 has fast shared-memory atomics and
// integer atomics in L2, so this computes the same function directly in
// one pass over the keys and masks, and the sort and the reduce go away.
// Integer adds make the result exact in any order (tolerance 0).
//
// What bounds it on the H100: device-memory traffic, one read of the keys
// (4 bytes an element) and of each mask (1 byte), one write of each output
// bin (8 bytes): at 2^24 elements and one mask about 0.03 ms.  What makes
// it hard is skew, not bytes: k-mer tables pile into a few bins (a
// histogram's coverage peak, comp's reads-against-assembly cells, where
// nearly every real slot lands in a few dozen cells of a 1001 x 1001
// matrix), and atomics onto one address serialise.  The design:
//   - every block keeps private u32 counters in shared memory for a window
//     of each request's lowest bins, [0, win_r).  The windows share a
//     budget of 48K counters (192 KB): requests that fit whole get all
//     their bins, larger ones split what is left (hist's 10,001 and gcp's
//     28,028 bins fit whole; comp's 1,002,001 get the first 46K bins, rows
//     0-45 of the matrix, beside two 1001-bin spectra, or 16K each when
//     three matrices share the budget).  Coverage lives at low counts, so
//     the hot bins are mostly inside the window;
//   - a warp walks 32 consecutive elements at a time (every element read
//     once, coalesced); for each request the lanes that target the same bin
//     find each other with __match_any_sync and the lowest of them adds the
//     group's size: one atomic per distinct bin in the warp, to shared
//     memory inside the window and to the u64 output in device memory
//     outside it;
//   - after the walk each block adds its non-zero window counters to the
//     output with u64 atomics.  A block counts at most n < 2^32 elements,
//     so its u32 counters are exact, as kat_tpu's u32 accumulation is.
// The grid is one or two blocks an SM (two where the windows take at most
// 113 KB), fewer for a short input.  The wrapper zeroes the output first.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int BS_THREADS = 512;
constexpr int BS_MAX_REQ = 3;
constexpr int BS_MAX_MASKS = 3;
constexpr int BS_WINDOW = 48 * 1024;  // shared counters a block may hold
constexpr int BS_SMEM = BS_WINDOW * 4;
constexpr int BS_TWO_PER_SM = 113 * 1024;  // bytes for two blocks an SM

struct Requests {
  int n;
  int32_t div[BS_MAX_REQ];
  int32_t mod[BS_MAX_REQ];
  int32_t mask[BS_MAX_REQ];
  int32_t win[BS_MAX_REQ];      // bins [0, win) counted in shared memory
  int32_t win_off[BS_MAX_REQ];  // where request r's window starts there
  int64_t out_off[BS_MAX_REQ];  // where request r's bins start in out
};

__global__ void __launch_bounds__(BS_THREADS, 2)
binned_sums_kernel(const int32_t* __restrict__ keys,
                   const uint8_t* __restrict__ masks, int n_masks, int64_t n,
                   Requests rq, int win_total,
                   unsigned long long* __restrict__ out) {
  extern __shared__ uint32_t s_win[];
  for (int j = threadIdx.x; j < win_total; j += BS_THREADS) s_win[j] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (BS_THREADS / 32);
  const int64_t warp = (int64_t)blockIdx.x * (BS_THREADS / 32) +
                       (threadIdx.x >> 5);
  // the loop bound is the same for every lane of a warp, so all 32 lanes
  // take part in every __match_any_sync
  for (int64_t base = warp * 32; base < n; base += warps * 32) {
    const int64_t i = base + lane;
    const bool in = i < n;
    const int32_t key = in ? keys[i] : -1;
    uint32_t bits = 0;
    for (int m = 0; m < n_masks; m++)
      if (in && masks[m * n + i]) bits |= 1u << m;
    for (int r = 0; r < rq.n; r++) {
      int32_t b = -1;  // -1: nothing to add (the group is skipped)
      if (key >= 0 && ((bits >> rq.mask[r]) & 1u))
        b = (key / rq.div[r]) % rq.mod[r];
      const unsigned peers = __match_any_sync(0xffffffffu, b);
      if (b >= 0 && lane == __ffs(peers) - 1) {
        const unsigned c = __popc(peers);
        if (b < rq.win[r])
          atomicAdd(&s_win[rq.win_off[r] + b], c);
        else
          atomicAdd(out + rq.out_off[r] + b, (unsigned long long)c);
      }
    }
  }
  __syncthreads();
  for (int r = 0; r < rq.n; r++) {
    for (int j = threadIdx.x; j < rq.win[r]; j += BS_THREADS) {
      const uint32_t c = s_win[rq.win_off[r] + j];
      if (c) atomicAdd(out + rq.out_off[r] + j, (unsigned long long)c);
    }
  }
}

}  // namespace

// n_req (1-3) requests over the same n keys, each three host int64 values
// (div >= 1, mod >= 1, mask index < n_masks) in `req`; masks are n_masks
// (1-3) byte planes of n elements, back to back (non-zero = count).  out
// holds the requests' bins back to back (sum of mod int64 values) and must
// be zero.  Keys must be >= 0; a negative key adds nothing.
extern "C" int kat_earlier_binned_sums(const int32_t* keys,
                                       const uint8_t* masks, int n_masks,
                                       int64_t n, const int64_t* req,
                                       int n_req,
                                       int64_t* out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n_req < 1 || n_req > BS_MAX_REQ || n_masks < 1 ||
      n_masks > BS_MAX_MASKS || n < 0 || n >= (int64_t(1) << 32))
    return (int)cudaErrorInvalidValue;
  Requests rq = {};
  rq.n = n_req;
  int64_t off = 0;
  for (int r = 0; r < n_req; r++) {
    const int64_t div = req[3 * r], mod = req[3 * r + 1], m = req[3 * r + 2];
    if (div < 1 || div > INT32_MAX || mod < 1 || mod > INT32_MAX || m < 0 ||
        m >= n_masks)
      return (int)cudaErrorInvalidValue;
    rq.div[r] = (int32_t)div;
    rq.mod[r] = (int32_t)mod;
    rq.mask[r] = (int32_t)m;
    rq.out_off[r] = off;
    off += mod;
  }
  // windows: the smallest requests first, each taking all its bins or an
  // equal share of what the smaller ones left
  int order[BS_MAX_REQ];
  for (int r = 0; r < n_req; r++) order[r] = r;
  std::sort(order, order + n_req,
            [&](int a, int b) { return rq.mod[a] < rq.mod[b]; });
  int left = BS_WINDOW;
  for (int j = 0; j < n_req; j++) {
    const int r = order[j];
    rq.win[r] = std::min(rq.mod[r], left / (n_req - j));
    left -= rq.win[r];
  }
  int win_total = 0;
  for (int r = 0; r < n_req; r++) {
    rq.win_off[r] = win_total;
    win_total += rq.win[r];
  }
  static int sms_of[kat::MAX_DEVICES] = {};
  int sms;
  cudaError_t err = kat::prepare(binned_sums_kernel, BS_SMEM, sms_of, &sms);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const int smem = win_total * 4;
  const int64_t per_sm = smem <= BS_TWO_PER_SM ? 2 : 1;
  const int64_t blocks =
      std::min<int64_t>(sms * per_sm, (n + BS_THREADS - 1) / BS_THREADS);
  binned_sums_kernel<<<(unsigned)blocks, BS_THREADS, smem, stream>>>(
      keys, masks, n_masks, n, rq, win_total,
      reinterpret_cast<unsigned long long*>(out));
  KAT_CHECK_LAUNCH();
  return 0;
}

// Per-record min/max of IEEE-754 order keys plus the bbox survivor test,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/minmax/kernel.py::segminmax_blocks
// together with the jnp glue around it in
//   src/repro/kernels/fp_delta/ops.py::_refine_jit
// (the order-key prologue float_order_keys, the take at each record's end
// position, and the NaN-fenced bbox test).
//
// What it computes. Record r owns counts[r] decoded bit patterns at
// [x_start[r], x_start[r] + counts[r]) and the same count at y_start[r].
// Each pattern maps to its total-order key (flip every bit of a negative
// value, else set the sign bit), so unsigned key order is the IEEE total
// order with -0 < +0 and NaNs outside [-inf, +inf]. The kernel writes the
// record's (x_min, x_max, y_min, y_max) keys and
//   keep[r] = valid[r] && x_min <= qx1 && x_max >= qx0 && y_min <= qy1 &&
//             y_max >= qy0 && x_max <= key(+inf) && x_min >= key(-inf) &&
//             y_max <= key(+inf) && y_min >= key(-inf)
// which is the reference's test exactly. Keys are 64-bit: for W = 64 the
// pattern's key; for W = 32 the 32-bit key in the upper half, so (lo, hi) of
// the reference's limb pairs are the two halves of the same number.
//
// What bounds it on the H100. Every decoded value is read once (W/8 bytes)
// and each record reads 25 bytes of geometry and writes 33; the compares
// are a handful of integer ops per value. It is bound by device-memory bytes.
//
// What the design does about that. The TPU kernel ran a segmented scan over
// the whole stream because its vector unit has no cheap gather; here the
// record slices are known, so one warp reduces one record: lanes read
// consecutive values (coalesced), keep running min/max in registers, and a
// shuffle butterfly combines them. Nothing but the per-record results is
// written, where the TPU version wrote four scan arrays per value.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int W>
__device__ __forceinline__ unsigned long long order_key(const void* bits, long long i) {
  if (W == 64) {
    const unsigned long long b =
        static_cast<unsigned long long>(static_cast<const long long*>(bits)[i]);
    return b ^ ((b >> 63) ? ~0ull : 0x8000000000000000ull);
  } else {
    const uint32_t b = static_cast<uint32_t>(static_cast<const int32_t*>(bits)[i]);
    const uint32_t k = b ^ ((b >> 31) ? 0xFFFFFFFFu : 0x80000000u);
    return static_cast<unsigned long long>(k) << 32;
  }
}

__device__ __forceinline__ unsigned long long umin(unsigned long long a, unsigned long long b) {
  return a < b ? a : b;
}
__device__ __forceinline__ unsigned long long umax(unsigned long long a, unsigned long long b) {
  return a > b ? a : b;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
segminmax_refine(const void* __restrict__ bits, const long long* __restrict__ x_start,
                 const long long* __restrict__ y_start, const long long* __restrict__ counts,
                 const uint8_t* __restrict__ valid, long long n_records,
                 unsigned long long qx0, unsigned long long qx1, unsigned long long qy0,
                 unsigned long long qy1, uint8_t* __restrict__ keep,
                 unsigned long long* __restrict__ mm) {
  const long long r = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= n_records) return;
  const long long c = counts[r];
  const long long xs = x_start[r];
  const long long ys = y_start[r];
  // identities: min starts at the largest key, max at the smallest
  unsigned long long xmn = ~0ull, xmx = 0ull, ymn = ~0ull, ymx = 0ull;
  for (long long i = lane; i < c; i += 32) {
    const unsigned long long kx = order_key<W>(bits, xs + i);
    const unsigned long long ky = order_key<W>(bits, ys + i);
    xmn = umin(xmn, kx);
    xmx = umax(xmx, kx);
    ymn = umin(ymn, ky);
    ymx = umax(ymx, ky);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    xmn = umin(xmn, __shfl_xor_sync(0xFFFFFFFFu, xmn, d));
    xmx = umax(xmx, __shfl_xor_sync(0xFFFFFFFFu, xmx, d));
    ymn = umin(ymn, __shfl_xor_sync(0xFFFFFFFFu, ymn, d));
    ymx = umax(ymx, __shfl_xor_sync(0xFFFFFFFFu, ymx, d));
  }
  if (lane != 0) return;
  const unsigned long long kneg = W == 64 ? 0x000FFFFFFFFFFFFFull : (0x007FFFFFull << 32);
  const unsigned long long kpos = W == 64 ? 0xFFF0000000000000ull : (0xFF800000ull << 32);
  const bool k = valid[r] != 0 && xmn <= qx1 && xmx >= qx0 && ymn <= qy1 && ymx >= qy0 &&
                 xmx <= kpos && xmn >= kneg && ymx <= kpos && ymn >= kneg;
  keep[r] = k ? 1 : 0;
  mm[4 * r + 0] = xmn;
  mm[4 * r + 1] = xmx;
  mm[4 * r + 2] = ymn;
  mm[4 * r + 3] = ymx;
}

}  // namespace

extern "C" {

// bits: decoded patterns (int32 for width 32, int64 for width 64);
// x_start/y_start/counts: n_records int64; valid: n_records uint8 (bool);
// q*: the query bounds' 64-bit order keys; keep: n_records uint8 (bool);
// mm: n_records x 4 uint64 keys. Returns cudaGetLastError().
int smm_refine(const void* bits, int width, const void* x_start, const void* y_start,
               const void* counts, const void* valid, long long n_records,
               unsigned long long qx0, unsigned long long qx1, unsigned long long qy0,
               unsigned long long qy1, void* keep, void* mm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_records <= 0) return static_cast<int>(cudaGetLastError());
  const long long grid = (n_records + kWarps - 1) / kWarps;
  auto* xs = static_cast<const long long*>(x_start);
  auto* ys = static_cast<const long long*>(y_start);
  auto* cn = static_cast<const long long*>(counts);
  auto* va = static_cast<const uint8_t*>(valid);
  auto* kp = static_cast<uint8_t*>(keep);
  auto* m = static_cast<unsigned long long*>(mm);
  if (width == 64) {
    segminmax_refine<64><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
        bits, xs, ys, cn, va, n_records, qx0, qx1, qy0, qy1, kp, m);
  } else {
    segminmax_refine<32><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
        bits, xs, ys, cn, va, n_records, qx0, qx1, qy0, qy1, kp, m);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* smm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Per-page min/max of a float32 column, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/minmax/kernel.py::minmax
// (the write path's zone statistics for float32 extra columns).
//
// What it computes. Page p is values[bounds[p], bounds[p+1]). Its min and
// max follow the IEEE total order on non-NaN values, so -0.0 orders below
// +0.0 whatever the order they come in (the reference's jnp.min/jnp.max
// give -0.0 and +0.0 for a page holding both). A denormal counts as the
// zero of its sign, as in the reference's XLA reduction, which flushes
// denormal inputs (its stats land in the file's bytes). An empty page gives
// (+inf, -inf). A page holding a NaN gives that NaN for both (the largest
// NaN bit pattern when it holds several): the caller recomputes such pages
// on the host, so only this agreement with the plain version matters.
//
// What bounds it on the H100. Each value is read once (4 bytes) and each
// page writes 8 bytes; it is bound by device-memory bytes. At the write
// path's shape (a few hundred pages of a few thousand values, about 4 MB)
// that bound is about a microsecond, below one launch's latency, so a call
// costs the launch (about 3 us on the device) and its host dispatch.
//
// What the design does about that. The TPU edge-padded every page to a
// multiple of its 2048-value tile; here a block takes its page's ragged
// range directly (no padded copy), threads stride over it with coalesced
// loads, and a warp-shuffle then shared-memory reduction combines them, in
// one launch with no scratch. Comparisons run on int32 order keys
// (sign-magnitude flipped to two's complement order), which gives the
// signed-zero order for free. A page runs on one block, so a very large
// page runs on one SM (about 0.24 ms for 1<<20 values); a design that
// spread values over equal tiles and combined pages by atomics balanced
// such a page but was slower at the write shape, where pages are small.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int32_t okey(uint32_t b) {
  return static_cast<int32_t>(b ^ ((b >> 31) ? 0x7FFFFFFFu : 0u));
}

__global__ void __launch_bounds__(kThreads)
page_minmax(const uint32_t* __restrict__ values, const long long* __restrict__ bounds,
            float* __restrict__ out_min, float* __restrict__ out_max) {
  const int p = blockIdx.x;
  const long long v0 = bounds[p];
  const long long v1 = bounds[p + 1];
  int32_t kmn = okey(0x7F800000u);  // +inf
  int32_t kmx = okey(0xFF800000u);  // -inf
  uint32_t nan = 0;                 // largest NaN pattern seen, 0 = none
  for (long long i = v0 + threadIdx.x; i < v1; i += kThreads) {
    uint32_t b = values[i];
    if ((b & 0x7F800000u) == 0u) b &= 0x80000000u;  // denormal -> signed zero
    if ((b & 0x7FFFFFFFu) > 0x7F800000u) {
      nan = max(nan, b);
    } else {
      const int32_t k = okey(b);
      kmn = min(kmn, k);
      kmx = max(kmx, k);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    kmn = min(kmn, __shfl_xor_sync(0xFFFFFFFFu, kmn, d));
    kmx = max(kmx, __shfl_xor_sync(0xFFFFFFFFu, kmx, d));
    nan = max(nan, __shfl_xor_sync(0xFFFFFFFFu, nan, d));
  }
  __shared__ int32_t smn[kThreads / 32], smx[kThreads / 32];
  __shared__ uint32_t snan[kThreads / 32];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    smn[warp] = kmn;
    smx[warp] = kmx;
    snan[warp] = nan;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kThreads / 32; ++w) {
    kmn = min(kmn, smn[w]);
    kmx = max(kmx, smx[w]);
    nan = max(nan, snan[w]);
  }
  // the key map is its own inverse
  const uint32_t bmn = nan ? nan : static_cast<uint32_t>(okey(static_cast<uint32_t>(kmn)));
  const uint32_t bmx = nan ? nan : static_cast<uint32_t>(okey(static_cast<uint32_t>(kmx)));
  out_min[p] = __uint_as_float(bmn);
  out_max[p] = __uint_as_float(bmx);
}

}  // namespace

extern "C" {

// values: float32 column; bounds: n_pages + 1 int64 value offsets;
// out_min/out_max: n_pages float32. Returns cudaGetLastError().
int pmm_page_minmax(const void* values, const void* bounds, int n_pages, void* out_min,
                    void* out_max, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_pages <= 0) return static_cast<int>(cudaGetLastError());
  page_minmax<<<n_pages, kThreads, 0, st>>>(static_cast<const uint32_t*>(values),
                                            static_cast<const long long*>(bounds),
                                            static_cast<float*>(out_min),
                                            static_cast<float*>(out_max));
  return static_cast<int>(cudaGetLastError());
}

const char* pmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

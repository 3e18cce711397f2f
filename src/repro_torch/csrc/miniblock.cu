// Miniblock FP-delta encode and decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/fp_delta/kernel.py::encode_blocks (body _encode_kernel)
//   src/repro/kernels/fp_delta/kernel.py::decode_blocks (body _decode_kernel).
//
// What they compute. A miniblock is 1024 float32 values, handled as uint32
// bit patterns (NaN payloads, signed zeros and denormals pass unchanged).
// Encode: delta against the previous value in the block (delta[0] = 0),
// zigzag, the width w in {0, 1, 2, 3, 4, 6, 8, 10, 12, 16, 20, 24, 32}
// that minimizes 1024*w + 48*n_over(w) subject to n_over(w) <= 64 (ties
// keep the smaller width), the deltas packed LSB-first at w bits per value
// into the block's first 32*w words (later words 0), and the first 64
// deltas wider than w bits as (position, zigzag) exception slots (unused
// slots 0). The payload keeps an exception's low w bits. Decode: unpack at
// w, overwrite the exception positions, un-zigzag, inclusive prefix sum
// mod 2^32, add the anchor.
//
// What bounds them on the H100. Encode reads 4 bytes a value and writes
// the dense outputs (4 bytes a value of packed words plus about 0.5 of
// exception slots and per-block scalars); decode reads the valid payload
// words and live exception slots and writes 4 bytes a value. A few dozen
// integer operations a value: both are bound by device-memory bytes
// (3.35 TB/s).
//
// What the design does about that. One block of 256 threads per miniblock,
// four values a thread, loaded and stored as 16-byte vectors; everything
// between the load and the store stays in shared memory. Encode: a shared
// histogram of bit lengths gives n_over(w) for every candidate at once;
// a block scan (cub::BlockScan) of the over-width flags ranks the
// exceptions; thread j builds output word j from the values that overlap
// its 32 bits, so the packing needs no atomics. Decode: each value is
// extracted from a two-word window into shared memory, the exceptions
// overwrite their positions, and a block scan in uint32 does the prefix
// sum. The TPU kernels' six packings combined by a masked sum and their
// one-hot exception contractions are dropped. All arithmetic is uint32:
// signed overflow is undefined in C++, and shifts by 32 are avoided.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kBlock = kThreads * kItems;  // MINIBLOCK
constexpr int kMaxExc = 64;
constexpr int kExcBits = 48;
constexpr int kNumCand = 12;
__constant__ int kCandidates[kNumCand] = {0, 1, 2, 3, 4, 6, 8, 10, 12, 16, 20, 24};
// bit w set for every width a block may carry: 0 and the packing widths
constexpr unsigned long long kValidWidths =
    (1ull << 0) | (1ull << 1) | (1ull << 2) | (1ull << 3) | (1ull << 4) | (1ull << 6) |
    (1ull << 8) | (1ull << 10) | (1ull << 12) | (1ull << 16) | (1ull << 20) |
    (1ull << 24) | (1ull << 32);

__device__ __forceinline__ uint32_t width_mask(int w) {
  return w >= 32 ? 0xFFFFFFFFu : ((1u << w) - 1u);
}

using IntScanT = cub::BlockScan<int, kThreads>;
using U32ScanT = cub::BlockScan<uint32_t, kThreads>;

__global__ void __launch_bounds__(kThreads)
encode_kernel(const uint32_t* __restrict__ x, int32_t* __restrict__ packed,
              int32_t* __restrict__ widths, int32_t* __restrict__ anchors,
              int32_t* __restrict__ exc_idx, int32_t* __restrict__ exc_val,
              int32_t* __restrict__ exc_count) {
  __shared__ uint32_t xs[kBlock];
  __shared__ uint32_t zs[kBlock];
  __shared__ int hist[33];
  __shared__ int s_width;
  __shared__ typename IntScanT::TempStorage scan_temp;

  const long long blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int t0 = tid * kItems;
  const uint4 v4 = reinterpret_cast<const uint4*>(x + blk * kBlock)[tid];
  xs[t0] = v4.x;
  xs[t0 + 1] = v4.y;
  xs[t0 + 2] = v4.z;
  xs[t0 + 3] = v4.w;
  if (tid < 33) hist[tid] = 0;
  __syncthreads();

  uint32_t z[kItems];
  int nb[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int t = t0 + k;
    const uint32_t prev = xs[t == 0 ? 0 : t - 1];
    const uint32_t d = xs[t] - prev;                       // wraps mod 2^32
    z[k] = (d << 1) ^ (0u - (d >> 31));                    // zigzag of int32 d
    nb[k] = 32 - __clz(z[k]);                              // 0 for 0
    zs[t] = z[k];
    atomicAdd(&hist[nb[k]], 1);
  }
  __syncthreads();

  if (tid == 0) {
    // n_over(w) = #values with more than w bits: suffix sums of the histogram
    int best_w = 32, best_cost = kBlock * 32;
    for (int c = 0; c < kNumCand; ++c) {
      const int w = kCandidates[c];
      int n_over = 0;
      for (int b = w + 1; b <= 32; ++b) n_over += hist[b];
      const int cost = kBlock * w + kExcBits * n_over;
      if (n_over <= kMaxExc && cost < best_cost) {
        best_w = w;
        best_cost = cost;
      }
    }
    s_width = best_w;
    widths[blk] = best_w;
    anchors[blk] = static_cast<int32_t>(xs[0]);
  }
  __syncthreads();
  const int w = s_width;

  // exceptions: rank the over-width values in position order
  int flags[kItems];
  int mine = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    flags[k] = nb[k] > w;
    mine += flags[k];
  }
  int rank, total;
  IntScanT(scan_temp).ExclusiveSum(mine, rank, total);
  const int count = total < kMaxExc ? total : kMaxExc;
  int32_t* eidx = exc_idx + blk * kMaxExc;
  int32_t* eval = exc_val + blk * kMaxExc;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (flags[k]) {
      if (rank < kMaxExc) {
        eidx[rank] = t0 + k;
        eval[rank] = static_cast<int32_t>(z[k]);
      }
      ++rank;
    }
  }
  if (tid >= count && tid < kMaxExc) {
    eidx[tid] = 0;
    eval[tid] = 0;
  }
  if (tid == 0) exc_count[blk] = count;

  // pack: word j holds bits [32j, 32j + 32) of the LSB-first stream
  const uint32_t mask = width_mask(w);
  uint32_t out[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = t0 + k;
    uint32_t word = 0;
    if (w > 0 && j < 32 * w) {
      const int lo_bit = 32 * j;
      const int first = lo_bit / w;
      int last = (lo_bit + 31) / w;
      if (last > kBlock - 1) last = kBlock - 1;
      for (int t = first; t <= last; ++t) {
        const uint32_t v = zs[t] & mask;
        const int o = t * w;
        word |= o >= lo_bit ? (v << (o - lo_bit)) : (v >> (lo_bit - o));
      }
    }
    out[k] = word;
  }
  reinterpret_cast<uint4*>(packed + blk * kBlock)[tid] =
      make_uint4(out[0], out[1], out[2], out[3]);
}

__global__ void __launch_bounds__(kThreads)
decode_kernel(const uint32_t* __restrict__ packed, const int32_t* __restrict__ widths,
              const int32_t* __restrict__ anchors, const int32_t* __restrict__ exc_idx,
              const int32_t* __restrict__ exc_val, const int32_t* __restrict__ exc_count,
              uint32_t* __restrict__ out) {
  __shared__ uint32_t ws[kBlock];
  __shared__ uint32_t zs[kBlock];
  __shared__ typename U32ScanT::TempStorage scan_temp;

  const long long blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int t0 = tid * kItems;
  // a width outside the format unpacks as zeros, as the reference's
  // select over the packing widths does
  const int w_in = widths[blk];
  const int w = (w_in >= 0 && w_in <= 32 && ((kValidWidths >> w_in) & 1ull)) ? w_in : 0;
  const int n_words = 32 * w;  // payload words of this block
  for (int j = tid; j < n_words; j += kThreads) ws[j] = packed[blk * kBlock + j];
  __syncthreads();

  const uint32_t mask = width_mask(w);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int t = t0 + k;
    uint32_t v = 0;
    if (w > 0) {
      const int o = t * w;
      const int j = o >> 5;
      const int s = o & 31;
      v = ws[j] >> s;
      if (s + w > 32) v |= ws[j + 1] << (32 - s);
      v &= mask;
    }
    zs[t] = v;
  }
  __syncthreads();

  const int count = exc_count[blk];
  if (tid < count && tid < kMaxExc) {
    const int pos = exc_idx[blk * kMaxExc + tid];
    if (pos >= 0 && pos < kBlock) zs[pos] = static_cast<uint32_t>(exc_val[blk * kMaxExc + tid]);
  }
  __syncthreads();

  uint32_t d[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const uint32_t z = zs[t0 + k];
    d[k] = (z >> 1) ^ (0u - (z & 1u));
  }
  U32ScanT(scan_temp).InclusiveSum(d, d);  // uint32: wraps mod 2^32
  const uint32_t a = static_cast<uint32_t>(anchors[blk]);
  reinterpret_cast<uint4*>(out + blk * kBlock)[tid] =
      make_uint4(a + d[0], a + d[1], a + d[2], a + d[3]);
}

}  // namespace

extern "C" {

// x: n_blocks * 1024 uint32 patterns; packed: n_blocks * 1024 int32;
// widths, anchors, exc_count: n_blocks int32; exc_idx, exc_val:
// n_blocks * 64 int32. Returns cudaGetLastError().
int mb_encode_blocks(const void* x, int n_blocks, void* packed, void* widths,
                     void* anchors, void* exc_idx, void* exc_val, void* exc_count,
                     void* stream) {
  if (n_blocks > 0) {
    encode_kernel<<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(x), static_cast<int32_t*>(packed),
        static_cast<int32_t*>(widths), static_cast<int32_t*>(anchors),
        static_cast<int32_t*>(exc_idx), static_cast<int32_t*>(exc_val),
        static_cast<int32_t*>(exc_count));
  }
  return static_cast<int>(cudaGetLastError());
}

// The six arrays of mb_encode_blocks in, n_blocks * 1024 uint32 patterns out.
int mb_decode_blocks(const void* packed, const void* widths, const void* anchors,
                     const void* exc_idx, const void* exc_val, const void* exc_count,
                     int n_blocks, void* out, void* stream) {
  if (n_blocks > 0) {
    decode_kernel<<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(widths),
        static_cast<const int32_t*>(anchors), static_cast<const int32_t*>(exc_idx),
        static_cast<const int32_t*>(exc_val), static_cast<const int32_t*>(exc_count),
        static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* mb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

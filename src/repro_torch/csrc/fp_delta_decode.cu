// FP-delta page-stream decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fp_delta/kernel.py::decode_stream_limbs
//   (body _stream_decode_kernel, carry stitch in the same function).
//
// What it computes. A page stream is many FP-delta pages concatenated into
// one value stream. Value i is a token of nbits[i] bits (1..64) at bit
// offset tok_off[i] of a little-endian uint32 word buffer. Anchors
// (anchor[i] != 0: a page's first value, an escaped value, every value of a
// raw page, the padding tail) keep their raw bits and start a segment; every
// other token is a zigzag delta. The output is the segmented inclusive sum
// mod 2^64 over anchor-delimited segments, truncated to W bits (W = 32 or 64).
//
// What bounds it on the H100. Per value it reads 12 bytes of operands
// (offset, width, anchor flag) plus about W/8 bytes of packed words, and
// writes W/8 bytes; the arithmetic is a few integer ops. It is bound by
// device-memory bytes (3.35 TB/s).
//
// What the design does about that. The TPU limb pairs become native
// uint64_t. Each thread reads its token through a 96-bit window of three
// consecutive words, so every token is one unaligned gather with no branch
// on the token width. The segmented scan runs in three launches:
//   1. per block of 1024 values: gather + block segmented scan
//      (cub::BlockScan), writing only the block summary (last value, anchor
//      seen) -- 16 bytes per block, no per-value output;
//   2. one block scans the block summaries (exclusive, segmented), giving the
//      carry into each block;
//   3. per block: gather + block scan again, seeded with the carry, writing
//      the final W-bit pattern once.
// Pass 1 re-reads the operands instead of writing and re-reading a 64-bit
// partial per value, so each output byte is written once. A single-pass
// chained scan (decoupled look-back) would save pass 1's reads; that is a
// later optimisation.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kBlock = kThreads * kItems;  // 1024 values, the stream's padding unit

struct SegVal {
  unsigned long long v;
  int f;  // an anchor was seen in this span
};

struct SegOp {
  __device__ __forceinline__ SegVal operator()(const SegVal& a, const SegVal& b) const {
    SegVal r;
    r.v = b.f ? b.v : a.v + b.v;
    r.f = a.f | b.f;
    return r;
  }
};

// The value of stream position i: raw bits for an anchor, else the
// un-zigzagged delta (both as 64-bit two's complement).
__device__ __forceinline__ SegVal load_value(const uint32_t* __restrict__ words,
                                             const int32_t* __restrict__ tok_off,
                                             const int32_t* __restrict__ nbits,
                                             const int32_t* __restrict__ anchor,
                                             long long i) {
  const uint32_t off = static_cast<uint32_t>(tok_off[i]);
  const int n = nbits[i];
  const uint32_t w0i = off >> 5;
  const uint32_t s = off & 31u;
  const unsigned long long lo64 =
      static_cast<unsigned long long>(words[w0i]) |
      (static_cast<unsigned long long>(words[w0i + 1]) << 32);
  const unsigned long long w2 = words[w0i + 2];
  // s + n <= 31 + 64 < 96: the token lies inside the three-word window.
  // A shift by 64 is undefined, so the s == 0 case selects instead.
  unsigned long long tok = (lo64 >> s) | (s ? (w2 << (64u - s)) : 0ull);
  // n in [1, 64]; 1 << 64 is undefined, so n == 64 takes the full mask.
  const unsigned long long mask = n >= 64 ? ~0ull : ((1ull << n) - 1ull);
  tok &= mask;
  SegVal r;
  r.f = anchor[i] != 0;
  r.v = r.f ? tok : ((tok >> 1) ^ (0ull - (tok & 1ull)));
  return r;
}

using BlockScanT = cub::BlockScan<SegVal, kThreads>;

// Passes 1 and 3. With carry == nullptr it writes the block summary; else it
// seeds the scan with carry[block] and writes the decoded patterns.
template <int W>
__global__ void __launch_bounds__(kThreads)
decode_block(const uint32_t* __restrict__ words, const int32_t* __restrict__ tok_off,
             const int32_t* __restrict__ nbits, const int32_t* __restrict__ anchor,
             const unsigned long long* __restrict__ carry,
             unsigned long long* __restrict__ sum_v, int* __restrict__ sum_f,
             void* __restrict__ out) {
  __shared__ typename BlockScanT::TempStorage temp;
  const long long base = static_cast<long long>(blockIdx.x) * kBlock +
                         static_cast<long long>(threadIdx.x) * kItems;
  SegVal items[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) items[k] = load_value(words, tok_off, nbits, anchor, base + k);

  SegOp op;
  // The seed enters as a span with no anchor, so the scan adds it to every
  // value before the block's first anchor and to nothing after it.
  SegVal seed;
  seed.v = carry ? carry[blockIdx.x] : 0ull;
  seed.f = 0;
  if (threadIdx.x == 0) items[0] = op(seed, items[0]);
  SegVal total;
  BlockScanT(temp).InclusiveScan(items, items, op, total);

  if (carry == nullptr) {
    if (threadIdx.x == 0) {
      sum_v[blockIdx.x] = total.v;
      sum_f[blockIdx.x] = total.f;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (W == 64) {
      static_cast<long long*>(out)[base + k] = static_cast<long long>(items[k].v);
    } else {
      static_cast<int32_t*>(out)[base + k] =
          static_cast<int32_t>(static_cast<uint32_t>(items[k].v));
    }
  }
}

// Running prefix for BlockScan's callback form: the combined summary of all
// earlier chunks of block summaries.
struct ChunkPrefix {
  SegVal running;
  __device__ SegVal operator()(SegVal chunk_total) {
    SegVal old = running;
    running = SegOp()(running, chunk_total);
    return old;
  }
};

using CarryScanT = cub::BlockScan<SegVal, kThreads>;

// Pass 2: carry[b] = segmented exclusive scan of the block summaries, in
// one block that walks over them kThreads at a time.
__global__ void __launch_bounds__(kThreads)
carry_scan(const unsigned long long* __restrict__ sum_v, const int* __restrict__ sum_f,
           unsigned long long* __restrict__ carry, int n_blocks) {
  __shared__ typename CarryScanT::TempStorage temp;
  ChunkPrefix prefix;
  prefix.running.v = 0ull;
  prefix.running.f = 0;
  for (int c0 = 0; c0 < n_blocks; c0 += kThreads) {
    const int b = c0 + threadIdx.x;
    SegVal x;
    x.v = b < n_blocks ? sum_v[b] : 0ull;
    x.f = b < n_blocks ? sum_f[b] : 0;
    SegVal ex;
    CarryScanT(temp).ExclusiveScan(x, ex, SegOp(), prefix);
    if (b < n_blocks) carry[b] = ex.v;
    __syncthreads();  // temp is reused by the next chunk
  }
}

}  // namespace

extern "C" {

// words: n_words uint32 (>= 2 spill words after the last token);
// tok_off/nbits/anchor: n_blocks * 1024 int32 each; scratch: sum_v and carry
// (n_blocks uint64 each) and sum_f (n_blocks int32); out: n_blocks * 1024
// int32 (width 32) or int64 (width 64). Returns cudaGetLastError().
int fpd_decode_stream(const void* words, const void* tok_off, const void* nbits,
                      const void* anchor, int n_blocks, int width, void* sum_v,
                      void* sum_f, void* carry, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* w = static_cast<const uint32_t*>(words);
  auto* o = static_cast<const int32_t*>(tok_off);
  auto* nb = static_cast<const int32_t*>(nbits);
  auto* an = static_cast<const int32_t*>(anchor);
  auto* sv = static_cast<unsigned long long*>(sum_v);
  auto* sf = static_cast<int*>(sum_f);
  auto* cr = static_cast<unsigned long long*>(carry);
  if (n_blocks <= 0) return static_cast<int>(cudaGetLastError());
  if (width == 64) {
    decode_block<64><<<n_blocks, kThreads, 0, st>>>(w, o, nb, an, nullptr, sv, sf, nullptr);
  } else {
    decode_block<32><<<n_blocks, kThreads, 0, st>>>(w, o, nb, an, nullptr, sv, sf, nullptr);
  }
  carry_scan<<<1, kThreads, 0, st>>>(sv, sf, cr, n_blocks);
  if (width == 64) {
    decode_block<64><<<n_blocks, kThreads, 0, st>>>(w, o, nb, an, cr, sv, sf, out);
  } else {
    decode_block<32><<<n_blocks, kThreads, 0, st>>>(w, o, nb, an, cr, sv, sf, out);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fpd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

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
// mod 2^64 over anchor-delimited segments, truncated to W bits (W = 32 or 64),
// at every position of the stream, padding included.
//
// What bounds it on the H100. Per position it reads 12 bytes of operands
// (offset, width, anchor flag) plus its share of the packed words, and
// writes W/8 bytes; the arithmetic is a few integer ops. It is bound by
// device-memory bytes (3.35 TB/s).
//
// What the design does about that: one pass that moves each byte about once.
//   - One launch of persistent blocks (as many as fit on the SMs). Each
//     block takes tiles of kTile positions in order from an atomic ticket
//     in the scratch (zeroed by a cudaMemsetAsync on the caller's stream
//     just before the launch).
//   - A tile's three operand rows are contiguous: one thread issues them as
//     cp.async.bulk copies into a 2-stage shared-memory ring completing on
//     an mbarrier, one tile ahead of the tile being scanned.
//   - Each thread reads its tokens through a 96-bit window of three
//     consecutive words (read-only path, through L1): one unaligned gather
//     per token with no branch on the token width. Offsets rise through a
//     stream, so a tile's words lie in one span and each word comes from
//     device memory about once.
//   - The tile's segmented scan is cub::BlockScan; carries across tiles
//     come from a decoupled look-back. Right after its scan a tile
//     publishes its inclusive value if it holds an anchor (nothing before
//     it can change that value) or else its aggregate, and stores its
//     results: exact from its first anchor on, the tile-local sums before
//     it. Its look-back is deferred by one tile: after the block's next
//     scan, warp 0 reads 32 predecessors at a time back to an inclusive
//     one (by then they have long published), an anchor-free tile
//     publishes its inclusive value, and the block adds the carry in place
//     to the positions before the first anchor (none when the tile starts
//     with one; the whole tile only in an anchor-free run). Nothing is
//     waited on before a tile is published, and tickets are taken in
//     order, so every wait ends.
//   - Tile status: for W = 32 the {status, 32-bit value} pair is one 64-bit
//     word, written and read whole. For W = 64 the aggregate and the
//     inclusive value have their own words; each is written before its
//     status, which is stored with release semantics and loaded with
//     acquire semantics before the value.
//   - Each thread stores its 8 consecutive W-bit results as 16-byte vectors.
//   The bound counts n real values; the kernel also produces the padding
//   tail of the stream's power-of-two block count, which its contract
//   includes.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // 2048 positions: two stream blocks
constexpr int kStreamBlock = 1024;        // the stream's padding unit
constexpr int kStages = 2;
constexpr int kRowBytes = kTile * 4;      // one operand row of a tile
constexpr int kSmemBytes = kStages * 3 * kRowBytes;

constexpr uint32_t kAggregate = 1;  // tile status: aggregate published
constexpr uint32_t kInclusive = 2;  // inclusive prefix (through this tile) published

template <typename V>
struct SegVal {
  V v;
  int f;  // an anchor was seen in this span
};

template <typename V>
struct SegOp {
  __device__ __forceinline__ SegVal<V> operator()(const SegVal<V>& a, const SegVal<V>& b) const {
    SegVal<V> r;
    r.v = b.f ? b.v : a.v + b.v;
    r.f = a.f | b.f;
    return r;
  }
};

template <int W>
struct Word;
template <>
struct Word<32> {
  using T = uint32_t;
};
template <>
struct Word<64> {
  using T = unsigned long long;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Contiguous global -> shared copy by the bulk-copy engine (16-byte multiples).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed64(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ unsigned long long ld_relaxed64(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Tile status in the scratch. W = 32: status[t] = status << 32 | value.
// W = 64: status word, aggregate and inclusive value, each its own array.
template <int W>
struct TileStatus;

template <>
struct TileStatus<32> {
  unsigned long long* word;
  __device__ void init(unsigned long long* s, int) { word = s; }
  __device__ void publish(int t, uint32_t status, uint32_t v) {
    st_relaxed64(word + t, (static_cast<unsigned long long>(status) << 32) | v);
  }
  __device__ uint32_t read(int t, uint32_t* v) const {
    const unsigned long long x = ld_relaxed64(word + t);
    *v = static_cast<uint32_t>(x);
    return static_cast<uint32_t>(x >> 32);
  }
};

template <>
struct TileStatus<64> {
  uint32_t* status;
  unsigned long long* agg;
  unsigned long long* incl;
  __device__ void init(unsigned long long* s, int n_tiles) {
    status = reinterpret_cast<uint32_t*>(s);  // n_tiles words in the zeroed region
    agg = s + n_tiles;
    incl = s + 2 * static_cast<long long>(n_tiles);
  }
  __device__ void publish(int t, uint32_t st, unsigned long long v) {
    st_relaxed64((st == kInclusive ? incl : agg) + t, v);
    st_release(status + t, st);  // the value is visible before the status
  }
  __device__ uint32_t read(int t, unsigned long long* v) const {
    const uint32_t st = ld_acquire(status + t);
    *v = st == kInclusive ? ld_relaxed64(incl + t) : st == kAggregate ? ld_relaxed64(agg + t) : 0ull;
    return st;
  }
};

// The value of stream position i: raw bits for an anchor, else the
// un-zigzagged delta (both as 64-bit two's complement), truncated to V.
template <typename V>
__device__ __forceinline__ SegVal<V> load_value(const uint32_t* __restrict__ words, int32_t off_i,
                                                int32_t n, int32_t anc) {
  const uint32_t off = static_cast<uint32_t>(off_i);
  const uint32_t w0i = off >> 5;
  const uint32_t s = off & 31u;
  const unsigned long long lo64 =
      static_cast<unsigned long long>(__ldg(words + w0i)) |
      (static_cast<unsigned long long>(__ldg(words + w0i + 1)) << 32);
  const unsigned long long w2 = __ldg(words + w0i + 2);
  // s + n <= 31 + 64 < 96: the token lies inside the three-word window.
  // A shift by 64 is undefined, so the s == 0 case selects instead.
  unsigned long long tok = (lo64 >> s) | (s ? (w2 << (64u - s)) : 0ull);
  // n in [1, 64]; 1 << 64 is undefined, so n == 64 takes the full mask.
  const unsigned long long mask = n >= 64 ? ~0ull : ((1ull << n) - 1ull);
  tok &= mask;
  SegVal<V> r;
  r.f = anc != 0;
  r.v = static_cast<V>(r.f ? tok : ((tok >> 1) ^ (0ull - (tok & 1ull))));
  return r;
}

template <int W>
// 3 blocks an SM: 85 registers a thread at most (77 used, no spills on sm_90a)
__global__ void __launch_bounds__(kThreads, 3)
decode_stream_kernel(const uint32_t* __restrict__ words, const int32_t* __restrict__ tok_off,
                     const int32_t* __restrict__ nbits, const int32_t* __restrict__ anchor,
                     long long n_pos, int n_tiles, unsigned long long* __restrict__ scratch,
                     typename Word<W>::T* __restrict__ out) {
  using V = typename Word<W>::T;
  using Scan = cub::BlockScan<SegVal<V>, kThreads>;
  extern __shared__ __align__(128) unsigned char ring[];  // [stage][row][kTile] int32
  __shared__ typename Scan::TempStorage scan_temp;
  __shared__ __align__(8) unsigned long long full[kStages];
  __shared__ int s_tile[kStages];
  __shared__ V s_prefix;
  __shared__ int s_lead[kThreads / 32];  // per warp: positions before the tile's first anchor

  unsigned int* ticket = reinterpret_cast<unsigned int*>(scratch);
  TileStatus<W> status;
  status.init(scratch + 1, n_tiles);
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  // The producer (thread 0): take the next ticket and start its copies.
  auto fetch = [&](int stage) {
    const int t = static_cast<int>(atomicAdd(ticket, 1u));
    s_tile[stage] = t;
    if (t < n_tiles) {
      const long long p0 = static_cast<long long>(t) * kTile;
      const long long left = n_pos - p0;
      const uint32_t bytes = static_cast<uint32_t>(left < kTile ? left : kTile) * 4u;
      const uint32_t bar = smem_u32(&full[stage]);
      const uint32_t dst = smem_u32(ring + stage * 3 * kRowBytes);
      // the ring was last read through the generic proxy; order that before the copy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(bar, 3 * bytes);
      bulk_load(dst, tok_off + p0, bytes, bar);
      bulk_load(dst + kRowBytes, nbits + p0, bytes, bar);
      bulk_load(dst + 2 * kRowBytes, anchor + p0, bytes, bar);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fetch(0);
  }
  __syncthreads();

  // The tile scanned last, whose carry is still to come: its look-back
  // runs after the next tile's scan, when its predecessors have long
  // published, and its positions before the first anchor (stored without
  // the carry) are then fixed up in place.
  int pend_t = -1, pend_lead = 0;
  long long pend_p0 = 0;
  SegVal<V> pend_total;
  pend_total.v = 0;
  pend_total.f = 1;

  for (int it = 0;; ++it) {
    const int stage = it & 1;
    const int t = s_tile[stage];
    long long p0 = 0;
    SegVal<V> total;
    total.v = 0;
    total.f = 1;
    if (t < n_tiles) {
      // one tile ahead: its stage was freed by the barriers of the last iteration
      if (tid == 0) fetch(stage ^ 1);
      mbar_wait(smem_u32(&full[stage]), (it >> 1) & 1);

      p0 = static_cast<long long>(t) * kTile;
      const long long left = n_pos - p0;
      const int tile_len = static_cast<int>(left < kTile ? left : kTile);
      const int i0 = tid * kItems;
      SegVal<V> items[kItems];
      if (i0 < tile_len) {  // tile_len is a multiple of 1024: all 8 or none
        const int32_t* rows = reinterpret_cast<const int32_t*>(ring + stage * 3 * kRowBytes);
        int4 o[2], b[2], a[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          o[h] = reinterpret_cast<const int4*>(rows + i0)[h];
          b[h] = reinterpret_cast<const int4*>(rows + kTile + i0)[h];
          a[h] = reinterpret_cast<const int4*>(rows + 2 * kTile + i0)[h];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          items[4 * h + 0] = load_value<V>(words, o[h].x, b[h].x, a[h].x);
          items[4 * h + 1] = load_value<V>(words, o[h].y, b[h].y, a[h].y);
          items[4 * h + 2] = load_value<V>(words, o[h].z, b[h].z, a[h].z);
          items[4 * h + 3] = load_value<V>(words, o[h].w, b[h].w, a[h].w);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kItems; ++k) {  // past the stream's end: the identity, not stored
          items[k].v = 0;
          items[k].f = 0;
        }
      }
      Scan(scan_temp).InclusiveScan(items, items, SegOp<V>(), total);
      // A tile with an anchor publishes its inclusive value at once, any
      // other its aggregate; nothing is waited on before this.
      if (tid == 0) status.publish(t, t == 0 || total.f ? kInclusive : kAggregate, total.v);

      // Store now: exact after the tile's first anchor, the local sum before it.
      int lead = 0;
      if (i0 < tile_len) {
        V* dst = out + p0 + i0;
#pragma unroll
        for (int k = 0; k < kItems; ++k) lead += !items[k].f;
        if (W == 64) {
#pragma unroll
          for (int k = 0; k < kItems; k += 2)
            reinterpret_cast<ulonglong2*>(dst)[k / 2] =
                make_ulonglong2(static_cast<unsigned long long>(items[k].v),
                                static_cast<unsigned long long>(items[k + 1].v));
        } else {
#pragma unroll
          for (int k = 0; k < kItems; k += 4)
            reinterpret_cast<uint4*>(dst)[k / 4] =
                make_uint4(static_cast<uint32_t>(items[k].v), static_cast<uint32_t>(items[k + 1].v),
                           static_cast<uint32_t>(items[k + 2].v),
                           static_cast<uint32_t>(items[k + 3].v));
        }
      }
      lead = __reduce_add_sync(0xFFFFFFFFu, static_cast<uint32_t>(lead));
      if (lane == 0) s_lead[tid >> 5] = lead;
    } else {
      __syncthreads();  // no scan this time: s_prefix is read until here
    }

    if (tid < 32 && pend_t > 0 && pend_lead > 0) {
      // warp 0: the carry into the pending tile, 32 predecessors at a time
      V prefix = 0;
      int end = pend_t - 1;  // the window is tiles end-31 .. end, lane 31 = end
      while (true) {
        const int j = end - (31 - lane);
        uint32_t st;
        V v;
        do {
          if (j >= 0) {
            st = status.read(j, &v);
          } else {
            st = kAggregate;  // before tile 0: neutral (tile 0 is always inclusive)
            v = 0;
          }
        } while (__any_sync(0xFFFFFFFFu, st == 0u));
        const unsigned incl = __ballot_sync(0xFFFFFFFFu, st == kInclusive);
        const int from = incl ? 31 - __clz(incl) : 0;  // highest inclusive lane
        V x = lane >= from ? v : V(0);
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xFFFFFFFFu, x, d);
        prefix += x;
        if (incl) break;
        end -= 32;
      }
      if (lane == 0) {
        if (!pend_total.f) status.publish(pend_t, kInclusive, prefix + pend_total.v);
        s_prefix = prefix;
      }
    }
    __syncthreads();
    if (pend_t > 0 && pend_lead > 0) {
      // positions before the pending tile's first anchor: add the carry
      const V prefix = s_prefix;
      for (int i = tid; i < pend_lead; i += kThreads) out[pend_p0 + i] += prefix;
    }
    if (t >= n_tiles) break;
    pend_t = t;
    pend_p0 = p0;
    pend_total = total;
    pend_lead = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) pend_lead += s_lead[w];
  }
}

template <int W>
int launch(const uint32_t* w, const int32_t* o, const int32_t* nb, const int32_t* an,
           long long n_pos, int n_tiles, unsigned long long* scratch, void* out,
           cudaStream_t st) {
  auto kern = decode_stream_kernel<W>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long grid = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > n_tiles) grid = n_tiles;
  kern<<<static_cast<int>(grid), kThreads, kSmemBytes, st>>>(
      w, o, nb, an, n_pos, n_tiles, scratch,
      static_cast<typename Word<W>::T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Scratch words (uint64) the decode of n_blocks stream blocks needs.
long long fpd_scratch_words(int n_blocks) {
  const long long n_tiles = (static_cast<long long>(n_blocks) * kStreamBlock + kTile - 1) / kTile;
  return 1 + 3 * n_tiles;
}

// words: n_words uint32 (>= 2 spill words after the last token);
// tok_off/nbits/anchor: n_blocks * 1024 int32 each, 16-byte aligned;
// scratch: fpd_scratch_words(n_blocks) uint64 (zeroed here, on the stream);
// out: n_blocks * 1024 int32 (width 32) or int64 (width 64), 16-byte
// aligned. One memset and one launch. Returns a cudaError_t.
int fpd_decode_stream(const void* words, const void* tok_off, const void* nbits,
                      const void* anchor, int n_blocks, int width, void* scratch, void* out,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_blocks <= 0) return static_cast<int>(cudaGetLastError());
  const long long n_pos = static_cast<long long>(n_blocks) * kStreamBlock;
  const int n_tiles = static_cast<int>((n_pos + kTile - 1) / kTile);
  auto* s = static_cast<unsigned long long*>(scratch);
  // the ticket and the status words (the values need no zeroing)
  cudaError_t e = cudaMemsetAsync(s, 0, (1 + static_cast<size_t>(n_tiles)) * 8, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto* w = static_cast<const uint32_t*>(words);
  auto* o = static_cast<const int32_t*>(tok_off);
  auto* nb = static_cast<const int32_t*>(nbits);
  auto* an = static_cast<const int32_t*>(anchor);
  return width == 64 ? launch<64>(w, o, nb, an, n_pos, n_tiles, s, out, st)
                     : launch<32>(w, o, nb, an, n_pos, n_tiles, s, out, st);
}

const char* fpd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

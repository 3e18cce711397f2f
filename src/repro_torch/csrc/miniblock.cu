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
// w (a width outside the format unpacks as zeros), replace each position
// that live exception slots hit by the sum of their values, un-zigzag,
// inclusive prefix sum mod 2^32, add the anchor.
//
// What bounds them on the H100. Encode reads 4 bytes a value and writes
// the dense outputs (4 bytes a value of packed words plus about 0.5 of
// exception slots and per-block scalars); decode reads the valid payload
// words and live exception slots and writes 4 bytes a value. A few dozen
// integer operations a value: both are bound by device-memory bytes
// (3.35 TB/s).
//
// What the design does about that.
// Encode: one warp per miniblock, persistent warps (as many as fit on the
// SMs), so many miniblocks are in flight on every SM. Each warp keeps a
// 2-stage ring of 4 KB in shared memory: the next miniblock arrives by a
// cp.async.bulk copy (completing on an mbarrier) while the current one is
// encoded, and the warp never waits at a block barrier. Lane l holds the
// 32 consecutive values 32l..32l+31 in registers. n_over(w) for all
// twelve candidates is counted without atomics: each lane adds, for each
// value, a thermometer code of the candidates below its bit length (a
// 33-entry shared table) into 6-bit fields of three registers, and one
// warp reduction per candidate sums the fields. The width is chosen in
// parallel: lane c forms candidate c's key (cost << 6 | w), infeasible
// lanes and w = 32 the key of (32 * 1024, 32), and a warp minimum picks
// the lexicographic (cost, w) minimum, which equals the reference's
// ascending scan with strict improvement from w = 32 (no feasible
// candidate can cost exactly 32 * 1024: that needs w >= 29). Exceptions
// are ranked in position order by a warp scan of the per-lane counts. A
// lane's 32 values fill exactly its own w output words, packed with shifts
// known at compile time (one instantiation per width); the words are
// staged in the spent ring stage (16-byte units swizzled against bank
// conflicts) and stored coalesced, 16 bytes a lane.
// Decode: the same shape. One warp per miniblock, persistent warps, and a
// 3-stage ring per warp: lane k of a warp loads the scalars (width,
// exception count, anchor) of the warp's k-th next block, so the copies
// need no dependent load first, and lane 0 issues each block's copies
// two blocks ahead: only the 128 * w valid payload bytes and the live
// prefixes of the exception rows (rounded up to 16 bytes), completing on
// the stage's mbarrier; w = 0, a width outside the format and no live slot
// arrive with no transaction bytes. Lane l unpacks its values 32l..32l+31
// from its own words [l*w, l*w + w) with shifts known at compile time (the
// inverse of pack_stage<W>). Live exception slots (slot < count, position
// in [0, 1024)) replace a position by the sum of their values mod 2^32, as
// the reference's inject_exceptions does: hit positions are zeroed in the
// stage, then the values are added with shared-memory atomics, whose order
// does not matter. Un-zigzag, a serial inclusive sum over the lane's 32
// values and a warp scan of the lane totals give the prefix sum; the
// outputs are staged swizzled in the spent stage and stored coalesced.
// The TPU kernels' six packings combined by a masked sum and their
// one-hot exception contractions are dropped. All arithmetic is uint32:
// signed overflow is undefined in C++, and shifts by 32 are avoided.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;  // MINIBLOCK
constexpr int kMaxExc = 64;
constexpr int kExcBits = 48;
constexpr int kNumCand = 12;
// bit w set for every width a block may carry: 0 and the packing widths
constexpr unsigned long long kValidWidths =
    (1ull << 0) | (1ull << 1) | (1ull << 2) | (1ull << 3) | (1ull << 4) | (1ull << 6) |
    (1ull << 8) | (1ull << 10) | (1ull << 12) | (1ull << 16) | (1ull << 20) |
    (1ull << 24) | (1ull << 32);

// ---------------------------------------------------------------- encode
// One warp per miniblock, persistent: warp g of G encodes blocks g, g + G,
// ... Lane l holds the 32 consecutive values t = 32l + k (k = 0..31) in
// registers, so its zigzags pack into the output words [l*w, l*w + w) on
// their own: no value crosses into another lane's words.
constexpr int kEncWarps = 8;
constexpr int kEncThreads = kEncWarps * 32;
constexpr uint32_t kBlockBytes = kBlock * 4;
constexpr uint32_t kKey32 = ((kBlock * 32u) << 6) | 32u;  // (cost, w) of w = 32

struct __align__(16) EncWarpSmem {
  uint32_t ring[2][kBlock];          // input miniblocks, by bulk copy
  int32_t exc[2][kMaxExc];           // exception positions, values
  unsigned long long full[2];        // one mbarrier per ring stage
};
constexpr int kEncSmem = kEncWarps * static_cast<int>(sizeof(EncWarpSmem));

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// bytes (a multiple of 16) global -> shared by the bulk-copy engine,
// completing on the mbarrier at shared address bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One miniblock (4 KB) global -> shared by the bulk-copy engine.
__device__ __forceinline__ void fetch_block(uint32_t* dst, const uint32_t* src,
                                            unsigned long long* bar) {
  const uint32_t b = smem_u32(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
               "r"(kBlockBytes)
               : "memory");
  bulk_copy(dst, src, kBlockBytes, b);
}

// #candidates (0, 1, 2, 3, 4, 6, 8, 10, 12, 16, 20, 24) below nb, for nb in [0, 32]
__device__ __forceinline__ int n_below(int nb) {
  return nb <= 4 ? nb : nb <= 12 ? 4 + ((nb - 3) >> 1) : nb <= 24 ? 8 + ((nb - 9) >> 2) : 12;
}

// candidate c's width, c in [0, 12)
__device__ __forceinline__ int cand_width(int c) {
  return c <= 4 ? c : c <= 8 ? 2 * c - 4 : 4 * c - 20;
}

// field c of a lane's candidate counts: 6-bit fields, five to a word
__device__ __forceinline__ uint32_t field(const uint32_t (&acc)[3], int c) {
  const uint32_t word = c < 5 ? acc[0] : c < 10 ? acc[1] : acc[2];  // no dynamic register index
  return (word >> (6 * (c % 5))) & 63u;
}

// Staging layout of the packed words in shared memory: 16-byte unit u
// lies at u ^ ((u >> 3) & 7). The lanes' vector writes at a stride of W
// words and the coalesced reads of units 32q + l then hit distinct banks
// (but for a few ways at W = 24 and W = 32).
__device__ __forceinline__ int swz(int o) {
  const int u = o >> 2;
  return ((u ^ ((u >> 3) & 7)) << 2) | (o & 3);
}

// Lane-local packing at width W: the lane's 32 zigzags become its W output
// words [l*W, l*W + W) (all indices known at compile time), written to the
// staging area as 16- or 8-byte vectors where W allows.
template <int W>
__device__ __forceinline__ void pack_stage(const uint32_t (&z)[32], uint32_t* __restrict__ stage,
                                           int lane) {
  uint32_t words[W];
#pragma unroll
  for (int i = 0; i < W; ++i) words[i] = 0;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const uint32_t v = W == 32 ? z[k] : (z[k] & ((1u << (W % 32)) - 1u));
    const int j = (k * W) >> 5;
    const int s = (k * W) & 31;
    words[j] |= v << s;
    if (s + W > 32 && j + 1 < W) words[j + 1] |= v >> (32 - s);
  }
  const int o = lane * W;
  if (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4)
      *reinterpret_cast<uint4*>(stage + swz(o + i)) =
          make_uint4(words[i], words[i + 1], words[i + 2], words[i + 3]);
  } else if (W % 2 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 2)
      *reinterpret_cast<uint2*>(stage + swz(o + i)) = make_uint2(words[i], words[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) stage[swz(o + i)] = words[i];
  }
}

__global__ void __launch_bounds__(kEncThreads)
encode_kernel(const uint32_t* __restrict__ x, int n_blocks, int32_t* __restrict__ packed,
              int32_t* __restrict__ widths, int32_t* __restrict__ anchors,
              int32_t* __restrict__ exc_idx, int32_t* __restrict__ exc_val,
              int32_t* __restrict__ exc_count) {
  extern __shared__ __align__(128) unsigned char smem[];
  // thermometer codes: for bit length nb, 1 in field c of every candidate c below nb
  __shared__ uint4 therm[33];
  if (threadIdx.x < 33) {
    const int m = n_below(threadIdx.x);
    uint32_t acc[3] = {0, 0, 0};
#pragma unroll
    for (int c = 0; c < kNumCand; ++c)
      if (c < m) acc[c / 5] |= 1u << (6 * (c % 5));
    therm[threadIdx.x] = make_uint4(acc[0], acc[1], acc[2], 0);
  }
  __syncthreads();  // the only block-wide barrier: warps run alone from here

  const int lane = threadIdx.x & 31;
  EncWarpSmem& ws = reinterpret_cast<EncWarpSmem*>(smem)[threadIdx.x >> 5];
  const long long g = static_cast<long long>(blockIdx.x) * kEncWarps + (threadIdx.x >> 5);
  const long long step = static_cast<long long>(gridDim.x) * kEncWarps;
  if (g >= n_blocks) return;
  if (lane == 0) {
    for (int s = 0; s < 2; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&ws.full[s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fetch_block(ws.ring[0], x + g * kBlock, &ws.full[0]);
  }
  __syncwarp();

  int it = 0;
  for (long long blk = g; blk < n_blocks; blk += step, ++it) {
    const int s = it & 1;
    // the next miniblock arrives while this one is encoded; its stage was
    // released (fence.proxy.async + __syncwarp) at the end of the last block
    if (lane == 0 && blk + step < n_blocks)
      fetch_block(ws.ring[s ^ 1], x + (blk + step) * kBlock, &ws.full[s ^ 1]);
    mbar_wait(smem_u32(&ws.full[s]), (it >> 1) & 1);

    uint32_t z[32];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint4 t = reinterpret_cast<const uint4*>(ws.ring[s])[8 * lane + q];
      z[4 * q] = t.x;
      z[4 * q + 1] = t.y;
      z[4 * q + 2] = t.z;
      z[4 * q + 3] = t.w;
    }
    const uint32_t anchor = __shfl_sync(0xFFFFFFFFu, z[0], 0);
    const uint32_t before = __shfl_up_sync(0xFFFFFFFFu, z[31], 1);
    __syncwarp();  // the stage is read: it now stages this block's packed words

    // deltas (wrapping) and zigzags in place; per-lane counts of nb > w_c
    // for every candidate, from the thermometer codes
    uint32_t acc[3] = {0, 0, 0};
    uint32_t prev = lane ? before : z[0];
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const uint32_t d = z[k] - prev;
      prev = z[k];
      z[k] = (d << 1) ^ (0u - (d >> 31));
      const uint4 th = therm[32 - __clz(z[k])];
      acc[0] += th.x;
      acc[1] += th.y;
      acc[2] += th.z;
    }

    // width: lane c takes candidate c's (cost, w); the warp's minimum key is
    // the lexicographic (cost, w) minimum, with w = 32 at cost 32 * 1024
    uint32_t mine = 0;
#pragma unroll
    for (int c = 0; c < kNumCand; ++c) {
      const uint32_t n_c = __reduce_add_sync(0xFFFFFFFFu, field(acc, c));
      if (lane == c) mine = n_c;
    }
    uint32_t key = kKey32;
    if (lane < kNumCand && mine <= kMaxExc) {
      const int wc = cand_width(lane);
      key = (static_cast<uint32_t>(kBlock * wc + kExcBits * static_cast<int>(mine)) << 6) |
            static_cast<uint32_t>(wc);
    }
    key = __reduce_min_sync(0xFFFFFFFFu, key);
    const int w = static_cast<int>(key & 63u);
    const int count = w == 32 ? 0 : static_cast<int>(((key >> 6) - kBlock * w) / kExcBits);

    // exceptions (count <= 64), in position order: lane l's come after the
    // exceptions of lanes below it (a warp scan of the per-lane counts)
    ws.exc[0][lane] = 0;
    ws.exc[0][lane + 32] = 0;
    ws.exc[1][lane] = 0;
    ws.exc[1][lane + 32] = 0;
    __syncwarp();
    if (count > 0) {
      const int n_mine = static_cast<int>(field(acc, n_below(w + 1) - 1));
      int r = n_mine;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xFFFFFFFFu, r, d);
        if (lane >= d) r += up;
      }
      r -= n_mine;  // exclusive
      if (n_mine > 0) {
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          if (32 - __clz(z[k]) > w) {
            ws.exc[0][r] = 32 * lane + k;
            ws.exc[1][r] = static_cast<int32_t>(z[k]);
            ++r;
          }
        }
      }
    }

    // pack into the spent input stage, then store coalesced, 16 bytes a lane
    uint32_t* stage = ws.ring[s];
    switch (w) {
      case 1: pack_stage<1>(z, stage, lane); break;
      case 2: pack_stage<2>(z, stage, lane); break;
      case 3: pack_stage<3>(z, stage, lane); break;
      case 4: pack_stage<4>(z, stage, lane); break;
      case 6: pack_stage<6>(z, stage, lane); break;
      case 8: pack_stage<8>(z, stage, lane); break;
      case 10: pack_stage<10>(z, stage, lane); break;
      case 12: pack_stage<12>(z, stage, lane); break;
      case 16: pack_stage<16>(z, stage, lane); break;
      case 20: pack_stage<20>(z, stage, lane); break;
      case 24: pack_stage<24>(z, stage, lane); break;
      case 32: pack_stage<32>(z, stage, lane); break;
      default: break;  // w = 0: no payload
    }
    __syncwarp();
    uint4* row = reinterpret_cast<uint4*>(packed + blk * kBlock);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int u = 32 * q + lane;  // the words past the payload (u >= 8w) are 0
      row[u] = u < 8 * w ? reinterpret_cast<const uint4*>(stage)[u ^ ((u >> 3) & 7)]
                         : make_uint4(0u, 0u, 0u, 0u);
    }
    reinterpret_cast<int4*>(lane < 16 ? exc_idx + blk * kMaxExc : exc_val + blk * kMaxExc)[lane & 15] =
        reinterpret_cast<const int4*>(ws.exc[lane >> 4])[lane & 15];
    if (lane == 0) {
      widths[blk] = w;
      anchors[blk] = static_cast<int32_t>(anchor);
      exc_count[blk] = count;
    }
    // release the stage to the bulk-copy engine; the exception slots are
    // rewritten for the next block
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
  }
}

// ---------------------------------------------------------------- decode
// One warp per miniblock, persistent: warp g of G decodes blocks g, g + G,
// ... Each warp keeps a 3-stage ring: a stage holds the block's valid
// payload words (128 * w bytes) and the live prefixes of its exception
// rows, copied by the bulk-copy engine two blocks ahead. Lane l's values
// 32l..32l+31 start at bit 32l * w, so they lie in its own words
// [l*w, l*w + w) and unpack with shifts known at compile time.
constexpr int kDecWarps = 8;
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecStages = 3;

struct __align__(16) DecWarpSmem {
  uint32_t ring[kDecStages][kBlock];       // payload words in; staged output out
  int32_t exc[kDecStages][2][kMaxExc];     // live exception positions, values
  unsigned long long full[kDecStages];     // one mbarrier per ring stage
};
constexpr int kDecSmem = kDecWarps * static_cast<int>(sizeof(DecWarpSmem));

__device__ __forceinline__ bool known_width(int w) {
  return w >= 0 && w <= 32 && ((kValidWidths >> w) & 1ull);
}

// Live exception slots: slot < count, the count taken as is (above 64 all
// slots are live, at 0 or below none).
__device__ __forceinline__ int live_slots(int count) {
  return count <= 0 ? 0 : count >= kMaxExc ? kMaxExc : count;
}

// Lane 0: the copies of block blk (width w, as is; exception count cnt)
// into one stage. A block with nothing to copy (w = 0 or outside the
// format, no live slot) arrives with no transaction bytes.
__device__ __forceinline__ void fetch_decode(DecWarpSmem& ws, int s, long long blk, int w, int cnt,
                                             const uint32_t* __restrict__ packed,
                                             const int32_t* __restrict__ exc_idx,
                                             const int32_t* __restrict__ exc_val) {
  const uint32_t bar = smem_u32(&ws.full[s]);
  const uint32_t pay = known_width(w) ? 128u * static_cast<uint32_t>(w) : 0u;
  const uint32_t exc = (static_cast<uint32_t>(live_slots(cnt)) * 4u + 15u) & ~15u;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(pay + 2u * exc)
               : "memory");
  if (pay) bulk_copy(ws.ring[s], packed + blk * kBlock, pay, bar);
  if (exc) {
    bulk_copy(ws.exc[s][0], exc_idx + blk * kMaxExc, exc, bar);
    bulk_copy(ws.exc[s][1], exc_val + blk * kMaxExc, exc, bar);
  }
}

// Lane-local unpacking at width W: the exact inverse of pack_stage<W>.
// The lane's W words are read from the stage as 16- or 8-byte vectors
// where W allows.
template <int W>
__device__ __forceinline__ void unpack_stage(const uint32_t* __restrict__ stage, int lane,
                                             uint32_t (&z)[32]) {
  uint32_t words[W];
  const uint32_t* src = stage + lane * W;
  if (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const uint4 t = *reinterpret_cast<const uint4*>(src + i);
      words[i] = t.x;
      words[i + 1] = t.y;
      words[i + 2] = t.z;
      words[i + 3] = t.w;
    }
  } else if (W % 2 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 2) {
      const uint2 t = *reinterpret_cast<const uint2*>(src + i);
      words[i] = t.x;
      words[i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) words[i] = src[i];
  }
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int j = (k * W) >> 5;
    const int s = (k * W) & 31;
    uint32_t v = words[j] >> s;
    if (s + W > 32) v |= words[j + 1] << (32 - s);
    z[k] = W == 32 ? v : (v & ((1u << (W % 32)) - 1u));
  }
}

__global__ void __launch_bounds__(kDecThreads)
decode_kernel(const uint32_t* __restrict__ packed, const int32_t* __restrict__ widths,
              const int32_t* __restrict__ anchors, const int32_t* __restrict__ exc_idx,
              const int32_t* __restrict__ exc_val, const int32_t* __restrict__ exc_count,
              int n_blocks, uint32_t* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  DecWarpSmem& ws = reinterpret_cast<DecWarpSmem*>(smem)[threadIdx.x >> 5];
  const long long g = static_cast<long long>(blockIdx.x) * kDecWarps + (threadIdx.x >> 5);
  const long long step = static_cast<long long>(gridDim.x) * kDecWarps;
  if (g >= n_blocks) return;
  const int n_mine = static_cast<int>((n_blocks - 1 - g) / step) + 1;  // blocks of this warp

  // Scalars ahead: lane k holds the scalars of this warp's iteration
  // 32c + k, for the current chunk c (cur) and the next one (nxt).
  auto scalars = [&](int chunk, int& w, int& cnt, int& a) {
    const int it = 32 * chunk + lane;
    w = cnt = a = 0;
    if (it < n_mine) {
      const long long b = g + it * step;
      w = widths[b];
      cnt = exc_count[b];
      a = anchors[b];
    }
  };
  int cw, cc, ca, nw, nc, na;
  scalars(0, cw, cc, ca);
  scalars(1, nw, nc, na);

  if (lane == 0) {
    for (int s = 0; s < kDecStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&ws.full[s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kDecStages - 1; ++j) {
    const int w = __shfl_sync(0xFFFFFFFFu, cw, j);
    const int cnt = __shfl_sync(0xFFFFFFFFu, cc, j);
    if (lane == 0 && j < n_mine)
      fetch_decode(ws, j, g + j * step, w, cnt, packed, exc_idx, exc_val);
  }

  for (int it = 0; it < n_mine; ++it) {
    const long long blk = g + it * step;
    const int s = it % kDecStages;
    if (it > 0 && (it & 31) == 0) {
      cw = nw;
      cc = nc;
      ca = na;
      scalars((it >> 5) + 1, nw, nc, na);
    }
    // the copy two blocks ahead; its stage was released at the end of the
    // last iteration
    {
      const int j = it + kDecStages - 1;
      const bool same = (j >> 5) == (it >> 5);
      const int fw = __shfl_sync(0xFFFFFFFFu, same ? cw : nw, j & 31);
      const int fc = __shfl_sync(0xFFFFFFFFu, same ? cc : nc, j & 31);
      if (lane == 0 && j < n_mine)
        fetch_decode(ws, j % kDecStages, g + j * step, fw, fc, packed, exc_idx, exc_val);
    }
    const int w_in = __shfl_sync(0xFFFFFFFFu, cw, it & 31);
    const int count = __shfl_sync(0xFFFFFFFFu, cc, it & 31);
    const uint32_t anchor = static_cast<uint32_t>(__shfl_sync(0xFFFFFFFFu, ca, it & 31));
    mbar_wait(smem_u32(&ws.full[s]), (it / kDecStages) & 1);

    uint32_t* stage = ws.ring[s];
    uint32_t z[32];
    // a width outside the format unpacks as zeros, as the reference's
    // select over the packing widths does
    switch (known_width(w_in) ? w_in : 0) {
      case 1: unpack_stage<1>(stage, lane, z); break;
      case 2: unpack_stage<2>(stage, lane, z); break;
      case 3: unpack_stage<3>(stage, lane, z); break;
      case 4: unpack_stage<4>(stage, lane, z); break;
      case 6: unpack_stage<6>(stage, lane, z); break;
      case 8: unpack_stage<8>(stage, lane, z); break;
      case 10: unpack_stage<10>(stage, lane, z); break;
      case 12: unpack_stage<12>(stage, lane, z); break;
      case 16: unpack_stage<16>(stage, lane, z); break;
      case 20: unpack_stage<20>(stage, lane, z); break;
      case 24: unpack_stage<24>(stage, lane, z); break;
      case 32: unpack_stage<32>(stage, lane, z); break;
      default:
#pragma unroll
        for (int k = 0; k < 32; ++k) z[k] = 0;
        break;
    }
    __syncwarp();  // the payload is read: the stage now holds zigzags, then outputs

    const int live = live_slots(count);
    if (live > 0) {
      // exceptions as the reference's inject_exceptions: a position hit by
      // live slots takes the sum of their values mod 2^32. The zigzags go
      // through the stage (swizzled 16-byte units); hit positions are
      // zeroed, then the values added (uint32 addition commutes, so the
      // result does not depend on the order of the atomics).
#pragma unroll
      for (int q = 0; q < 8; ++q)
        *reinterpret_cast<uint4*>(stage + swz(32 * lane + 4 * q)) =
            make_uint4(z[4 * q], z[4 * q + 1], z[4 * q + 2], z[4 * q + 3]);
      __syncwarp();
      int pos[2];
      uint32_t val[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int slot = lane + 32 * h;
        pos[h] = slot < live ? ws.exc[s][0][slot] : -1;
        val[h] = slot < live ? static_cast<uint32_t>(ws.exc[s][1][slot]) : 0u;
        if (pos[h] >= 0 && pos[h] < kBlock) stage[swz(pos[h])] = 0u;
      }
      __syncwarp();
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (pos[h] >= 0 && pos[h] < kBlock) atomicAdd(stage + swz(pos[h]), val[h]);
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint4 t = *reinterpret_cast<const uint4*>(stage + swz(32 * lane + 4 * q));
        z[4 * q] = t.x;
        z[4 * q + 1] = t.y;
        z[4 * q + 2] = t.z;
        z[4 * q + 3] = t.w;
      }
    }

    // un-zigzag and the lane's inclusive sum, then a warp scan of the lane
    // totals; all uint32, wrapping mod 2^32
    uint32_t run = 0;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      run += (z[k] >> 1) ^ (0u - (z[k] & 1u));
      z[k] = run;
    }
    uint32_t incl = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t up = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += up;
    }
    const uint32_t base = anchor + (incl - run);

    // stage the outputs (each lane writes only its own units, which it
    // alone read above), then store coalesced, 16 bytes a lane
#pragma unroll
    for (int q = 0; q < 8; ++q)
      *reinterpret_cast<uint4*>(stage + swz(32 * lane + 4 * q)) =
          make_uint4(base + z[4 * q], base + z[4 * q + 1], base + z[4 * q + 2],
                     base + z[4 * q + 3]);
    __syncwarp();
    uint4* row = reinterpret_cast<uint4*>(out + blk * kBlock);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int u = 32 * q + lane;
      row[u] = reinterpret_cast<const uint4*>(stage)[u ^ ((u >> 3) & 7)];
    }
    // release the stage (payload and exception rows) to the bulk-copy engine
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// x: n_blocks * 1024 uint32 patterns, 16-byte aligned; packed: n_blocks * 1024 int32;
// widths, anchors, exc_count: n_blocks int32; exc_idx, exc_val:
// n_blocks * 64 int32. Returns cudaGetLastError().
int mb_encode_blocks(const void* x, int n_blocks, void* packed, void* widths,
                     void* anchors, void* exc_idx, void* exc_val, void* exc_count,
                     void* stream) {
  if (n_blocks <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t e = cudaFuncSetAttribute(encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kEncSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, encode_kernel, kEncThreads, kEncSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long grid = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const long long need = (static_cast<long long>(n_blocks) + kEncWarps - 1) / kEncWarps;
  if (grid > need) grid = need;
  encode_kernel<<<static_cast<int>(grid), kEncThreads, kEncSmem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), n_blocks, static_cast<int32_t*>(packed),
      static_cast<int32_t*>(widths), static_cast<int32_t*>(anchors),
      static_cast<int32_t*>(exc_idx), static_cast<int32_t*>(exc_val),
      static_cast<int32_t*>(exc_count));
  return static_cast<int>(cudaGetLastError());
}

// The six arrays of mb_encode_blocks in (packed, exc_idx and exc_val
// 16-byte aligned), n_blocks * 1024 uint32 patterns out.
int mb_decode_blocks(const void* packed, const void* widths, const void* anchors,
                     const void* exc_idx, const void* exc_val, const void* exc_count,
                     int n_blocks, void* out, void* stream) {
  if (n_blocks <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t e = cudaFuncSetAttribute(decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kDecSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_kernel, kDecThreads, kDecSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long grid = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const long long need = (static_cast<long long>(n_blocks) + kDecWarps - 1) / kDecWarps;
  if (grid > need) grid = need;
  decode_kernel<<<static_cast<int>(grid), kDecThreads, kDecSmem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(widths),
      static_cast<const int32_t*>(anchors), static_cast<const int32_t*>(exc_idx),
      static_cast<const int32_t*>(exc_val), static_cast<const int32_t*>(exc_count), n_blocks,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* mb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

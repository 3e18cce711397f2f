// Blocked online-softmax attention (forward) in bf16 on Hopper's tensor
// cores (sm_90a): wgmma fed by TMA through a ring of K/V tiles.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention
// for bf16 inputs (the LM stack's attention when a config selects
// attn_impl="flash"). float32 inputs stay on flash_attention.cu.
//
// What it computes. For each batch b and query head h (reading kv head
// h / group), logits = (q . k^T) * sm_scale with float32 accumulation of
// exact bf16 products; when causal, key col c is visible to query row r iff
// c <= r + (Sk - Sq) (the decode-aligned diagonal) and a hidden logit is
// -1e30; keys past Sk get weight 0. Key tiles wholly above the diagonal are
// skipped. Running max and denominator are float32 (the denominator sums
// the float32 P), P is rounded to bf16 for P.V as the reference's oracle
// and SDPA's flash backend do, the accumulator is float32, and the output
// is acc / max(l, 1e-30) rounded once to bf16 (nearest even). Any Sq and
// Sk. Query tiles are laid out as the reference lays out its front-padded
// 128-row blocks (the first tile starts at row -((-Sq) mod 128)), and key
// tiles are 128 wide, so a causal row that sees no key (r < Sq - Sk) gets
// the TPU kernel's own result for its tile schedule.
//
// What bounds it on the H100. At the LM path's shape (2 x 32 heads, 4096 x
// 4096 causal, D = 128) it does 2.75e11 flops against 168 MB of q, k, v and
// o: bound by operations, 0.278 ms at the 989 TFLOP/s bf16 tensor-core peak.
//
// What the design does about that. One block per (128-row query tile,
// b*Hq head), longest causal tiles first; three warpgroups:
//   - a producer warpgroup (down to 40 registers by setmaxnreg) whose one
//     thread issues TMA loads: the Q tile once, then K and V tiles of 128
//     keys into a ring of kStages stages guarded by full/empty mbarriers;
//   - two consumer warpgroups (up to 232 registers), 64 query rows each:
//     S = Q.K^T by wgmma with both operands in shared memory (K-major as
//     they lie, D contiguous), the online softmax on the accumulator
//     fragment (row max and sum over the quad by shuffles, exp2 with
//     sm_scale*log2(e) folded in, masks only on tiles that cross the
//     diagonal or the Sk edge), then O += P.V by wgmma with P converted in
//     registers to bf16 A fragments (the m64nNk16 accumulator layout is the
//     A-register layout) and V read MN-major (transpose bit set).
// Tensor maps are 4-D (D, S, H, B) over the tensors' own strides, so the
// model's transposed (B, S, H, D) views load without a copy; rows a box
// reads past S (or before 0) come in as zeros. A 128-byte swizzle takes
// boxes of at most 64 bf16 columns, so at D = 128 a tile is two boxes
// (D = 32 uses the 64-byte swizzle), and the wgmma descriptors match.
// Left for later work: ping-pong scheduling of the two consumer
// warpgroups, overlapping the softmax with the next tile's products, and a
// TMA store of O through shared memory.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 128;             // query rows per block
constexpr int kBK = 128;             // keys per tile
constexpr int kStages = 2;           // K/V ring depth
constexpr int kConsumers = 2;        // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kHidden2 = -1e30f * kLog2e;  // a hidden logit (-1e30) in the log2 domain

template <int D>
struct Cfg {
  static constexpr int SW = D * 2 < 128 ? D * 2 : 128;  // swizzle span = bytes of a box row
  static constexpr int CB = SW / 2;                     // bf16 columns per box
  static constexpr int NB = D / CB;                     // boxes per 128-row tile
  static constexpr int CHUNK = kBK * SW;                // bytes of one box
  static constexpr int TILE = kBK * D * 2;              // bytes of one tile (Q, K or V)
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2; // wgmma descriptor swizzle mode
  static constexpr int BARS = 1 + 3 * kStages;          // full_q, full_k[], full_v[], empty[]
  static constexpr int SMEM = (1 + 2 * kStages) * TILE + 8 * BARS + 1024;  // + alignment slack
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode in bits 62-63.
__device__ __forceinline__ uint64_t mdesc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                          uint64_t layout) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma (issue ... wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128]^T, A and B K-major in shared memory.
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x N] += A[64 x 16] (registers) . B[16 x N], B MN-major in shared memory.
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void mma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int hq,
               int group, int seq_q, int seq_k, int pad, float scale_log2, int causal) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms need 1 KB
  const uint32_t s_q = base;
  const uint32_t s_k = base + C::TILE;                      // + stage * TILE
  const uint32_t s_v = base + (1 + kStages) * C::TILE;      // + stage * TILE
  const uint32_t bars = base + (1 + 2 * kStages) * C::TILE;
  const uint32_t full_q = bars;
  const uint32_t full_k = bars + 8;                         // + 8 * stage
  const uint32_t full_v = bars + 8 * (1 + kStages);
  const uint32_t empty = bars + 8 * (1 + 2 * kStages);

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int hk = h / group;
  const int row0 = qt * kBQ - pad;  // first query row of the tile; rows < 0 are padding
  const int off = seq_k - seq_q;
  int n_tiles = (seq_k + kBK - 1) / kBK;
  if (causal) {
    // process key tile t iff t * kBK <= row0 + kBQ - 1 + off (the TPU kernel's skip)
    const long long lim = static_cast<long long>(row0) + kBQ - 1 + off;
    n_tiles = lim < 0 ? 0 : min(n_tiles, static_cast<int>(lim / kBK) + 1);
  }

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumers);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == kConsumers) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 128 * kConsumers) {
      mbar_expect_tx(full_q, C::TILE);
#pragma unroll
      for (int c = 0; c < C::NB; ++c)
        tma_load_4d(s_q + c * C::CHUNK, &tq, full_q, c * C::CB, row0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(empty + 8 * s, ((t / kStages) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(full_k + 8 * s, C::TILE);
#pragma unroll
        for (int c = 0; c < C::NB; ++c)
          tma_load_4d(s_k + s * C::TILE + c * C::CHUNK, &tk, full_k + 8 * s, c * C::CB,
                      t * kBK, hk, b);
        mbar_expect_tx(full_v + 8 * s, C::TILE);
#pragma unroll
        for (int c = 0; c < C::NB; ++c)
          tma_load_4d(s_v + s * C::TILE + c * C::CHUNK, &tv, full_v + 8 * s, c * C::CB,
                      t * kBK, hk, b);
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (tid & 127) >> 5;
    const int lane = tid & 31;
    const int wg_row0 = row0 + 64 * wg;
    const int r_lo = wg_row0 + 16 * warp + (lane >> 2);  // rows of d[4j..4j+1]; +8 for d[4j+2..3]
    const int cq = 2 * (lane & 3);                       // column within an 8-column block
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_lo = kHidden2, m_hi = kHidden2, l_lo = 0.f, l_hi = 0.f;
    const uint32_t q_wg = s_q + 64 * wg * C::SW;

    mbar_wait(full_q, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t par = (t / kStages) & 1;
      const int k0 = t * kBK;
      float sc[64];
      mbar_wait(full_k + 8 * s, par);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t at = (kk * 16 / C::CB) * C::CHUNK + (kk * 16 % C::CB) * 2;
        mma_ss_n128(sc, mdesc(q_wg + at, 16, 8 * C::SW, C::LAYOUT),
                    mdesc(s_k + s * C::TILE + at, 16, 8 * C::SW, C::LAYOUT), kk > 0);
      }
      wg_commit();
      wg_wait0();
      fence_regs(sc);

      // logits in the log2 domain; masks only where the tile crosses the
      // Sk edge or this warpgroup's diagonal
      const bool edge = k0 + kBK > seq_k;
      const bool diag = causal && k0 + kBK - 1 > wg_row0 + off;
      if (edge || diag) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int col = k0 + 8 * (i >> 2) + cq + (i & 1);
          const int row = r_lo + ((i & 2) ? 8 : 0);
          float x = sc[i] * scale_log2;
          if (col >= seq_k) {
            x = __int_as_float(0xFF800000);  // -inf past the keys: weight exactly 0
          } else if (causal && col > row + off) {
            x = kHidden2;
          }
          sc[i] = x;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) sc[i] *= scale_log2;
      }

      float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int w = 1; w < 4; w <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xFFFFFFFFu, mx_lo, w));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xFFFFFFFFu, mx_hi, w));
      }
      const float a_lo = exp2f(m_lo - mx_lo);
      const float a_hi = exp2f(m_hi - mx_hi);
      m_lo = mx_lo;
      m_hi = mx_hi;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        sc[4 * j] = exp2f(sc[4 * j] - mx_lo);
        sc[4 * j + 1] = exp2f(sc[4 * j + 1] - mx_lo);
        sc[4 * j + 2] = exp2f(sc[4 * j + 2] - mx_hi);
        sc[4 * j + 3] = exp2f(sc[4 * j + 3] - mx_hi);
        sum_lo += sc[4 * j] + sc[4 * j + 1];
        sum_hi += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l_lo = l_lo * a_lo + sum_lo;  // per-thread partial sums; the quad adds them at the end
      l_hi = l_hi * a_hi + sum_hi;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= a_lo;
        acc[4 * j + 1] *= a_lo;
        acc[4 * j + 2] *= a_hi;
        acc[4 * j + 3] *= a_hi;
      }
      uint32_t pa[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      mbar_wait(full_v + 8 * s, par);
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        mma_rs<D>(acc, pa[kk],
                  mdesc(s_v + s * C::TILE + kk * 16 * C::SW, C::CHUNK, 8 * C::SW, C::LAYOUT));
      wg_commit();
      wg_wait0();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with the stage
    }

#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      l_lo += __shfl_xor_sync(0xFFFFFFFFu, l_lo, w);
      l_hi += __shfl_xor_sync(0xFFFFFFFFu, l_hi, w);
    }
    const float den_lo = fmaxf(l_lo, 1e-30f);
    const float den_hi = fmaxf(l_hi, 1e-30f);
    __nv_bfloat16* ob = o + static_cast<long long>(bh) * seq_q * D + cq;
    if (r_lo >= 0 && r_lo < seq_q) {
      uint32_t* p = reinterpret_cast<uint32_t*>(ob + static_cast<long long>(r_lo) * D);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        p[4 * j] = pack_bf16(acc[4 * j] / den_lo, acc[4 * j + 1] / den_lo);
    }
    const int r_hi = r_lo + 8;
    if (r_hi >= 0 && r_hi < seq_q) {
      uint32_t* p = reinterpret_cast<uint32_t*>(ob + static_cast<long long>(r_hi) * D);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        p[4 * j] = pack_bf16(acc[4 * j + 2] / den_hi, acc[4 * j + 3] / den_hi);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// so that the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

constexpr int kErrEntryPoint = 10000;  // no cuTensorMapEncodeTiled
constexpr int kErrEncode = 10001;      // + CUresult of a refused map

// A 4-D (D, S, H, B) map over a bf16 tensor given by element strides
// (row, head, batch), boxes of (cb columns, 128 rows).
int make_map(CUtensorMap* map, const void* ptr, int d, int s, int h, int b, long long ss,
             long long sh, long long sb, int cb, CUtensorMapSwizzle swz) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return kErrEntryPoint;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s > 0 ? s : 1),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  // a dimension of extent 1 is never stepped: give it a stride TMA accepts
  const long long el[3] = {ss, sh, sb};
  const long long ext[3] = {s, h, b};
  cuuint64_t strides[3];
  long long fill = static_cast<long long>(d);
  for (int i = 0; i < 3; ++i) {
    const long long st = ext[i] <= 1 ? fill : el[i];
    strides[i] = static_cast<cuuint64_t>(st * 2);
    fill = st * (ext[i] > 1 ? ext[i] : 1);
  }
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cb), 128u, 1u, 1u};
  const cuuint32_t estr[4] = {1u, 1u, 1u, 1u};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, const long long* st, int batch,
           int hq, int hkv, int seq_q, int seq_k, float sm_scale, int causal, cudaStream_t stream) {
  using C = Cfg<D>;
  const CUtensorMapSwizzle swz =
      C::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, D, seq_q, hq, batch, st[2], st[1], st[0], C::CB, swz);
  if (err == 0) err = make_map(&tk, k, D, seq_k, hkv, batch, st[5], st[4], st[3], C::CB, swz);
  if (err == 0) err = make_map(&tv, v, D, seq_k, hkv, batch, st[8], st[7], st[6], C::CB, swz);
  if (err != 0) return err;
  auto kern = flash_fwd_sm90<D>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int pad = (kBQ - seq_q % kBQ) % kBQ;
  const dim3 grid((seq_q + pad) / kBQ, batch * hq);
  kern<<<grid, kThreads, C::SMEM, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), hq,
                                            hq / hkv, seq_q, seq_k, pad,
                                            sm_scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q: (B, Hq, Sq, D), k/v: (B, Hkv, Sk, D) bf16, each given by its (batch,
// head, row) element strides with a contiguous head dim; 16-byte aligned
// base and strides that are multiples of 8 elements (TMA's rule). o: a
// contiguous (B, Hq, Sq, D) bf16 tensor. d in {32, 64, 128}. Returns 0, a
// cudaError_t, or 10000 + (refused tensor map).
int fa90_forward(const void* q, const void* k, const void* v, void* o, int d, int batch, int hq,
                 int hkv, int seq_q, int seq_k, long long q_sb, long long q_sh, long long q_ss,
                 long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                 long long v_ss, float sm_scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (seq_q <= 0 || batch <= 0 || hq <= 0) return static_cast<int>(cudaGetLastError());
  const long long strides[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  switch (d) {
    case 32:
      return launch<32>(q, k, v, o, strides, batch, hq, hkv, seq_q, seq_k, sm_scale, causal, st);
    case 64:
      return launch<64>(q, k, v, o, strides, batch, hq, hkv, seq_q, seq_k, sm_scale, causal, st);
    case 128:
      return launch<128>(q, k, v, o, strides, batch, hq, hkv, seq_q, seq_k, sm_scale, causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* fa90_error_string(int err) {
  if (err == kErrEntryPoint) return "cuTensorMapEncodeTiled not found through the runtime";
  if (err > kErrEncode - 1 && err < kErrEncode + 1000)
    return "cuTensorMapEncodeTiled refused a tensor map (CUresult = code - 10001)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

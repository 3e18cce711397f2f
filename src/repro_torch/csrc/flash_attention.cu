// Blocked online-softmax attention (forward) in float32 on Hopper's tensor
// cores (sm_90a): split TF32 on mma.sync, K and V double-buffered by
// cp.async.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention
// for float32 inputs; bf16 inputs go to flash_attention_sm90.cu.
//
// What it computes. For each batch b and query head h (reading kv head
// h / group, jnp.repeat's order), logits = (q . k^T) * sm_scale in float32;
// when causal, key col c is visible to query row r iff c <= r + (Sk - Sq)
// (the decode-aligned diagonal) and a hidden logit is -1e30, not -inf; keys
// past Sk get weight 0. The running max, denominator and accumulator are
// float32 (expf, as the reference's exp); the output is acc / max(l, 1e-30).
// Any Sq and Sk. Query tiles are laid out as the reference lays out its
// front-padded 128-row blocks (the first tile starts at row -((-Sq) mod
// 128)) and a tile runs the key tiles t with t * 64 <= (its last row) +
// (Sk - Sq), so a tile wholly above the diagonal runs none and writes 0.
// With Sk % 128 == 0 (the op's contract) every causal row that sees no key
// (r < Sq - Sk) lies in such a tile and comes out exactly 0, as through the
// TPU kernel; in a direct call a row that sees no key inside a tile that
// runs gets the uniform mean of the keys its tile schedule runs.
//
// What bounds it on the H100. Causal attention at the LM path's shape (2 x
// 32 heads, 4096 x 4096, D = 128) is 2.75e11 flops against 336 MB of
// float32 q, k, v and o: bound by operations. The reference computes in
// float32, and the TPU's matrix unit takes float32 products as bf16 passes;
// here they are TF32 passes on the tensor cores. One pass keeps about 11
// bits of each operand, which misses the 1e-5 and 2e-5 tolerances, so each
// operand x is split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna) and
// each product is formed as lo.hi' + hi.lo' + hi.hi' (small terms first,
// lo.lo' dropped): about 21 bits, three m16n8k8 TF32 mma per product tile.
// Bound: 3 x 2.75e11 / 495e12 TF32 = 1.67 ms.
//
// What the design does about that. One block per (128-row query tile,
// b*Hq head), longest causal tiles first; eight warps, each owning 16
// query rows, so a row's max and sum stay in a quad of 4 lanes. Per 64-key
// tile a warp forms S (16 x 64) = Q.K^T with 3 x D mma and O (16 x D) +=
// P.V with another 3 x D. The tensor cores truncate each mma's sum at the
// scale of its accumulator, so S sums the small terms in an accumulator of
// their own, and P.V sums each tile in fresh accumulators that join O by
// one rounded fma. P goes from the accumulator fragment of S to the A
// fragment of P.V in registers: the C fragment gives a lane keys 2t and
// 2t+1 of each 8-key chunk where the A fragment wants k = t and t + 4, so
// V's B fragment rows are read in the same permuted order (k-index t takes
// key 2t, t + 4 takes key 2t + 1). Rows of Q, K and V in shared memory are
// padded to D + 4 floats: A and B fragments read g*(D+4) + t (banks 4g + t),
// V reads 2t*(D+4) + g and (2t+1)*(D+4) + g (banks 8t + g and 8t + 4 + g),
// all conflict-free. Q is loaded once; K and V tiles are double-buffered by
// cp.async (16 bytes a copy where every base and stride allows, else 4),
// tile t+1 in flight while tile t is multiplied, one __syncthreads a tile:
// 203 KB of shared memory at D = 128, one block an SM.
// The splits are CUDA-core work beside the tensor cores: four instructions
// a value (add, mask, subtract, add: the tensor core reads only lo's TF32
// bits, so its mask is dropped). Per warp and 64-key tile at D = 128 a lane
// splits 64 Q, 256 K, 32 P and 256 V values, about 2,400 instructions
// against 768 mma. They are taken per fragment: the shared memory holds
// no hi/lo tiles beside Q and the two K/V stages, and with them the eight
// warps would read twice the bytes of K and V that they read now.
// Base offsets are 64-bit (B*H*S*D passes 2^31 at long prefill shapes).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 128;             // query rows per block (the reference's block)
constexpr int kBK = 64;              // keys per tile
constexpr int kWarps = kBQ / 16;     // 16 query rows a warp
constexpr int kThreads = 32 * kWarps;
constexpr float kHidden = -1e30f;

struct Strides {
  long long b, h, s;  // element strides; the head dim is contiguous
};

template <int D>
struct Cfg {
  static constexpr int J = D / 8 < 8 ? D / 8 : 8;        // 8-column blocks of O formed at once
  static constexpr int LD = D + 4;                       // padded row, in floats
  static constexpr int Q_FLOATS = kBQ * LD;
  static constexpr int KV_FLOATS = kBK * LD;             // one stage of K or of V
  static constexpr int SMEM = (Q_FLOATS + 4 * KV_FLOATS) * static_cast<int>(sizeof(float));
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `bytes` (16 or 4) from global to shared memory asynchronously;
// `ok == false` writes zeros and reads nothing.
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const float* src, bool ok) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [row0, row0 + ROWS) of a (S, D) slice with row stride `stride` into
// a padded shared tile; rows outside [0, limit) come in as zeros.
template <int D, int ROWS, int BYTES>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long stride, int row0,
                                          int limit, int tid) {
  constexpr int W = BYTES / 4;  // floats a copy
  constexpr int PER_ROW = D / W;
  const uint32_t base = smem_u32(dst);
#pragma unroll 4
  for (int i = tid; i < ROWS * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW;
    const int c = (i - r * PER_ROW) * W;
    const int row = row0 + r;
    const bool ok = row >= 0 && row < limit;
    cp_async<BYTES>(base + (r * Cfg<D>::LD + c) * 4, ok ? src + row * stride + c : src, ok);
  }
}

// cvt.rna.tf32.f32's rounding (10 mantissa bits, ties away from zero) as
// integer work: add half of the 13 dropped bits, then clear them. It equals
// the instruction on every finite value and on +-inf; ptxas lowers the
// instruction itself to more (a NaN test and a select besides).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, both TF32: hi = rna(x), lo = rna(x - hi).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// D[16 x 8] += A[16 x 8] . B[8 x 8], TF32 operands, float32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int D, int BYTES>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, Strides sq, Strides sk,
               Strides sv, Strides so, int hq, int group, int seq_q, int seq_k, int pad,
               float sm_scale, int causal) {
  using C = Cfg<D>;
  constexpr int LD = C::LD;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + C::Q_FLOATS;       // + stage * KV_FLOATS
  float* sV = sK + 2 * C::KV_FLOATS;  // + stage * KV_FLOATS

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int hk = h / group;
  const int row0 = qt * kBQ - pad;  // first query row of the tile; rows < 0 are padding
  const int off = seq_k - seq_q;
  int n_tiles = (seq_k + kBK - 1) / kBK;
  if (causal) {
    // run key tile t iff t * kBK <= row0 + kBQ - 1 + off (the TPU kernel's skip)
    const long long lim = static_cast<long long>(row0) + kBQ - 1 + off;
    n_tiles = lim < 0 ? 0 : min(n_tiles, static_cast<int>(lim / kBK) + 1);
  }

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;
  float* ob = o + b * so.b + h * so.h;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row (A, C) or column (B)
  const int t = lane & 3;    // fragment k-index
  const int w_row0 = row0 + 16 * warp;
  const int r_lo = w_row0 + g;  // rows of acc[j][0..1]; r_lo + 8 for acc[j][2..3]

  if (n_tiles > 0) {
    load_rows<D, kBQ, BYTES>(sQ, qb, sq.s, row0, seq_q, tid);
    load_rows<D, kBK, BYTES>(sK, kb, sk.s, 0, seq_k, tid);
    load_rows<D, kBK, BYTES>(sV, vb, sv.s, 0, seq_k, tid);
    cp_commit();
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  float m_lo = kHidden, m_hi = kHidden, l_lo = 0.f, l_hi = 0.f;
  const float* qw = sQ + 16 * warp * LD;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    cp_wait_all();     // tile it (the only group in flight) has landed
    __syncthreads();   // ... for every thread, and everyone is done with tile it - 1
    if (it + 1 < n_tiles) {
      load_rows<D, kBK, BYTES>(sK + (st ^ 1) * C::KV_FLOATS, kb, sk.s, (it + 1) * kBK, seq_k, tid);
      load_rows<D, kBK, BYTES>(sV + (st ^ 1) * C::KV_FLOATS, vb, sv.s, (it + 1) * kBK, seq_k, tid);
      cp_commit();
    }
    const float* kt = sK + st * C::KV_FLOATS;
    const float* vt = sV + st * C::KV_FLOATS;
    const int k0 = it * kBK;

    // S = Q . K^T: s[n] holds rows g, g + 8 and keys 8n + 2t, 8n + 2t + 1.
    // The tensor cores truncate each mma's sum at the scale of its
    // accumulator, so the small terms sum apart (sl) and join hi.hi' once.
    float s[kBK / 8][4], sl[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = sl[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ah[4], al[4];
      split(qw[g * LD + 8 * kk + t], ah[0], al[0]);
      split(qw[(g + 8) * LD + 8 * kk + t], ah[1], al[1]);
      split(qw[g * LD + 8 * kk + t + 4], ah[2], al[2]);
      split(qw[(g + 8) * LD + 8 * kk + t + 4], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        uint32_t bh[2], bl[2];
        split(kt[(8 * n + g) * LD + 8 * kk + t], bh[0], bl[0]);
        split(kt[(8 * n + g) * LD + 8 * kk + t + 4], bh[1], bl[1]);
        mma(sl[n], al, bh);
        mma(sl[n], ah, bl);
        mma(s[n], ah, bh);
      }
    }

    // logits; masks only where the tile crosses the Sk edge or this warp's diagonal
    if (k0 + kBK > seq_k || (causal && k0 + kBK - 1 > w_row0 + off)) {
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = k0 + 8 * n + 2 * t + (i & 1);
          const int row = r_lo + ((i & 2) ? 8 : 0);
          float x = (s[n][i] + sl[n][i]) * sm_scale;
          if (col >= seq_k) {
            x = __int_as_float(0xFF800000);  // -inf past the keys: weight exactly 0
          } else if (causal && col > row + off) {
            x = kHidden;
          }
          s[n][i] = x;
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = (s[n][i] + sl[n][i]) * sm_scale;
    }

    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xFFFFFFFFu, mx_lo, w));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xFFFFFFFFu, mx_hi, w));
    }
    const float a_lo = expf(m_lo - mx_lo);
    const float a_hi = expf(m_hi - mx_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      s[n][0] = expf(s[n][0] - mx_lo);
      s[n][1] = expf(s[n][1] - mx_lo);
      s[n][2] = expf(s[n][2] - mx_hi);
      s[n][3] = expf(s[n][3] - mx_hi);
      sum_lo += s[n][0] + s[n][1];
      sum_hi += s[n][2] + s[n][3];
    }
    l_lo = l_lo * a_lo + sum_lo;  // per-lane partial sums; the quad adds them at the end
    l_hi = l_hi * a_hi + sum_hi;

    // O = alpha * O + P . V: A = P in registers (k-index t is key 2t, t + 4
    // is key 2t + 1), B = V rows read in that order. J 8-column blocks of O
    // at a time sum the tile's 64 keys in fresh accumulators, the small
    // terms apart (2J independent mma chains a warp), and join O by one
    // rounded fma each.
    uint32_t ph[kBK / 8][4], pl[kBK / 8][4];
#pragma unroll
    for (int kc = 0; kc < kBK / 8; ++kc) {
      split(s[kc][0], ph[kc][0], pl[kc][0]);  // (g, key 2t)
      split(s[kc][2], ph[kc][1], pl[kc][1]);  // (g + 8, key 2t)
      split(s[kc][1], ph[kc][2], pl[kc][2]);  // (g, key 2t + 1)
      split(s[kc][3], ph[kc][3], pl[kc][3]);  // (g + 8, key 2t + 1)
    }
    const float* v0 = vt + 2 * t * LD + g;
#pragma unroll
    for (int j0 = 0; j0 < D / 8; j0 += C::J) {
      float pv[C::J][4], pvl[C::J][4];
#pragma unroll
      for (int jj = 0; jj < C::J; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[jj][i] = pvl[jj][i] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kBK / 8; ++kc) {
#pragma unroll
        for (int jj = 0; jj < C::J; ++jj) {
          uint32_t vh[2], vl[2];
          split(v0[8 * kc * LD + 8 * (j0 + jj)], vh[0], vl[0]);
          split(v0[(8 * kc + 1) * LD + 8 * (j0 + jj)], vh[1], vl[1]);
          mma(pvl[jj], pl[kc], vh);
          mma(pvl[jj], ph[kc], vl);
          mma(pv[jj], ph[kc], vh);
        }
      }
#pragma unroll
      for (int jj = 0; jj < C::J; ++jj) {
        float* a = acc[j0 + jj];
        a[0] = fmaf(a[0], a_lo, pv[jj][0] + pvl[jj][0]);
        a[1] = fmaf(a[1], a_lo, pv[jj][1] + pvl[jj][1]);
        a[2] = fmaf(a[2], a_hi, pv[jj][2] + pvl[jj][2]);
        a[3] = fmaf(a[3], a_hi, pv[jj][3] + pvl[jj][3]);
      }
    }
  }

#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l_lo += __shfl_xor_sync(0xFFFFFFFFu, l_lo, w);
    l_hi += __shfl_xor_sync(0xFFFFFFFFu, l_hi, w);
  }
  const float den_lo = fmaxf(l_lo, 1e-30f);
  const float den_hi = fmaxf(l_hi, 1e-30f);
  const int r_hi = r_lo + 8;
  if (r_lo >= 0 && r_lo < seq_q) {
    float* p = ob + r_lo * so.s + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      p[8 * j] = acc[j][0] / den_lo;
      p[8 * j + 1] = acc[j][1] / den_lo;
    }
  }
  if (r_hi >= 0 && r_hi < seq_q) {
    float* p = ob + r_hi * so.s + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      p[8 * j] = acc[j][2] / den_hi;
      p[8 * j + 1] = acc[j][3] / den_hi;
    }
  }
}

template <int D, int BYTES>
int launch(const float* q, const float* k, const float* v, float* o, Strides sq, Strides sk,
           Strides sv, Strides so, int batch, int hq, int hkv, int seq_q, int seq_k,
           float sm_scale, int causal, cudaStream_t st) {
  auto kern = flash_fwd_tf32<D, BYTES>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pad = (kBQ - seq_q % kBQ) % kBQ;
  const dim3 grid((seq_q + pad) / kBQ, batch * hq);
  kern<<<grid, kThreads, Cfg<D>::SMEM, st>>>(q, k, v, o, sq, sk, sv, so, hq, hq / hkv, seq_q,
                                             seq_k, pad, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte copies need every base 16-byte aligned and every stride that is
// ever stepped (extent > 1) a multiple of 4 floats.
bool aligned16(const void* p, const Strides& s, int nb, int nh, int ns) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (nb <= 1 || s.b % 4 == 0) &&
         (nh <= 1 || s.h % 4 == 0) && (ns <= 1 || s.s % 4 == 0);
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, Strides sq, Strides sk,
             Strides sv, Strides so, int batch, int hq, int hkv, int seq_q, int seq_k,
             float sm_scale, int causal, cudaStream_t st) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  if (aligned16(q, sq, batch, hq, seq_q) && aligned16(k, sk, batch, hkv, seq_k) &&
      aligned16(v, sv, batch, hkv, seq_k))
    return launch<D, 16>(qf, kf, vf, of, sq, sk, sv, so, batch, hq, hkv, seq_q, seq_k, sm_scale,
                         causal, st);
  return launch<D, 4>(qf, kf, vf, of, sq, sk, sv, so, batch, hq, hkv, seq_q, seq_k, sm_scale,
                      causal, st);
}

}  // namespace

extern "C" {

// q: (B, Hq, Sq, D), k/v: (B, Hkv, Sk, D), o: (B, Hq, Sq, D), each given by
// its (batch, head, row) element strides with a contiguous head dim, all
// float32; d in {32, 64, 128}. Returns a cudaError_t.
int fa_forward(const void* q, const void* k, const void* v, void* o, int d,
               int batch, int hq, int hkv, int seq_q, int seq_k, long long q_sb,
               long long q_sh, long long q_ss, long long k_sb, long long k_sh, long long k_ss,
               long long v_sb, long long v_sh, long long v_ss, long long o_sb, long long o_sh,
               long long o_ss, float sm_scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (seq_q <= 0 || batch <= 0 || hq <= 0) return static_cast<int>(cudaGetLastError());
  const Strides sq{q_sb, q_sh, q_ss}, sk{k_sb, k_sh, k_ss}, sv{v_sb, v_sh, v_ss},
      so{o_sb, o_sh, o_ss};
  switch (d) {
    case 32:
      return launch_d<32>(q, k, v, o, sq, sk, sv, so, batch, hq, hkv, seq_q, seq_k, sm_scale,
                          causal, st);
    case 64:
      return launch_d<64>(q, k, v, o, sq, sk, sv, so, batch, hq, hkv, seq_q, seq_k, sm_scale,
                          causal, st);
    case 128:
      return launch_d<128>(q, k, v, o, sq, sk, sv, so, batch, hq, hkv, seq_q, seq_k, sm_scale,
                           causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

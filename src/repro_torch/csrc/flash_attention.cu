// Blocked online-softmax attention (forward) in float32 on CUDA cores, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention
// for float32 inputs; bf16 inputs go to flash_attention_sm90.cu.
//
// What it computes. For each batch b and query head h (reading kv head
// h / group, jnp.repeat's order), logits = (q . k^T) * sm_scale in float32;
// when causal, key col c is visible to query row r iff c <= r + (Sk - Sq)
// (the decode-aligned diagonal) and a hidden logit is -1e30, not -inf. Key
// tiles wholly above the diagonal are skipped. The running max, denominator
// and accumulator are float32; the output is acc / max(l, 1e-30). Any Sq and Sk:
// rows past Sq are not stored and keys past Sk get weight 0. A causal row
// that sees no key at all (r < Sq - Sk) comes out, as in the TPU kernel,
// by its tile schedule: 0 where every tile is skipped, else a uniform mean.
//
// What bounds it on the H100. Causal attention at the LM path's shape does
// about 2 * 2 * Sq * Sk * D / 2 multiply-adds per head against a few bytes
// per element of q, k, v and o: it is bound by operations. The reference
// computes in float32, so this kernel does too, on CUDA cores (67 TFLOP/s
// peak), not on tensor cores.
//
// What the design does about that. One block per (64-row query tile, b*Hq
// head); a loop over 64-key tiles up to the causal limit stages K^T and V
// in dynamic shared memory as float32 (a 64 x 128 float32 tile is 32 KB;
// the three tiles pass the 48 KB static limit). Each of the 256 threads
// owns a 4 x 4 block of the logits and a 4 x (D/16) block of the output,
// so every shared-memory load feeds several multiply-adds; row max and sum
// are warp shuffles across the 16 threads of a row. P reuses the K^T
// buffer. Query tiles run longest-first to even out the causal load.
// Base offsets are 64-bit (B*H*S*D passes 2^31 at long prefill shapes).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 256;   // 16 x 16: ty picks rows, tx picks columns
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;  // element strides; the head dim is contiguous
};

template <int D>
constexpr int smem_floats() {
  // sQ (kBQ x (D+4)) + sKT/sP (max(D, kBQ) x (kBK+1)) + sV (kBK x D)
  return kBQ * (D + 4) + (D > kBQ ? D : kBQ) * (kBK + 1) + kBK * D;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          float* __restrict__ o, Strides sq, Strides sk, Strides sv, Strides so, int hq,
          int group, int seq_q, int seq_k, float sm_scale, int causal) {
  constexpr int QS = D + 4;     // padded rows: the two row groups of a warp hit other banks
  constexpr int KTS = kBK + 1;  // padded K^T / P rows: conflict-free transposed stores
  constexpr int NC = D / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sKT = sQ + kBQ * QS;
  float* sV = sKT + (D > kBQ ? D : kBQ) * KTS;
  float* sP = sKT;  // P (kBQ x KTS) reuses the K^T buffer once S is formed

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int hk = h / group;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;
  float* ob = o + b * so.b + h * so.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    sQ[r * QS + d] = row < seq_q ? qb[row * sq.s + d] : 0.f;
  }

  float acc[4][NC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  const int off = seq_k - seq_q;
  int n_tiles = (seq_k + kBK - 1) / kBK;
  if (causal) {
    // process tile t iff t * kBK <= q0 + kBQ - 1 + off (the TPU kernel's skip)
    const long long lim = static_cast<long long>(q0) + kBQ - 1 + off;
    n_tiles = lim < 0 ? 0 : min(n_tiles, static_cast<int>(lim / kBK) + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's P and V reads are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int col = k0 + c;
      const bool ok = col < seq_k;
      sKT[d * KTS + c] = ok ? kb[col * sk.s + d] : 0.f;
      sV[c * D + d] = ok ? vb[col * sv.s + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sKT[d * KTS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * sm_scale;
        if (col >= seq_k) {
          x = __int_as_float(0xFF800000);  // -inf past the keys: weight exactly 0
        } else if (causal && col > row + off) {
          x = kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) sum += __shfl_xor_sync(0xFFFFFFFFu, sum, w);
      l[i] = alpha[i] * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha[i];
    }

    __syncthreads();  // every thread is done reading K^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(ty + 16 * i) * KTS + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * KTS + c];
#pragma unroll
      for (int j = 0; j < NC; ++j) vv[j] = sV[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= seq_q) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j) ob[row * so.s + tx + 16 * j] = acc[i][j] / den;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, Strides sq, Strides sk,
           Strides sv, Strides so, int batch, int hq, int hkv, int seq_q, int seq_k,
           float sm_scale, int causal, cudaStream_t st) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  auto kern = flash_fwd<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq_q + kBQ - 1) / kBQ, batch * hq);
  kern<<<grid, kThreads, bytes, st>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                      static_cast<const float*>(v), static_cast<float*>(o), sq,
                                      sk, sv, so, hq, hq / hkv, seq_q, seq_k, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_d(int d, const void* q, const void* k, const void* v, void* o, Strides sq,
               Strides sk, Strides sv, Strides so, int batch, int hq, int hkv, int seq_q,
               int seq_k, float sm_scale, int causal, cudaStream_t st) {
  switch (d) {
    case 32:
      return launch<32>(q, k, v, o, sq, sk, sv, so, batch, hq, hkv, seq_q, seq_k,
                        sm_scale, causal, st);
    case 64:
      return launch<64>(q, k, v, o, sq, sk, sv, so, batch, hq, hkv, seq_q, seq_k,
                        sm_scale, causal, st);
    case 128:
      return launch<128>(q, k, v, o, sq, sk, sv, so, batch, hq, hkv, seq_q, seq_k,
                         sm_scale, causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
  return dispatch_d(d, q, k, v, o, sq, sk, sv, so, batch, hq, hkv, seq_q, seq_k, sm_scale,
                    causal, st);
}

const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

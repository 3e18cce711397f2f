// Page-stream token descriptors for Hopper (sm_90a): the operands of the
// page-stream decode (fp_delta_decode.cu), written on the card from the
// stream's compact form.
//
// No TPU counterpart: the reference builds these arrays on the host
// (src/repro/kernels/fp_delta/ops.py::build_page_stream) and copies them.
//
// What it computes. A page stream holds n_values values of n_pages pages
// (pages with no values are left out), padded to n_blocks * 1024 positions.
// Column p of the page table gives page p's first stream position S, its
// value count, the bit address B of its first word, its token width n (0:
// raw mode) and the index of its first entry in the escape array, which
// holds the stream positions of every escaped value in ascending order. For
// a position pos = S + i of page p:
//   raw mode:          tok_off = B + 8 + W*i,   nbits = W, anchor = 1
//   value 0 (i = 0):   tok_off = B + 8,         nbits = W, anchor = 1
//   delta token j = i - 1, with E escapes of the page before it:
//     inline           tok_off = B + 8 + W + n*j + W*E,      nbits = n, anchor = 0
//     escaped          tok_off = B + 8 + W + n*j + W*E + n,  nbits = W, anchor = 1
// and every padding position is (0, W, 1). The result is bit for bit the
// host's expansion (ops.py::expand_stream_ref).
//
// What bounds it on the H100. It writes 12 bytes a position and reads the
// table and the escapes (4 bytes an escape, 20 a page); per position a few
// integer ops and two short searches in shared memory. It is bound by
// device-memory bytes (3.35 TB/s).
//
// What the design does about that.
//   - One block a 1024-position tile (the stream block), 256 threads of four
//     consecutive positions each; each of the three outputs is stored as one
//     16-byte vector a thread, so a warp writes 512 contiguous bytes.
//   - Four warps find the tile's slices at once, each by a 32-ary search in
//     device memory (one load a lane, one ballot a round: four rounds for a
//     million entries): the pages holding the tile's first and last value,
//     and the escapes in the tile. Every page in the slice but the first
//     starts inside the tile and every escape lies in it, so each slice has
//     at most 1024 entries; the page starts and the escapes are staged in
//     shared memory (8 KB).
//   - A position finds its page and its escape count by binary search in
//     those staged slices (most tiles hold one or two pages and a few dozen
//     escapes); the page's other numbers are read through the read-only
//     path, where the tile's threads share them.
//   - A tile past the last value writes the padding and reads nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;      // positions a block: the decode's STREAM_BLOCK
constexpr int kThreads = 256;    // four positions a thread
constexpr int kHeaderBits = 8;   // the FP-delta page header (n*)

// The first index in a[0, n) whose value is >= key (n when none), found by
// the whole warp: each round every lane tests one of 32 evenly spaced
// entries and the ballot narrows the range 32-fold. Every lane returns it.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ a, int n, int key) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + (lane + 1) * step - 1;
    const bool below = p < hi && __ldg(a + p) < key;
    const int c = __popc(__ballot_sync(0xFFFFFFFFu, below));
    hi = min(hi, lo + (c + 1) * step - 1);
    lo += c * step;
  }
  const int p = lo + lane;
  const bool below = p < hi && __ldg(a + p) < key;
  return lo + __popc(__ballot_sync(0xFFFFFFFFu, below));
}

// The first index in s[0, n) whose value is > key (shared memory).
__device__ __forceinline__ int upper_bound(const int* s, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The first index in s[0, n) whose value is >= key (shared memory).
__device__ __forceinline__ int lower_bound(const int* s, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
stream_expand_kernel(const int* __restrict__ table, int n_pages, const int* __restrict__ esc,
                     int n_esc, int n_values, int width, int* __restrict__ tok_off,
                     int* __restrict__ nbits, int* __restrict__ anchor) {
  __shared__ int s_start[kTile];
  __shared__ int s_esc[kTile];
  __shared__ int s_bounds[4];
  const int* v_start = table;
  const int* base_bit = table + 2 * static_cast<long long>(n_pages);
  const int* tok_n = table + 3 * static_cast<long long>(n_pages);
  const int* esc_first = table + 4 * static_cast<long long>(n_pages);

  const int t0 = blockIdx.x * kTile;
  const int q0 = t0 + 4 * threadIdx.x;
  int o[4], nb[4], an[4];
  if (t0 >= n_values) {  // the padding tail: nothing to read
#pragma unroll
    for (int k = 0; k < 4; ++k) { o[k] = 0; nb[k] = width; an[k] = 1; }
  } else {
    const int last = min(t0 + kTile, n_values) - 1;
    const int warp = threadIdx.x >> 5;
    if (warp == 0) {
      const int r = warp_lower_bound(v_start, n_pages, t0 + 1) - 1;
      if ((threadIdx.x & 31) == 0) s_bounds[0] = r;
    } else if (warp == 1) {
      const int r = warp_lower_bound(v_start, n_pages, last + 1) - 1;
      if ((threadIdx.x & 31) == 0) s_bounds[1] = r;
    } else if (warp == 2) {
      const int r = warp_lower_bound(esc, n_esc, t0);
      if ((threadIdx.x & 31) == 0) s_bounds[2] = r;
    } else if (warp == 3) {
      const int r = warp_lower_bound(esc, n_esc, last + 1);
      if ((threadIdx.x & 31) == 0) s_bounds[3] = r;
    }
    __syncthreads();
    const int p_lo = s_bounds[0];
    const int np = s_bounds[1] - p_lo + 1;
    const int e_lo = s_bounds[2];
    const int ne = s_bounds[3] - e_lo;
    for (int k = threadIdx.x; k < np; k += kThreads) s_start[k] = __ldg(v_start + p_lo + k);
    for (int k = threadIdx.x; k < ne; k += kThreads) s_esc[k] = __ldg(esc + e_lo + k);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int pos = q0 + k;
      if (pos >= n_values) { o[k] = 0; nb[k] = width; an[k] = 1; continue; }
      const int pk = upper_bound(s_start, np, pos) - 1;
      const int page = p_lo + pk;
      const int i = pos - s_start[pk];
      const long long first = static_cast<long long>(__ldg(base_bit + page)) + kHeaderBits;
      const int n = __ldg(tok_n + page);
      if (n == 0) {
        o[k] = static_cast<int>(first + static_cast<long long>(width) * i);
        nb[k] = width;
        an[k] = 1;
      } else if (i == 0) {
        o[k] = static_cast<int>(first);
        nb[k] = width;
        an[k] = 1;
      } else {
        const int e = lower_bound(s_esc, ne, pos);
        const bool escaped = e < ne && s_esc[e] == pos;
        const long long before = static_cast<long long>(e_lo + e - __ldg(esc_first + page));
        const long long off = first + width + static_cast<long long>(n) * (i - 1) +
                              width * before + (escaped ? n : 0);
        o[k] = static_cast<int>(off);
        nb[k] = escaped ? width : n;
        an[k] = escaped ? 1 : 0;
      }
    }
  }
  *reinterpret_cast<int4*>(tok_off + q0) = make_int4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<int4*>(nbits + q0) = make_int4(nb[0], nb[1], nb[2], nb[3]);
  *reinterpret_cast<int4*>(anchor + q0) = make_int4(an[0], an[1], an[2], an[3]);
}

}  // namespace

extern "C" {

// table: 5 x n_pages int32 (value start, value count, base bit, n, first
// escape index), one column a page that holds values, in stream order;
// esc: n_esc int32 ascending stream positions of escaped values;
// tok_off/nbits/anchor: n_blocks * 1024 int32 each, 16-byte aligned.
// One launch. Returns a cudaError_t.
int sx_expand_stream(const void* table, int n_pages, const void* esc, int n_esc, int n_values,
                     int width, int n_blocks, void* tok_off, void* nbits, void* anchor,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_blocks <= 0) return static_cast<int>(cudaGetLastError());
  stream_expand_kernel<<<n_blocks, kThreads, 0, st>>>(
      static_cast<const int*>(table), n_pages, static_cast<const int*>(esc), n_esc, n_values,
      width, static_cast<int*>(tok_off), static_cast<int*>(nbits), static_cast<int*>(anchor));
  return static_cast<int>(cudaGetLastError());
}

const char* sx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

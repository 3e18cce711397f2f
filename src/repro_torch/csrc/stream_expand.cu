// Page-stream operands for Hopper (sm_90a), made on the card from the
// stream's compact form: the escaped values' positions (escape_resolve_kernel,
// at the end of this file) and from them the token descriptors of the
// page-stream decode (fp_delta_decode.cu).
//
// ---------------------------------------------------------- the expansion
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

// ------------------------------------------------------ the escape resolution
//
// No TPU counterpart: the reference resolves escapes on its host, page by
// page (src/repro/core/fp_delta.py::fp_delta_plan), as the port's host did.
//
// What it computes. A page with token width n > 0 and D = count - 1 delta
// tokens stores them from bit P0 = B + 8 + W: token j at P0 + n*j + W*E_j,
// E_j the escapes before it, an escaped token being the marker (n ones)
// followed by the raw W-bit value. The page table's fifth row gives each
// page's first slot in the escape array and, by difference, its escape count
// E, which the payload's length fixes. The kernel writes the stream
// positions S + 1 + j of the escaped tokens j, ascending, into the page's E
// slots: bit for bit the host's resolution (ops.py::escape_resolve_ref).
//
// The sequential part. Where token j starts depends on every escape before
// it. An inline token never equals the marker, so from a known token
// boundary pos (token j0) the next escape is the first position c >= pos
// where n ones start with (c - pos) mod n == 0 and j0 + (c - pos) / n < D;
// after it pos = c + n + W and j0 = j + 1. Runs of ones elsewhere (inside
// raw values or across tokens) are only candidates.
//
// What bounds it on the H100. It reads each page's words once and writes 4
// bytes an escape: bound by device-memory bytes (3.35 TB/s), a few
// hundredths of a millisecond for a Porto chunk. The walk is serial.
//
// What the design does about that.
//   - One block a page, over tiles of 1,024 64-bit words of its tokens.
//     Warps 1-7 mark the next tile while warp 0 walks this one: a word's
//     mask has the bits where n ones start (a shift-AND ladder over the word
//     and its neighbour, at most 6 steps), two tiles in shared memory (16 KB).
//   - Warp 0 takes 32 words a step: each lane ANDs its word's mask with the
//     bits at pos + k*n below the end of the tokens (their first from a
//     residue kept across steps and per-lane constants, then doubling
//     shifts; no division in a step); a ballot gives the first lane with a
//     hit, its lowest bit the escape, a multiply-high its token index. The
//     serial work is a warp step an escape and one per 32 words between
//     escapes, not one a value.
//   - A page whose tokens mark fewer escapes than E, or a marker after the
//     E-th, bumps an error count and gets its first E positions in its
//     slots (in range and ascending, so that the expansion and the decode
//     stay inside the buffer); the host raises when it reads the count.
//   - Raw, empty and single-value pages return at once.

constexpr int kResolveThreads = 256;  // warp 0 walks, warps 1-7 mark
constexpr int kResolveTile = 1024;    // 64-bit words a tile of masks

// Bit k (< 64) set where bits k .. k + n - 1 of the 128 bits (hi:lo) are all
// ones (1 <= n <= 63).
__device__ __forceinline__ unsigned long long run_starts(unsigned long long lo,
                                                         unsigned long long hi, int n) {
  for (int len = 1; len < n;) {
    const int s = min(len, n - len);
    lo &= (lo >> s) | (hi << (64 - s));
    hi &= hi >> s;
    len += s;
  }
  return lo;
}

// Bits r, r + n, r + 2n, ... below 64 (0 <= r < 64).
__device__ __forceinline__ unsigned long long every_nth(int r, int n) {
  unsigned long long m = 1ull << r;
  for (int s = n; s < 64; s <<= 1) m |= m << s;
  return m;
}

// The masks of words [w0, w0 + len), each over the word and the next one of
// the page (none past w_stop, the page's end).
__device__ __forceinline__ void mark_tile(const unsigned long long* __restrict__ words,
                                          long long w0, int len, long long w_stop, int n,
                                          unsigned long long* mask, int tid, int n_threads) {
  for (int i = tid; i < len; i += n_threads) {
    const long long w = w0 + i;
    const unsigned long long hi = w + 1 < w_stop ? __ldg(words + w + 1) : 0ull;
    mask[i] = run_starts(__ldg(words + w), hi, n);
  }
}

__global__ void __launch_bounds__(kResolveThreads)
escape_resolve_kernel(const unsigned long long* __restrict__ words, long long n_words64,
                      const int* __restrict__ table, int n_pages, int n_esc, int width,
                      int* __restrict__ esc, int* __restrict__ bad) {
  __shared__ unsigned long long s_mask[2][kResolveTile];
  const int page = blockIdx.x;
  const long long np = n_pages;
  const int n = __ldg(table + 3 * np + page);
  const int cnt = __ldg(table + np + page);
  if (n == 0 || cnt < 2) return;  // raw or single-value: no delta tokens
  const int v_start = __ldg(table + page);
  const long long base = __ldg(table + 2 * np + page);
  const int first = __ldg(table + 4 * np + page);
  const int n_page_esc = (page + 1 < n_pages ? __ldg(table + 4 * np + page + 1) : n_esc) - first;
  const long long w_stop = page + 1 < n_pages ? __ldg(table + 2 * np + page + 1) / 64 : n_words64;
  const int n_deltas = cnt - 1;
  const long long pos0 = base + kHeaderBits + width;
  const long long end = min(pos0 + static_cast<long long>(n) * n_deltas +
                                static_cast<long long>(width) * n_page_esc, 64 * w_stop);
  const long long w_begin = pos0 >> 6;
  const long long w_end = (end + 63) >> 6;
  const int n_tiles =
      w_end > w_begin ? static_cast<int>((w_end - w_begin + kResolveTile - 1) / kResolveTile) : 0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const long long tile = kResolveTile;
  if (n_tiles > 0)
    mark_tile(words, w_begin, static_cast<int>(min(tile, w_end - w_begin)), w_stop, n, s_mask[0],
              threadIdx.x, kResolveThreads);
  __syncthreads();

  // warp 0's walk: token j0 starts at bit pos, token n_deltas would at lim;
  // the words below scan hold no escape after pos, and the token boundaries
  // (the bits congruent to pos mod n) lie phase bits after word scan's bit 0
  // mod n. Residues come from per-lane constants, so a step divides nothing.
  long long pos = pos0, lim = pos0 + static_cast<long long>(n) * n_deltas, scan = w_begin;
  int j0 = 0, found = 0;
  bool done = false;  // set by warp 0 alone
  const int k_lane = (64 * lane) % n;          // 64 * lane mod n
  const int k_warp = (64 * 32) % n;            // 64 * 32 mod n
  const int inv16 = (65536 + n - 1) / n;       // x / n == (x * inv16) >> 16 for x < 64
  const unsigned long long inv64 = n == 1 ? 0ull : ~0ull / n + 1;  // ceil(2^64 / n)
  int phase = static_cast<int>(pos & 63) % n;
  for (int t = 0; t < n_tiles; ++t) {
    const long long t_begin = w_begin + t * tile;
    const long long t_end = min(t_begin + tile, w_end);
    if (warp == 0) {
      const unsigned long long* mask = s_mask[t & 1];
      while (!done && scan < t_end) {
        const long long w = scan + lane;
        unsigned long long hit = 0;
        if (w < t_end) {
          const long long b = 64 * w;
          int r;  // the first token boundary in this word, from its bit 0
          if (b >= pos) {
            r = phase - k_lane;
            r += r < 0 ? n : 0;
          } else {
            r = static_cast<int>(pos - b);  // the word holding pos (lane 0)
          }
          const long long room = lim - b;  // bits of this word before the last token's end
          if (room > r) {
            hit = mask[w - t_begin] & every_nth(r, n);
            if (room < 64) hit &= (1ull << room) - 1;
          }
        }
        const unsigned ballot = __ballot_sync(0xFFFFFFFFu, hit != 0);
        if (ballot == 0) {
          const int step = static_cast<int>(min(32LL, t_end - scan));
          const int k = __shfl_sync(0xFFFFFFFFu, k_lane, step & 31);
          phase -= step == 32 ? k_warp : k;
          phase += phase < 0 ? n : 0;
          scan += step;
          done = 64 * scan >= lim;
          continue;
        }
        const int src = __ffs(ballot) - 1;
        hit = __shfl_sync(0xFFFFFFFFu, hit, src);
        const long long c = 64 * (scan + src) + (__ffsll(static_cast<long long>(hit)) - 1);
        const unsigned long long d = static_cast<unsigned long long>(c - pos);
        const int j = j0 + static_cast<int>(n == 1 ? d : __umul64hi(d, inv64));
        if (lane == 0 && found < n_page_esc) esc[first + found] = v_start + 1 + j;
        if (++found > n_page_esc) {  // a marker after the last escape
          done = true;
          break;
        }
        pos = c + n + width;
        j0 = j + 1;
        lim = pos + static_cast<long long>(n) * (n_deltas - j0);
        scan = pos >> 6;
        const int x = static_cast<int>(pos & 63);
        phase = x - n * ((x * inv16) >> 16);
        done = lim <= pos;
      }
    } else if (t + 1 < n_tiles) {
      mark_tile(words, t_end, static_cast<int>(min(tile, w_end - t_end)), w_stop, n,
                s_mask[(t + 1) & 1], threadIdx.x - 32, kResolveThreads - 32);
    }
    if (__syncthreads_or(done)) break;
  }
  if (warp == 0 && found != n_page_esc) {
    if (lane == 0) atomicAdd(bad, 1);
    __syncwarp();
    for (int k = lane; k < n_page_esc; k += 32) esc[first + k] = v_start + 1 + k;
  }
}

}  // namespace

extern "C" {

// words: n_words64 little-endian 64-bit words of the stream, 8-byte aligned;
// table: as for sx_expand_stream, its fifth row the running sum of the
// pages' escape counts, n_esc their total; esc: n_esc int32 out; bad: one
// int32 out, zeroed here on the stream: the pages whose tokens do not mark
// exactly their escapes. One launch. Returns a cudaError_t.
int sx_resolve_escapes(const void* words, long long n_words64, const void* table, int n_pages,
                       int n_esc, int width, void* esc, void* bad, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(bad, 0, sizeof(int), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_pages > 0)
    escape_resolve_kernel<<<n_pages, kResolveThreads, 0, st>>>(
        static_cast<const unsigned long long*>(words), n_words64, static_cast<const int*>(table),
        n_pages, n_esc, width, static_cast<int*>(esc), static_cast<int*>(bad));
  return static_cast<int>(cudaGetLastError());
}

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

// K11 mode_costs: the SATD cost of all 67 intra modes of a batch of square
// blocks, predicted from host-built per-mode reference arrays.
//
// Replaces vvenc_tpu/ops/intra_batch.py:100 mode_costs_batch, an XLA
// program on the TPU that built every prediction [B, 67, h, w] (4-tap
// gathers from rm, planar, DC) and reduced it with an int32 Hadamard as
// matrix products.  Same arithmetic, bit for bit, per block b and mode m:
//   angular (m >= 2): clip((sum_k filt[m, y, k] rm[b, m, row_start[m, y] +
//                     x + k] + 32) >> 6) along the mode's rows, transposed
//                     for the horizontal family;
//   planar (m = 0):   the planar formula on tops[b, 1 .. w + 1] and
//                     lefts[b, 1 .. h + 1], without MDIS and without clip;
//   DC (m = 1):       (sum top + sum left + w) >> (log2 w + 1);
//   no PDPC;
//   cost:             sum over T x T tiles (T = 8, or 4 when w = 4) of the
//                     Hadamard abs-sum of src - pred, (s + 2) >> 2 for T = 8,
//                     the DC correction and (s + 1) >> 1 for T = 4.
// The sums are taken in unsigned arithmetic, so that they wrap as XLA's
// int32 does instead of being undefined; >> on the signed value is
// arithmetic.  The Hadamard is integer butterflies (TF32 would not be
// exact); tile values are summed with integer shuffles and atomics, whose
// order does not matter modulo 2^32.
//
// Bound: operations.  Every prediction sample costs a 4-tap sum, a round,
// a clip, a subtraction and its share of the butterflies (about 20
// integer operations) against rm read once: for the 8,040 16x16 blocks of
// a 1080p picture, 121 MB of rm against 2.8 G operations.  Design:
// prediction and SATD are fused, so the [B, 67, h, w] predictions are
// never written (552 MB at 16x16 on a 1080p grid).  One thread per (mode,
// block, tile) task, in that order with the tile fastest: a warp works on
// one mode (its table reads are uniform and its branches do not diverge)
// and on consecutive tiles of consecutive blocks.  A thread predicts its
// T x T tile into registers, one row of the mode's orientation at a time
// (the row's four taps read once), subtracts the source and runs the
// butterflies; the tiles of one (block, mode) pair are reduced by
// shuffles within their segment of the warp and added into the cost with
// one atomic per segment.  The static tables are uploaded once per size
// (ops/intra_batch._device_tables) and read through the read-only cache.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kModes = 67;

__device__ __forceinline__ unsigned uabs(unsigned v) {
  return (int)v < 0 ? 0u - v : v;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <int T>
__device__ __forceinline__ void wht(unsigned* v, int stride) {
  // natural-order (Sylvester) Hadamard of T values v[0], v[stride], ...
#pragma unroll
  for (int len = 1; len < T; len <<= 1)
#pragma unroll
    for (int i = 0; i < T; i += 2 * len)
#pragma unroll
      for (int j = i; j < i + len; ++j) {
        const unsigned a = v[j * stride], c = v[(j + len) * stride];
        v[j * stride] = a + c;
        v[(j + len) * stride] = a - c;
      }
}

struct Args {
  const int* src;
  const int* rm;
  const int* tops;
  const int* lefts;
  int* out;
  long long B;
  int Lt, Ll, L, w, log2w, maxval;
  const int* row_start;
  const int* filt;
  const int* transposed;
};

template <int T>
__global__ void __launch_bounds__(kThreads) mode_costs_kernel(const Args a) {
  const int w = a.w, ntx = w / T, ntiles = ntx * ntx;
  const long long task = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long ntasks = (long long)kModes * a.B * ntiles;
  const long long pair = task / ntiles;  // m * B + b
  const int m = (int)(pair / a.B);
  const long long b = pair - (long long)m * a.B;
  unsigned val = 0;
  if (task < ntasks) {
    const int tile = (int)(task - pair * ntiles);
    const int y0 = (tile / ntx) * T, x0 = (tile % ntx) * T;
    const int* src = a.src + b * w * w;
    const int* top = a.tops + b * a.Lt;
    const int* left = a.lefts + b * a.Ll;
    unsigned d[T * T];
    if (m == 0) {
      const int lw = a.log2w;
      const unsigned trr = (unsigned)top[1 + w], br = (unsigned)left[1 + w];
#pragma unroll
      for (int i = 0; i < T; ++i) {
        const unsigned lc = (unsigned)left[1 + y0 + i];
#pragma unroll
        for (int j = 0; j < T; ++j) {
          const unsigned tp = (unsigned)top[1 + x0 + j];
          const unsigned hor = (lc << lw) + (unsigned)(x0 + j + 1) * (trr - lc);
          const unsigned ver = (tp << lw) + (unsigned)(y0 + i + 1) * (br - tp);
          const int p = (int)((hor << lw) + (ver << lw) + (1u << (2 * lw))) >>
                        (1 + 2 * lw);
          d[i * T + j] = (unsigned)src[(y0 + i) * w + x0 + j] - (unsigned)p;
        }
      }
    } else if (m == 1) {
      unsigned s = (unsigned)w;
      for (int k = 1; k <= w; ++k) s += (unsigned)top[k] + (unsigned)left[k];
      const unsigned dc = (unsigned)((int)s >> (a.log2w + 1));
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int j = 0; j < T; ++j)
          d[i * T + j] = (unsigned)src[(y0 + i) * w + x0 + j] - dc;
    } else {
      // rows of the mode's own orientation: r along y for a vertical mode,
      // along x for a transposed (horizontal) one
      const bool tr = __ldg(a.transposed + m) != 0;
      const int r0 = tr ? x0 : y0, c0 = tr ? y0 : x0;
      const int* rmb = a.rm + ((size_t)b * kModes + m) * a.L;
#pragma unroll
      for (int u = 0; u < T; ++u) {
        const int r = r0 + u;
        const int* f = a.filt + ((size_t)m * w + r) * 4;
        const unsigned f0 = __ldg(f), f1 = __ldg(f + 1), f2 = __ldg(f + 2),
                       f3 = __ldg(f + 3);
        const int* g = rmb + __ldg(a.row_start + m * w + r) + c0;
        unsigned win[T + 3];
#pragma unroll
        for (int c = 0; c < T + 3; ++c) win[c] = (unsigned)__ldg(g + c);
#pragma unroll
        for (int v = 0; v < T; ++v) {
          const unsigned acc =
              f0 * win[v] + f1 * win[v + 1] + f2 * win[v + 2] + f3 * win[v + 3];
          const int p = clampi((int)(acc + 32u) >> 6, 0, a.maxval);
          const int i = tr ? v : u, j = tr ? u : v;  // tile coordinates
          d[i * T + j] = (unsigned)src[(y0 + i) * w + x0 + j] - (unsigned)p;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < T; ++i) wht<T>(d + i * T, 1);  // rows: D H
#pragma unroll
    for (int j = 0; j < T; ++j) wht<T>(d + j, T);      // columns: H (D H)
    unsigned s = 0;
#pragma unroll
    for (int i = 0; i < T * T; ++i) s += uabs(d[i]);
    if (T == 8) {
      val = (unsigned)((int)(s + 2u) >> 2);
    } else {
      const unsigned dc = uabs(d[0]);
      val = (unsigned)((int)(s - dc + (unsigned)((int)dc >> 2) + 1u) >> 1);
    }
  }
  // ntiles is a power of two: reduce within the pair's segment of the warp
  // (ntiles lanes, or the warp when the pair spans several warps)
  const int seg = ntiles < 32 ? ntiles : 32;
  for (int o = seg >> 1; o > 0; o >>= 1)
    val += __shfl_down_sync(0xffffffffu, val, o, seg);
  if (task < ntasks && (threadIdx.x & (seg - 1)) == 0)
    atomicAdd((unsigned*)a.out + b * kModes + m, val);
}

}  // namespace

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// src [B, w, w], rm [B, 67, L], tops [B, Lt] (Lt >= w + 2), lefts [B, Ll]
// (Ll >= w + 2) int32 -> out [B, 67] int32, which must hold zeros (tile
// costs are added into it); w in 4 .. 64, a power of two; the tables are
// ops/intra_batch._device_tables(w).  Returns cudaGetLastError() after
// the launch on `stream`.
extern "C" int vt_mode_costs(const void* src, const void* rm, const void* tops,
                             int Lt, const void* lefts, int Ll, void* out,
                             long long B, int L, int w, int bit_depth,
                             const void* row_start, const void* filt,
                             const void* transposed, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (B <= 0 || w < 4 || w > 64 || (w & (w - 1)) || Lt < w + 2 ||
      Ll < w + 2 || L < 3 * w + 8 || bit_depth < 1 || bit_depth > 30)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.src = (const int*)src;
  a.rm = (const int*)rm;
  a.tops = (const int*)tops;
  a.lefts = (const int*)lefts;
  a.out = (int*)out;
  a.B = B;
  a.Lt = Lt;
  a.Ll = Ll;
  a.L = L;
  a.w = w;
  a.log2w = 31 - __builtin_clz((unsigned)w);
  a.maxval = (1 << bit_depth) - 1;
  a.row_start = (const int*)row_start;
  a.filt = (const int*)filt;
  a.transposed = (const int*)transposed;
  const int T = w % 8 == 0 ? 8 : 4;
  const long long ntasks = (long long)kModes * B * (w / T) * (w / T);
  const long long grid = (ntasks + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (T == 8)
    mode_costs_kernel<8><<<(unsigned)grid, kThreads, 0, st>>>(a);
  else
    mode_costs_kernel<4><<<(unsigned)grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

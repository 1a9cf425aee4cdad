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
//
// Two routes, both exact.  At bit depths up to 10 (samples in 0 .. 1023)
// the per-sample arithmetic runs on the float32 pipe, as K4's does: the
// taps' absolute sum is at most 84, so |sum| <= 84 * 1023 < 2^24, every
// Hadamard value is at most 64 * 1023 and a tile's abs-sum at most
// 64 * 64 * 1023 < 2^24, so every float is an integer held exactly; the
// (x + 32) >> 6 round is one fma onto 1.5 * 2^23 (K4's shr6_magic), and
// the last butterfly stage and the abs-sum fuse as |a + c| + |a - c| =
// 2 max(|a|, |c|).  Above 10 bits the integer route keeps the reference's
// int32 semantics: sums in unsigned arithmetic, wrapping as XLA's int32
// does, >> on the signed value.  tests/test_torch_exact_split.py holds
// the float route against the plain version at the 0 / max extremes.
//
// Bound: operations.  Every prediction sample costs a 4-tap sum, a round,
// a clip, a subtraction and its share of the butterflies (about 20
// operations) against rm read once: for the 8,040 16x16 blocks of a 1080p
// picture, 121 MB of rm against 2.8 G operations.  Design: prediction and
// SATD are fused, so the [B, 67, h, w] predictions are never written.
// A thread block takes P consecutive (block, mode) pairs, whose tiles
// fill whole rounds of its 256 threads (P halves, down to one round, while
// the thread blocks would not fill the card twice over).  It stages their
// rm rows (contiguous in rm: 16-byte loads; rows of odd length in shared
// memory, so that a warp's pairs read distinct banks), the source of the
// blocks they span (as is and transposed) and those blocks' references
// in shared memory once.  Its threads then walk (pair, tile) tasks, tile
// fastest, the planar pairs first, then the DC pairs, then the angular
// ones, so that a warp runs one of the three paths (a warp that mixes
// them runs them one after another).  A thread predicts its T x T tile
// one row of the mode's own orientation at a time (the row's T + 3 taps
// read once); a horizontal mode is computed on the transposed source,
// which transposes the residual and leaves its Hadamard abs-sum and DC
// term unchanged, so every index into the residual d[] is a compile-time
// constant and d[] stays in registers.
// The tiles of a pair are summed by shuffles within their segment of the
// warp into a shared accumulator, and each cost is written once, in
// order: no global atomics, no zeroed output.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kModes = 67;
constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23

__device__ __forceinline__ unsigned uabs(unsigned v) {
  return (int)v < 0 ? 0u - v : v;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float bf_add(float a, float c) {
  return __fadd_rn(a, c);
}
__device__ __forceinline__ float bf_sub(float a, float c) {
  return __fsub_rn(a, c);
}
__device__ __forceinline__ unsigned bf_add(unsigned a, unsigned c) {
  return a + c;
}
__device__ __forceinline__ unsigned bf_sub(unsigned a, unsigned c) {
  return a - c;
}

// stages len = 1, 2, .. < last of the natural-order (Sylvester) Hadamard
// of T values v[0], v[stride], ...
template <int T, typename V>
__device__ __forceinline__ void wht(V* v, int stride, int last = T) {
#pragma unroll
  for (int len = 1; len < last; len <<= 1)
#pragma unroll
    for (int i = 0; i < T; i += 2 * len)
#pragma unroll
      for (int j = i; j < i + len; ++j) {
        const V a = v[j * stride], c = v[(j + len) * stride];
        v[j * stride] = bf_add(a, c);
        v[(j + len) * stride] = bf_sub(a, c);
      }
}

// The arithmetic of a route.  Source samples are staged as src(), rm
// samples as ref(); a residual is V.  filt holds the taps [67, w, 4] as
// int32 and then the same taps as float32.
template <bool F>
struct Route;

template <>
struct Route<true> {  // float32 pipe, bit depths <= 10
  using V = float;
  __device__ static V src(int v) { return __fadd_rn((float)v, kMagic); }
  __device__ static V ref(int v) { return (float)v; }
  __device__ static V bits(unsigned u) { return __uint_as_float(u); }
  __device__ static void taps(const int* filt, int ntaps, int row, V* f) {
    const float4 t =
        __ldg(reinterpret_cast<const float4*>(filt + ntaps) + row);
    f[0] = t.x;
    f[1] = t.y;
    f[2] = t.z;
    f[3] = t.w;
  }
  __device__ static V vmax(int maxval) { return kMagic + (float)maxval; }
  // src - clip((f . w + 32) >> 6): (x + 0.5) / 64 rounded onto 1.5 * 2^23
  // is the floor of (x + 32) / 64 (|x| < 2^22)
  __device__ static V angular(V s, const V* w, const V* f, V vm) {
    float acc = __fmaf_rn(w[0], f[0], 0.5f);
    acc = __fmaf_rn(w[1], f[1], acc);
    acc = __fmaf_rn(w[2], f[2], acc);
    acc = __fmaf_rn(w[3], f[3], acc);
    const float y = fminf(fmaxf(__fmaf_rn(acc, 0.015625f, kMagic), kMagic), vm);
    return __fsub_rn(s, y);
  }
  __device__ static V minus(V s, int p) {
    return __fsub_rn(s, __fadd_rn((float)p, kMagic));
  }
  // the column pass and the cost of a tile whose rows are transformed:
  // the last stage fused with the abs-sum (every value an integer)
  template <int T>
  __device__ static unsigned tile_cost(V* d) {
#pragma unroll
    for (int j = 0; j < T; ++j) wht<T>(d + j, T, T / 2);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < T * T / 2; ++i)
      s = __fadd_rn(s, fmaxf(fabsf(d[i]), fabsf(d[i + T * T / 2])));
    const int is = 2 * __float2int_rn(s);
    if (T == 8) return (unsigned)((is + 2) >> 2);
    const int dc = __float2int_rn(fabsf(__fadd_rn(d[0], d[T * T / 2])));
    return (unsigned)((is - dc + (dc >> 2) + 1) >> 1);
  }
};

template <>
struct Route<false> {  // int32 wrap arithmetic, any bit depth
  using V = unsigned;
  __device__ static V src(int v) { return (unsigned)v; }
  __device__ static V ref(int v) { return (unsigned)v; }
  __device__ static V bits(unsigned u) { return u; }
  __device__ static void taps(const int* filt, int, int row, V* f) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(filt) + row);
    f[0] = (unsigned)t.x;
    f[1] = (unsigned)t.y;
    f[2] = (unsigned)t.z;
    f[3] = (unsigned)t.w;
  }
  __device__ static V vmax(int maxval) { return (unsigned)maxval; }
  __device__ static V angular(V s, const V* w, const V* f, V vm) {
    const unsigned acc = f[0] * w[0] + f[1] * w[1] + f[2] * w[2] + f[3] * w[3];
    return s - (unsigned)clampi((int)(acc + 32u) >> 6, 0, (int)vm);
  }
  __device__ static V minus(V s, int p) { return s - (unsigned)p; }
  template <int T>
  __device__ static unsigned tile_cost(V* d) {
#pragma unroll
    for (int j = 0; j < T; ++j) wht<T>(d + j, T);
    unsigned s = 0;
#pragma unroll
    for (int i = 0; i < T * T; ++i) s += uabs(d[i]);
    if (T == 8) return (unsigned)((int)(s + 2u) >> 2);
    const unsigned dc = uabs(d[0]);
    return (unsigned)((int)(s - dc + (unsigned)((int)dc >> 2) + 1u) >> 1);
  }
};

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
  int P;   // (block, mode) pairs a thread block
  int NB;  // most blocks P consecutive pairs span: P / 67 + 2
};

// words of shared memory a thread block uses: the source and its
// transpose of the NB blocks its pairs span (NB w^2 each), the top and
// left references of those blocks (NB (w + 2) each), the rm rows of its
// P pairs (P L) and their costs (P)
__host__ __device__ __forceinline__ int smem_words(int P, int NB, int w,
                                                   int L) {
  return NB * (2 * w * w + 2 * (w + 2)) + P * (L + 2);
}

// pairs of mode m among the n pairs from p0 (pair p = block * 67 + mode)
__device__ __forceinline__ int count_mode(long long p0, int n, int m) {
  const long long first = p0 + ((m - p0 % kModes) + kModes) % kModes;
  return first < p0 + n ? (int)((p0 + n - 1 - first) / kModes) + 1 : 0;
}

template <int T, bool F>
__global__ void __launch_bounds__(kThreads, 2) mode_costs_kernel(const Args a) {
  using Rt = Route<F>;
  using V = typename Rt::V;
  extern __shared__ __align__(16) unsigned smem[];
  const int w = a.w, ww = w * w, L = a.L;
  const long long p0 = (long long)blockIdx.x * a.P;
  const int np = (int)(a.B * kModes - p0 < a.P ? a.B * kModes - p0 : a.P);
  const long long blo = p0 / kModes;
  const int nblk = (int)((p0 + np - 1) / kModes - blo) + 1;
  V* src_s = reinterpret_cast<V*>(smem);
  V* srcT_s = src_s + a.NB * ww;
  V* rm_s = srcT_s + a.NB * ww;
  int* top_s = reinterpret_cast<int*>(rm_s + a.P * (L + 1));
  int* left_s = top_s + a.NB * (w + 2);
  unsigned* acc_s = reinterpret_cast<unsigned*>(left_s + a.NB * (w + 2));
  const int tid = threadIdx.x, lane = tid & 31;

  // ---- staging: 16-byte loads (w^2 and L are multiples of 4) ----
  const bool vec = (((uintptr_t)a.src | (uintptr_t)a.rm) & 15) == 0;
  for (int k = tid; k < nblk * ww / 4; k += kThreads) {
    const int g = k / (ww / 4), e = 4 * (k - g * (ww / 4));
    const int* p = a.src + (blo + g) * ww + e;
    const int4 v = vec ? *reinterpret_cast<const int4*>(p)
                       : make_int4(p[0], p[1], p[2], p[3]);
    const int vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int y = (e + c) / w, x = (e + c) - ((e + c) / w) * w;
      src_s[g * ww + e + c] = Rt::src(vs[c]);
      srcT_s[g * ww + x * w + y] = Rt::src(vs[c]);
    }
  }
  const int Ls = L + 1;  // odd: the rows of a warp's pairs spread over banks
  for (int k = tid; k < np * L / 4; k += kThreads) {
    const int* p = a.rm + p0 * L + 4 * k;
    const int4 v = vec ? *reinterpret_cast<const int4*>(p)
                       : make_int4(p[0], p[1], p[2], p[3]);
    V* q = rm_s + (4 * k / L) * Ls + (4 * k) % L;
    q[0] = Rt::ref(v.x);
    q[1] = Rt::ref(v.y);
    q[2] = Rt::ref(v.z);
    q[3] = Rt::ref(v.w);
  }
  for (int k = tid; k < nblk * (w + 2); k += kThreads) {
    const int g = k / (w + 2), i = k - g * (w + 2);
    top_s[k] = a.tops[(blo + g) * a.Lt + i];
    left_s[k] = a.lefts[(blo + g) * a.Ll + i];
  }
  for (int k = tid; k < np; k += kThreads) acc_s[k] = 0;
  __syncthreads();

  // ---- (pair, tile) tasks, tile fastest, the planar pairs first, then
  // the DC pairs, then the angular ones: a warp runs one path but at the
  // two boundaries ----
  constexpr int kSegMax = 32;
  // w / T and the tile count are powers of two: shifts, not divisions
  const int lntx = a.log2w - (T == 8 ? 3 : 2), ntx = 1 << lntx;
  const int lnt = 2 * lntx, ntiles = 1 << lnt;
  const int ntasks = np * ntiles, ntaps = kModes * w * 4;
  const V vm = Rt::vmax(a.maxval);
  const int m0 = (int)(p0 - blo * kModes);
  const int n0 = count_mode(p0, np, 0), n1 = count_mode(p0, np, 1);
  const int first_ang = m0 < 2 ? 2 - m0 : 0, ang0 = kModes - (m0 < 2 ? 2 : m0);
  for (int base = (tid & ~31); base < ntasks; base += kThreads) {
    const int t = base + lane;
    const bool live = t < ntasks;
    const int j = t >> lnt, tile = t & (ntiles - 1);
    int pair;  // the j-th pair of that order, from p0
    if (j < n0) {
      pair = (kModes - m0) % kModes + kModes * j;
    } else if (j < n0 + n1) {
      pair = (kModes + 1 - m0) % kModes + kModes * (j - n0);
    } else {
      const int k = j - n0 - n1;
      pair = k < ang0 ? first_ang + k
                      : (kModes - m0) + kModes * ((k - ang0) / (kModes - 2)) +
                            2 + (k - ang0) % (kModes - 2);
    }
    unsigned val = 0;
    if (live) {
      const int q = m0 + pair, g = q / kModes, m = q - g * kModes;
      const int r0 = (tile >> lntx) * T, c0 = (tile & (ntx - 1)) * T;
      V d[T * T];
      if (m >= 2) {
        // rows of the mode's own orientation: the source as is for a
        // vertical mode, transposed for a horizontal one
        const V* sp = (__ldg(a.transposed + m) ? srcT_s : src_s) + g * ww;
        const V* rmb = rm_s + pair * Ls + c0;
#pragma unroll
        for (int u = 0; u < T; ++u) {
          const int r = r0 + u;
          V f[4];
          Rt::taps(a.filt, ntaps, m * w + r, f);
          const V* gp = rmb + __ldg(a.row_start + m * w + r);
          V win[T + 3];
#pragma unroll
          for (int c = 0; c < T + 3; ++c) win[c] = gp[c];
          const uint4* s4 = reinterpret_cast<const uint4*>(sp + r * w + c0);
#pragma unroll
          for (int q = 0; q < T / 4; ++q) {
            const uint4 sv = s4[q];
            const V s[4] = {Rt::bits(sv.x), Rt::bits(sv.y), Rt::bits(sv.z),
                            Rt::bits(sv.w)};
#pragma unroll
            for (int c = 0; c < 4; ++c)
              d[u * T + 4 * q + c] =
                  Rt::angular(s[c], win + 4 * q + c, f, vm);
          }
        }
      } else {
        const int* top = top_s + g * (w + 2);
        const int* left = left_s + g * (w + 2);
        const V* sp = src_s + g * ww;
        const int lw = a.log2w;
        unsigned dcv = (unsigned)w;
        if (m == 1) {
          for (int k = 1; k <= w; ++k)
            dcv += (unsigned)top[k] + (unsigned)left[k];
          dcv = (unsigned)((int)dcv >> (lw + 1));
        }
        const unsigned trr = (unsigned)top[1 + w], br = (unsigned)left[1 + w];
#pragma unroll
        for (int i = 0; i < T; ++i) {
          const unsigned lc = (unsigned)left[1 + r0 + i];
#pragma unroll
          for (int c = 0; c < T; ++c) {
            const unsigned tp = (unsigned)top[1 + c0 + c];
            const unsigned hor =
                (lc << lw) + (unsigned)(c0 + c + 1) * (trr - lc);
            const unsigned ver =
                (tp << lw) + (unsigned)(r0 + i + 1) * (br - tp);
            const int planar =
                (int)((hor << lw) + (ver << lw) + (1u << (2 * lw))) >>
                (1 + 2 * lw);
            d[i * T + c] = Rt::minus(sp[(r0 + i) * w + c0 + c],
                                     m == 0 ? planar : (int)dcv);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < T; ++i) wht<T>(d + i * T, 1);  // rows: D H
      val = Rt::template tile_cost<T>(d);                // columns, cost
    }
    // ntiles is a power of two that divides 32 or a multiple of 32: sum
    // within the pair's segment of the warp, one shared add a segment
    const int seg = ntiles < kSegMax ? ntiles : kSegMax;
    for (int o = seg >> 1; o > 0; o >>= 1)
      val += __shfl_down_sync(0xffffffffu, val, o, seg);
    if (live && (lane & (seg - 1)) == 0) atomicAdd(acc_s + pair, val);
  }
  __syncthreads();
  for (int k = tid; k < np; k += kThreads) a.out[p0 + k] = (int)acc_s[k];
}

// pairs a thread block: tasks (pairs x tiles) filling whole rounds of the
// 256 threads, within about 70 KB of shared memory
int pairs_for(int w) {
  switch (w) {
    case 4: return 512;   // 512 tasks
    case 8: return 512;   // 512
    case 16: return 256;  // 1024
    case 32: return 64;   // 1024
    default: return 16;   // 64x64: 1024
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

template <int T, bool F>
cudaError_t launch(const Args& a, unsigned grid, size_t shm, cudaStream_t st) {
  if (shm > 48 * 1024) {  // set on the current card
    const cudaError_t e = cudaFuncSetAttribute(
        mode_costs_kernel<T, F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (e != cudaSuccess) return e;
  }
  mode_costs_kernel<T, F><<<grid, kThreads, shm, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// src [B, w, w], rm [B, 67, L], tops [B, Lt] (Lt >= w + 2), lefts [B, Ll]
// (Ll >= w + 2) int32 -> out [B, 67] int32 (every entry written); w in
// 4 .. 64, a power of two; the tables are ops/intra_batch._device_tables(w)
// (filt: the [67, w, 4] taps as int32, then as float32).  At bit_depth
// <= 10 the samples must lie in 0 .. 2^bit_depth - 1 (the float32
// route's exactness).  Returns cudaGetLastError() after the launch on
// `stream`.
extern "C" int vt_mode_costs(const void* src, const void* rm, const void* tops,
                             int Lt, const void* lefts, int Ll, void* out,
                             long long B, int L, int w, int bit_depth,
                             const void* row_start, const void* filt,
                             const void* transposed, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (B <= 0 || w < 4 || w > 64 || (w & (w - 1)) || Lt < w + 2 ||
      Ll < w + 2 || L != 3 * w + 8 || bit_depth < 1 || bit_depth > 30 ||
      ((uintptr_t)filt & 15))
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
  // halve P while the thread blocks would not fill the card twice over
  // and a block still has a round of tasks
  const long long pairs = B * kModes;
  const int T = w == 4 ? 4 : 8, ntiles = (w / T) * (w / T);
  a.P = pairs_for(w);
  while (a.P > 1 && (pairs + a.P - 1) / a.P < 2LL * sm_count() &&
         a.P * ntiles > kThreads)
    a.P >>= 1;
  a.NB = a.P / kModes + 2;
  const long long grid = (pairs + a.P - 1) / a.P;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t shm = (size_t)smem_words(a.P, a.NB, w, L) * 4;
  cudaStream_t st = (cudaStream_t)stream;
  const bool fl = bit_depth <= 10;
  cudaError_t e;
  if (T == 4)
    e = fl ? launch<4, true>(a, (unsigned)grid, shm, st)
           : launch<4, false>(a, (unsigned)grid, shm, st);
  else
    e = fl ? launch<8, true>(a, (unsigned)grid, shm, st)
           : launch<8, false>(a, (unsigned)grid, shm, st);
  return (int)e;
}

// The resources of the kernel for w x w blocks on the current card (the
// route of bit depths <= 10, pairs_for(w) pairs a thread block): out[6] =
// registers, static and dynamic shared bytes, threads, resident blocks
// per SM, local (stack) bytes.  Returns a cudaError_t.
extern "C" int vt_mode_costs_attrs(int w, int* out) {
  if (w < 4 || w > 64 || (w & (w - 1))) return (int)cudaErrorInvalidValue;
  const void* f = w == 4 ? (const void*)mode_costs_kernel<4, true>
                         : (const void*)mode_costs_kernel<8, true>;
  const int P = pairs_for(w);
  const size_t shm = (size_t)smem_words(P, P / kModes + 2, w, 3 * w + 8) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      f, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, f);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f, kThreads, shm);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)shm;
  out[3] = kThreads;
  out[4] = blocks;
  out[5] = (int)a.localSizeBytes;
  return 0;
}

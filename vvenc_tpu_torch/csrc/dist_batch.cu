// K10 dist_batch: the batched distortions of two [B, H, W] int32 inputs,
// one value per batch element: SSE (float32), SAD (int32) and the
// vvenc-convention Hadamard SATD with an explicit tile (int32).
//
// Replaces vvenc_tpu/ops/rdcost.py:67 sse_batch, :73 sad_batch and :78
// satd_batch, XLA programs on the TPU (a float32 square-and-sum, an int32
// abs-and-sum, and an int32 einsum hm @ tile @ hm with an abs-sum).
//
//   sse:  the exact integer sum of (a - b)^2 in 64 bits, rounded once to
//         float32 (the reference sums float32 squares in XLA's order; the
//         two agree within rtol 1e-5)
//   sad:  sum |a - b| in int32
//   satd: per tile x tile tile T = H D H (natural-order Hadamard) of the
//         difference D, s = sum |T|; tile 8: (s + 2) >> 2; every other
//         tile: s - |T00| + (|T00| >> 2), then (s + 1) >> 1; summed over
//         the tiles
//
// Exact: sad and satd are the reference's int32 arithmetic taken in
// unsigned arithmetic, so that every sum wraps modulo 2^32 as XLA's int32
// does (a 32x32 tile of 10-bit differences can pass 2^31) instead of
// being undefined; |INT_MIN| stays INT_MIN and >> on the signed value is
// arithmetic, as in XLA.  The Hadamard is integer butterflies (a sum of
// the same products as the reference's matrix products, so equal modulo
// 2^32); the per-tile values are summed with integer adds, whose order
// does not matter modulo 2^32.
//
// Bound: bytes.  Each input sample is read once (8 bytes for the pair)
// against a handful of integer operations (SATD: 2 log2(tile) butterfly
// adds and an abs-sum per sample; the [8040, 16, 16] pair of a 1080p
// 16x16 grid is 16.5 MB, 4.9 us at 3.35 TB/s).  sse and sad run one
// thread block per batch element, its threads striding over the samples
// and reducing by warp shuffles.  satd (the first kernel gave a whole
// 8x8 tile to one thread, whose 128 scalar loads put neighbouring lanes
// 32 bytes apart, added the tiles with atomics into a zeroed output and
// ran tiles 16..64 with T of 64 threads busy):
// - tiles 1..16: a tile on T lanes (32 at 16), a lane a row of T values
//   (8 at 16, two lanes a row) read as 16-byte vectors; the row
//   butterflies in the lane (and across its row's two lanes at 16), the
//   column butterflies across the tile's lanes by xor shuffles, the
//   absolute sums by shuffles, the tile's rounding on its first lane; at
//   1080p tile 8 a warp takes one 16x16 element (four tiles, 1 KB an
//   input) and a single wave of warps keeps the whole input in flight;
// - small elements share a warp (LPE lanes each), larger ones take up to
//   the block's eight warps, about two tile-steps a warp;
// - tiles 4 and 8 in elements of 32 tiles or more (64x64 at tile 8): a
//   thread a tile, its rows read as 16-byte vectors, both passes in its
//   registers, the element's tiles on up to 256 threads; with no
//   shuffles it issues half the instructions of the lanes' form, which
//   on large elements was slower than the first kernel;
// - tiles 32 and 64: a block of T^2 / 8 threads a tile, a thread 8 values
//   of a row; the rows go through shared memory transposed and come back
//   as columns for the same butterflies;
// - every element's tiles are reduced within its warp or block and stored
//   by one thread, so no atomic remains and the output needs no zeroing;
// - a tensor off 16-byte alignment (a view that starts 4 bytes in) reads
//   its rows with 4-byte loads, through the same kernel.
// tests/test_torch_k8k10_models.py holds the lane-shuffle decomposition
// against the reference.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileThreadsMin = 32;  // tiles an element for a thread a tile

__device__ __forceinline__ unsigned uabs(unsigned v) {
  return (int)v < 0 ? 0u - v : v;
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

// a tile's value from s = sum |T| and dc = |T00| (int32 semantics)
__device__ __forceinline__ unsigned tile_value(int T, unsigned s, unsigned dc) {
  if (T == 8) return (unsigned)((int)(s + 2u) >> 2);
  const unsigned s2 = s - dc + (unsigned)((int)dc >> 2);
  return (unsigned)((int)(s2 + 1u) >> 1);
}

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// sum of v over the thread block (blockDim.x a multiple of 32, <= 1024);
// thread 0 gets the result
template <typename V>
__device__ V block_sum(V v, V* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  V s = 0;
  if (threadIdx.x == 0)
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
  return s;
}

template <bool SSE>
__global__ void __launch_bounds__(kThreads) dist_kernel(
    const int* __restrict__ a, const int* __restrict__ b, void* out, int n) {
  __shared__ unsigned long long red[kThreads / 32];
  const size_t base = (size_t)blockIdx.x * n;
  unsigned long long acc = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const unsigned d = (unsigned)__ldg(a + base + i) - (unsigned)__ldg(b + base + i);
    if (SSE) {
      const long long ds = (int)d;  // the difference wraps to int32 first
      acc += (unsigned long long)(ds * ds);
    } else {
      acc += uabs(d);
    }
  }
  const unsigned long long s = block_sum(acc, red);
  if (threadIdx.x == 0) {
    if (SSE)
      ((float*)out)[blockIdx.x] = (float)(long long)s;  // round to nearest
    else
      ((int*)out)[blockIdx.x] = (int)(unsigned)s;       // modulo 2^32
  }
}

// the lanes of a tile: a lane holds P = min(T, 8) consecutive values of
// one tile row, LR = T / P lanes a row, TPT = T * LR lanes a tile
template <int T>
struct Geo {
  static constexpr int P = T < 8 ? T : 8;
  static constexpr int LR = T / P;
  static constexpr int TPT = T * LR;
};

// a lane's P differences a - b (modulo 2^32) from word offset off: 16-byte
// (8-byte at P = 2) loads when VEC, else 4-byte loads
template <int P, bool VEC>
__device__ __forceinline__ void load_diff(const int* __restrict__ a,
                                          const int* __restrict__ b,
                                          size_t off, unsigned (&d)[P]) {
  if constexpr (VEC && P >= 4) {
#pragma unroll
    for (int q = 0; q < P / 4; ++q) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(a + off) + q);
      const int4 y = __ldg(reinterpret_cast<const int4*>(b + off) + q);
      d[4 * q] = (unsigned)x.x - (unsigned)y.x;
      d[4 * q + 1] = (unsigned)x.y - (unsigned)y.y;
      d[4 * q + 2] = (unsigned)x.z - (unsigned)y.z;
      d[4 * q + 3] = (unsigned)x.w - (unsigned)y.w;
    }
  } else if constexpr (VEC && P == 2) {
    const int2 x = __ldg(reinterpret_cast<const int2*>(a + off));
    const int2 y = __ldg(reinterpret_cast<const int2*>(b + off));
    d[0] = (unsigned)x.x - (unsigned)y.x;
    d[1] = (unsigned)x.y - (unsigned)y.y;
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j)
      d[j] = (unsigned)__ldg(a + off + j) - (unsigned)__ldg(b + off + j);
  }
}

// the butterflies across lanes: half-lengths m = LO .. HI / 2 of the index
// held in the lane bits, the lane whose bit m is set taking the difference
template <int P>
__device__ __forceinline__ void wht_lanes(unsigned (&d)[P], int lo, int hi,
                                          int lane) {
  for (int m = lo; m < hi; m <<= 1) {
    const bool upper = lane & m;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const unsigned o = __shfl_xor_sync(0xffffffffu, d[j], m);
      d[j] = upper ? o - d[j] : d[j] + o;
    }
  }
}

// one 1-D Hadamard of length T along a row held as P values a lane on LR
// consecutive lanes (chunk bits = the low lane bits)
template <int T>
__device__ __forceinline__ void wht_row(unsigned (&d)[Geo<T>::P], int lane) {
  wht<Geo<T>::P>(d, 1);
  if constexpr (Geo<T>::LR > 1) wht_lanes<Geo<T>::P>(d, 1, Geo<T>::LR, lane);
}

struct SatdParams {
  long long B;
  int H, W, ntx, ntiles;
  int LPE;  // lanes an element (a power of two up to 32)
  int SE;   // steps an element: LPE / TPT tiles each
  int WPE;  // warps an element (a power of two up to 8)
};

// tiles of 1 .. 16: a tile on TPT <= 32 lanes, a lane a row (two at 16);
// the row butterflies in the lane (and across the two lanes at 16), the
// column butterflies across the tile's lanes by shuffles.  An element is
// LPE lanes of one warp (several elements a warp when they are small) or
// WPE warps of the block, each taking every WPE-th tile-step; its tiles'
// values are summed by shuffles (and shared memory across its warps) and
// stored by one thread.
template <int T, bool VEC>
__global__ void __launch_bounds__(kThreads) satd_warp_kernel(
    const int* __restrict__ a, const int* __restrict__ b,
    unsigned* __restrict__ out, const SatdParams p) {
  using G = Geo<T>;
  __shared__ unsigned red[kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int epw = 32 / p.LPE, groups = (kThreads / 32) / p.WPE;
  const long long e0 = (long long)blockIdx.x * groups * epw;
  const int eg = warp / p.WPE, wi = warp - eg * p.WPE;
  const int ll = lane & (p.LPE - 1);
  const long long e = e0 + eg * epw + lane / p.LPE;
  const bool ev = e < p.B;
  const int tps = p.LPE / G::TPT, tl = ll / G::TPT;
  const int li = lane & (G::TPT - 1), r = li / G::LR, c = li % G::LR;
  const size_t ebase = ev ? (size_t)e * p.H * p.W : 0;
  unsigned acc = 0;
  // not unrolled: 32 registers keep eight blocks an SM, so a 1080p 16x16
  // grid (1,005 blocks) runs in one wave
#pragma unroll 1
  for (int s = wi; s < p.SE; s += p.WPE) {
    const int tile = s * tps + tl;
    const bool ok = ev && tile < p.ntiles;
    unsigned d[G::P];
    if (ok) {
      const int ty = tile / p.ntx, tx = tile - ty * p.ntx;
      load_diff<G::P, VEC>(a, b,
                           ebase + (size_t)(ty * T + r) * p.W + tx * T +
                               c * G::P,
                           d);
    } else {
#pragma unroll
      for (int j = 0; j < G::P; ++j) d[j] = 0;
    }
    wht_row<T>(d, lane);                          // rows: D H
    wht_lanes<G::P>(d, G::LR, G::TPT, lane);      // columns: H (D H)
    unsigned sum = 0;
#pragma unroll
    for (int j = 0; j < G::P; ++j) sum += uabs(d[j]);
#pragma unroll
    for (int m = 1; m < G::TPT; m <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, m);
    const unsigned dc =
        __shfl_sync(0xffffffffu, d[0], lane & ~(G::TPT - 1));
    if (ok && li == 0) acc += tile_value(T, sum, uabs(dc));
  }
  for (int m = 1; m < p.LPE; m <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (p.WPE == 1) {
    if (ev && ll == 0) out[e] = acc;
    return;
  }
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if ((int)threadIdx.x < groups && e0 + threadIdx.x < p.B) {
    unsigned s = 0;
    for (int i = 0; i < p.WPE; ++i) s += red[threadIdx.x * p.WPE + i];
    out[e0 + threadIdx.x] = s;
  }
}

// tiles of 4 and 8 in elements of at least kTileThreadsMin tiles: a thread
// a tile, its rows read as 16-byte vectors and both butterfly passes in
// its registers (no shuffles, twice fewer instructions than the lanes'
// form); TE = LPE threads an element (32 .. 256), each taking tiles TE
// apart; the tiles' values summed by shuffles and shared memory and stored
// by one thread
template <int T, bool VEC>
__global__ void __launch_bounds__(kThreads) satd_tile_kernel(
    const int* __restrict__ a, const int* __restrict__ b,
    unsigned* __restrict__ out, const SatdParams p) {
  __shared__ unsigned red[kThreads / 32];
  const int te = p.LPE, epb = kThreads / te;
  const int lane = threadIdx.x & 31, le = threadIdx.x & (te - 1);
  const long long e0 = (long long)blockIdx.x * epb;
  const long long e = e0 + threadIdx.x / te;
  unsigned acc = 0;
  if (e < p.B) {
    const size_t ebase = (size_t)e * p.H * p.W;
    for (int tile = le; tile < p.ntiles; tile += te) {
      const int ty = tile / p.ntx, tx = tile - ty * p.ntx;
      unsigned d[T][T];
#pragma unroll
      for (int i = 0; i < T; ++i)
        load_diff<T, VEC>(a, b, ebase + (size_t)(ty * T + i) * p.W + tx * T,
                          d[i]);
#pragma unroll
      for (int i = 0; i < T; ++i) wht<T>(d[i], 1);      // rows: D H
#pragma unroll
      for (int j = 0; j < T; ++j) wht<T>(&d[0][j], T);  // columns: H (D H)
      unsigned sum = 0;
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int j = 0; j < T; ++j) sum += uabs(d[i][j]);
      acc += tile_value(T, sum, uabs(d[0][0]));
    }
  }
  acc = warp_sum(acc);
  if (te == 32) {
    if (lane == 0 && e < p.B) out[e] = acc;
    return;
  }
  if (lane == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  const int wpe = te / 32;
  if ((int)threadIdx.x < epb && e0 + threadIdx.x < p.B) {
    unsigned t = 0;
    for (int i = 0; i < wpe; ++i) t += red[threadIdx.x * wpe + i];
    out[e0 + threadIdx.x] = t;
  }
}

// tiles of 32 and 64: a thread block of TPT = T^2 / 8 threads an element,
// a tile at a time: a thread takes 8 values of a row; the row butterflies
// in the thread and across its row's LR lanes, then the rows go to shared
// memory transposed and come back as columns for the same butterflies;
// the absolute sums by shuffles and shared memory; thread 0 adds the
// tiles' values and stores the element's sum
template <int T, bool VEC>
__global__ void __launch_bounds__(Geo<T>::TPT) satd_block_kernel(
    const int* __restrict__ a, const int* __restrict__ b,
    unsigned* __restrict__ out, const SatdParams p) {
  using G = Geo<T>;
  __shared__ unsigned t[T * (T + 1)];
  __shared__ unsigned red[G::TPT / 32];
  const int lane = threadIdx.x & 31;
  const int r = threadIdx.x / G::LR, c = threadIdx.x % G::LR;
  const long long e = blockIdx.x;
  const size_t ebase = (size_t)e * p.H * p.W;
  unsigned acc = 0;
  for (int tile = 0; tile < p.ntiles; ++tile) {
    const int ty = tile / p.ntx, tx = tile - ty * p.ntx;
    unsigned d[8];
    load_diff<8, VEC>(a, b, ebase + (size_t)(ty * T + r) * p.W + tx * T + 8 * c,
                      d);
    wht_row<T>(d, lane);                          // rows: D H
#pragma unroll
    for (int j = 0; j < 8; ++j) t[(8 * c + j) * (T + 1) + r] = d[j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j) d[j] = t[r * (T + 1) + 8 * c + j];
    wht_row<T>(d, lane);                          // columns: H (D H)
    unsigned sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) sum += uabs(d[j]);
    sum = warp_sum(sum);
    if (lane == 0) red[threadIdx.x >> 5] = sum;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned tot = 0;
      for (int i = 0; i < G::TPT / 32; ++i) tot += red[i];
      acc += tile_value(T, tot, uabs(d[0]));  // d[0] of thread 0: T00
    }
  }
  if (threadIdx.x == 0) out[e] = acc;
}

int pow2_floor(long long v) {
  int p = 1;
  while (2LL * p <= v) p *= 2;
  return p;
}

// the kernel, its launch and parameters for B elements of H x W at tile
// T; vec: a and b 16-byte aligned
struct SatdLaunch {
  const void* f;
  SatdParams p;
  int threads;
  long long grid;
};

template <int T>
const void* satd_fn(bool vec) {
  if constexpr (T >= 32)
    return vec ? (const void*)satd_block_kernel<T, true>
               : (const void*)satd_block_kernel<T, false>;
  else
    return vec ? (const void*)satd_warp_kernel<T, true>
               : (const void*)satd_warp_kernel<T, false>;
}

SatdLaunch satd_plan(long long B, int H, int W, int T, bool vec) {
  SatdLaunch L;
  SatdParams& p = L.p;
  p.B = B;
  p.H = H;
  p.W = W;
  p.ntx = W / T;
  p.ntiles = p.ntx * (H / T);
  const int P = T < 8 ? T : 8, tpt = T * (T / P);
  if ((T == 4 || T == 8) && p.ntiles >= kTileThreadsMin) {
    const int te = pow2_floor(p.ntiles);
    p.LPE = te < kThreads ? te : kThreads;
    p.SE = p.WPE = 1;
    L.f = T == 4 ? (vec ? (const void*)satd_tile_kernel<4, true>
                        : (const void*)satd_tile_kernel<4, false>)
                 : (vec ? (const void*)satd_tile_kernel<8, true>
                        : (const void*)satd_tile_kernel<8, false>);
    L.threads = kThreads;
    L.grid = (B + kThreads / p.LPE - 1) / (kThreads / p.LPE);
    return L;
  }
  switch (T) {
    case 1: L.f = satd_fn<1>(vec); break;
    case 2: L.f = satd_fn<2>(vec); break;
    case 4: L.f = satd_fn<4>(vec); break;
    case 8: L.f = satd_fn<8>(vec); break;
    case 16: L.f = satd_fn<16>(vec); break;
    case 32: L.f = satd_fn<32>(vec); break;
    default: L.f = satd_fn<64>(vec); break;
  }
  if (T >= 32) {
    p.LPE = 32;
    p.SE = p.ntiles;
    p.WPE = tpt / 32;
    L.threads = tpt;
    L.grid = B;
    return L;
  }
  if (p.ntiles <= 32 / tpt) {
    p.LPE = pow2_floor(2LL * p.ntiles - 1) * tpt;
    p.SE = 1;
    p.WPE = 1;
  } else {
    // about two tile-steps a warp, up to the block's 8 warps an element
    p.LPE = 32;
    p.SE = (p.ntiles + 32 / tpt - 1) / (32 / tpt);
    const int wpe = pow2_floor(p.SE / 2 > 1 ? p.SE / 2 : 1);
    p.WPE = wpe < kThreads / 32 ? wpe : kThreads / 32;
  }
  L.threads = kThreads;
  const long long per_block = (long long)(kThreads / 32 / p.WPE) *
                              (32 / p.LPE);
  L.grid = (B + per_block - 1) / per_block;
  return L;
}

bool shape_ok(long long B, int H, int W) {
  return B > 0 && B <= 0x7fffffffLL && H > 0 && W > 0 &&
         (long long)H * W <= 0x7fffffffLL;
}

}  // namespace

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// a, b [B, H, W] int32 -> out [B] float32.  Returns cudaGetLastError()
// after the launch on `stream`.
extern "C" int vt_sse_batch(const void* a, const void* b, void* out,
                            long long B, int H, int W, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (!shape_ok(B, H, W)) return (int)cudaErrorInvalidValue;
  dist_kernel<true><<<(unsigned)B, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)a, (const int*)b, out, H * W);
  return (int)cudaGetLastError();
}

// a, b [B, H, W] int32 -> out [B] int32.
extern "C" int vt_sad_batch(const void* a, const void* b, void* out,
                            long long B, int H, int W, void* stream) {
  cudaGetLastError();
  if (!shape_ok(B, H, W)) return (int)cudaErrorInvalidValue;
  dist_kernel<false><<<(unsigned)B, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)a, (const int*)b, out, H * W);
  return (int)cudaGetLastError();
}

// a, b [B, H, W] int32 -> out [B] int32 (every element written once; its
// prior content is not read); tile a power of two <= 64 dividing H and W.
extern "C" int vt_satd_batch(const void* a, const void* b, void* out,
                             long long B, int H, int W, int tile,
                             void* stream) {
  cudaGetLastError();
  if (!shape_ok(B, H, W) || tile < 1 || tile > 64 || (tile & (tile - 1)) ||
      H % tile || W % tile)
    return (int)cudaErrorInvalidValue;
  const uintptr_t ab = (uintptr_t)a | (uintptr_t)b;
  const bool vec = (ab & (tile == 2 ? 7 : 15)) == 0;
  const SatdLaunch L = satd_plan(B, H, W, tile, vec);
  if (L.grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&a, (void*)&b, (void*)&out, (void*)&L.p};
  const cudaError_t e =
      cudaLaunchKernel(L.f, dim3((unsigned)L.grid), dim3(L.threads), args, 0,
                       (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the resources of satd's kernel for a large batch of H x W elements at
// tile `tile` on aligned inputs: out = registers per thread, static and
// dynamic shared memory bytes, threads per block, resident blocks per SM,
// local memory bytes per thread.
extern "C" int vt_dist_batch_attrs(int tile, int H, int W, int* out) {
  if (!shape_ok(1, H, W) || tile < 1 || tile > 64 || (tile & (tile - 1)) ||
      H % tile || W % tile)
    return (int)cudaErrorInvalidValue;
  const SatdLaunch L = satd_plan(1LL << 30, H, W, tile, true);
  cudaFuncAttributes at;
  cudaError_t e = cudaFuncGetAttributes(&at, L.f);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, L.f, L.threads,
                                                    0);
  if (e != cudaSuccess) return (int)e;
  out[0] = at.numRegs;
  out[1] = (int)at.sharedSizeBytes;
  out[2] = 0;
  out[3] = L.threads;
  out[4] = blocks;
  out[5] = (int)at.localSizeBytes;
  return 0;
}

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
// 16x16 grid is 16.5 MB, 4.9 us at 3.35 TB/s; the 4x4 grid's 17.1 MB
// 5.1 us).  sse and sad (the first kernel ran a 256-thread block an
// element on 4-byte loads, its sum through shared memory, a barrier and
// a serial loop on thread 0: at 4x4, 240 of 256 threads idle and 123
// waves of blocks):
// - an element's U units (16-byte vectors of 4 samples, or single
//   samples on the 4-byte path) go to TE threads, a power of two of
//   about U / 2 up to 256: a thread takes units ti, ti + TE, ..., two at
//   a time, all four loads issued before any arithmetic; neighbouring
//   threads read neighbouring units, so a warp's load covers whole
//   32-byte sectors;
// - small elements share a warp (LPE = TE lanes each), larger ones take
//   WPE = TE / 32 warps of the block;
// - the element's lanes sum by a segmented __shfl_down_sync (no shared
//   memory, no barrier up to 32 lanes), the warps of a larger element
//   through shared memory, and one thread stores the element;
// - one wave of blocks (the resident blocks of the card) loops over the
//   elements;
// - the 4-byte path, in the same kernel, takes elements of H W not a
//   multiple of 4 samples and tensors off 16-byte alignment.
// sse sums in unsigned 64 bits and sad in unsigned 32 bits, as the
// first kernel: modular sums, so no order of the adds changes a bit.
// tests/test_torch_k7k10_models.py holds this decomposition against the
// reference.  satd (the first kernel gave a whole 8x8 tile to one
// thread, whose 128 scalar loads put neighbouring lanes 32 bytes apart,
// added the tiles with atomics into a zeroed output and ran tiles 16..64
// with T of 64 threads busy):
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

#include <atomic>
#include <type_traits>

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

// ---- sse and sad ----------------------------------------------------------

// the accumulator: sse the exact sum of squares modulo 2^64, sad modulo 2^32
template <bool SSE>
using DistAcc = typename std::conditional<SSE, unsigned long long,
                                          unsigned>::type;

template <bool SSE>
__device__ __forceinline__ void dist_add(unsigned d, DistAcc<SSE>& acc) {
  if constexpr (SSE) {
    const long long ds = (int)d;  // the difference wraps to int32 first
    acc += (unsigned long long)(ds * ds);
  } else {
    acc += uabs(d);
  }
}

template <bool SSE>
__device__ __forceinline__ void dist_unit(int4 x, int4 y, DistAcc<SSE>& acc) {
  dist_add<SSE>((unsigned)x.x - (unsigned)y.x, acc);
  dist_add<SSE>((unsigned)x.y - (unsigned)y.y, acc);
  dist_add<SSE>((unsigned)x.z - (unsigned)y.z, acc);
  dist_add<SSE>((unsigned)x.w - (unsigned)y.w, acc);
}

template <bool SSE>
__device__ __forceinline__ void dist_unit(int x, int y, DistAcc<SSE>& acc) {
  dist_add<SSE>((unsigned)x - (unsigned)y, acc);
}

struct DistParams {
  long long B;
  unsigned U;  // units an element: 16-byte vectors (VEC) or samples
  int LPE;     // lanes an element in its warp (a power of two up to 32)
  int WPE;     // warps an element (a power of two up to 8; LPE 32 if > 1)
};

// an element's U units on TE = LPE * WPE threads, thread ti taking units
// ti, ti + TE, ... two at a time; the lanes' sums by a segmented shuffle,
// the warps' (WPE > 1) through shared memory; one store an element; the
// blocks loop over the elements
template <bool SSE, bool VEC>
__global__ void __launch_bounds__(kThreads) dist_kernel(
    const int* __restrict__ a, const int* __restrict__ b,
    void* __restrict__ out, const DistParams p) {
  using Unit = typename std::conditional<VEC, int4, int>::type;
  using Acc = DistAcc<SSE>;
  __shared__ Acc red[kThreads / 32];
  const Unit* __restrict__ ua = reinterpret_cast<const Unit*>(a);
  const Unit* __restrict__ ub = reinterpret_cast<const Unit*>(b);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int epw = 32 / p.LPE, groups = (kThreads / 32) / p.WPE;
  const long long epb = (long long)groups * epw;  // elements a block step
  const int eg = warp / p.WPE, wi = warp - eg * p.WPE;
  const int ll = lane & (p.LPE - 1);
  const unsigned te = (unsigned)(p.LPE * p.WPE);
  const unsigned ti = (unsigned)(wi * p.LPE + ll);
  for (long long e0 = (long long)blockIdx.x * epb; e0 < p.B;
       e0 += (long long)gridDim.x * epb) {
    const long long e = e0 + eg * epw + lane / p.LPE;
    Acc acc = 0;
    if (e < p.B) {
      const Unit* __restrict__ pa = ua + (size_t)e * p.U;
      const Unit* __restrict__ pb = ub + (size_t)e * p.U;
      unsigned u = ti;
      for (; u + te < p.U; u += 2 * te) {
        const Unit x0 = __ldg(pa + u), y0 = __ldg(pb + u);
        const Unit x1 = __ldg(pa + u + te), y1 = __ldg(pb + u + te);
        dist_unit<SSE>(x0, y0, acc);
        dist_unit<SSE>(x1, y1, acc);
      }
      if (u < p.U) dist_unit<SSE>(__ldg(pa + u), __ldg(pb + u), acc);
    }
    // the element's LPE lanes: lane ll == 0 gets their sum
    for (int o = p.LPE >> 1; o > 0; o >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, o, p.LPE);
    long long eo = e;
    if (p.WPE > 1) {
      if (lane == 0) red[warp] = acc;
      __syncthreads();
      eo = e0 + threadIdx.x;
      acc = 0;
      if ((int)threadIdx.x < groups)
        for (int i = 0; i < p.WPE; ++i) acc += red[threadIdx.x * p.WPE + i];
      __syncthreads();  // red is written again in the next step
    }
    const bool writer = p.WPE > 1 ? (int)threadIdx.x < groups : ll == 0;
    if (writer && eo < p.B) {
      if constexpr (SSE)
        ((float*)out)[eo] = (float)(long long)acc;  // round to nearest
      else
        ((int*)out)[eo] = (int)acc;                 // modulo 2^32
    }
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

// the kernel, its parameters and grid for sse (or sad) on B elements of n
// samples; vec: a and b 16-byte aligned
struct DistLaunch {
  const void* f;
  DistParams p;
  long long grid;
};

// one wave: the blocks of the kernel that fit on the card at once (the
// card's SMs times the kernel's occupancy; asked once, 0 while the query
// fails)
template <bool SSE, bool VEC>
int dist_resident_blocks() {
  static std::atomic<int> blocks{0};
  int v = blocks.load(std::memory_order_relaxed);
  if (v == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ==
            cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, dist_kernel<SSE, VEC>, kThreads, 0) == cudaSuccess)
      blocks.store(v = sms * per_sm, std::memory_order_relaxed);
  }
  return v;
}

template <bool SSE>
DistLaunch dist_plan(long long B, long long n, bool vec) {
  DistLaunch L;
  DistParams& p = L.p;
  p.B = B;
  vec = vec && n % 4 == 0;
  p.U = (unsigned)(vec ? n / 4 : n);
  // about two units a thread, up to the block's 256 threads an element
  long long te = 1;
  while (te < ((long long)p.U + 1) / 2 && te < kThreads) te *= 2;
  p.LPE = te < 32 ? (int)te : 32;
  p.WPE = te < 32 ? 1 : (int)te / 32;
  const long long epb = (long long)(kThreads / 32 / p.WPE) * (32 / p.LPE);
  L.f = vec ? (const void*)dist_kernel<SSE, true>
            : (const void*)dist_kernel<SSE, false>;
  const long long wave = vec ? dist_resident_blocks<SSE, true>()
                             : dist_resident_blocks<SSE, false>();
  L.grid = (B + epb - 1) / epb;
  if (L.grid > wave) L.grid = wave;
  return L;
}

int dist_launch(const DistLaunch& L, const void* a, const void* b, void* out,
                void* stream) {
  if (L.grid <= 0) {  // the occupancy query failed
    const cudaError_t e = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
  }
  void* args[] = {(void*)&a, (void*)&b, (void*)&out, (void*)&L.p};
  const cudaError_t e =
      cudaLaunchKernel(L.f, dim3((unsigned)L.grid), dim3(kThreads), args, 0,
                       (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

bool aligned16(const void* a, const void* b) {
  return (((uintptr_t)a | (uintptr_t)b) & 15) == 0;
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

// a, b [B, H, W] int32 -> out [B] float32 (every element written once).
// Returns cudaGetLastError() after the launch on `stream`.
extern "C" int vt_sse_batch(const void* a, const void* b, void* out,
                            long long B, int H, int W, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (!shape_ok(B, H, W)) return (int)cudaErrorInvalidValue;
  return dist_launch(dist_plan<true>(B, (long long)H * W, aligned16(a, b)),
                     a, b, out, stream);
}

// a, b [B, H, W] int32 -> out [B] int32 (every element written once).
extern "C" int vt_sad_batch(const void* a, const void* b, void* out,
                            long long B, int H, int W, void* stream) {
  cudaGetLastError();
  if (!shape_ok(B, H, W)) return (int)cudaErrorInvalidValue;
  return dist_launch(dist_plan<false>(B, (long long)H * W, aligned16(a, b)),
                     a, b, out, stream);
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

// the resources of sse's (sse != 0) or sad's kernel for a large batch of
// H x W elements on aligned inputs, in vt_dist_batch_attrs' order.
extern "C" int vt_sse_sad_attrs(int sse, int H, int W, int* out) {
  if (!shape_ok(1, H, W)) return (int)cudaErrorInvalidValue;
  const long long n = (long long)H * W;
  const DistLaunch L = sse ? dist_plan<true>(1LL << 30, n, true)
                           : dist_plan<false>(1LL << 30, n, true);
  cudaFuncAttributes at;
  cudaError_t e = cudaFuncGetAttributes(&at, L.f);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, L.f, kThreads,
                                                    0);
  if (e != cudaSuccess) return (int)e;
  out[0] = at.numRegs;
  out[1] = (int)at.sharedSizeBytes;
  out[2] = 0;
  out[3] = kThreads;
  out[4] = blocks;
  out[5] = (int)at.localSizeBytes;
  return 0;
}

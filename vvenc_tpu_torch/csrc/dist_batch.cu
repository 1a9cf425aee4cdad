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
// 2^32); the per-tile values are summed with integer adds and atomics,
// whose order does not matter modulo 2^32.
//
// Bound: bytes.  Each input sample is read once (8 bytes for the pair)
// against a handful of integer operations (SATD: 2 log2(tile) butterfly
// adds and an abs-sum per sample).  Design: sse and sad run one thread
// block per batch element, its threads striding over the samples and
// reducing by warp shuffles.  satd up to tile 8 runs one thread per tile
// with the tile in registers, consecutive threads on consecutive tiles of
// one element; the tiles of one element are reduced by shuffles within
// their segment of the warp (or the warp, when an element has more than
// 32 tiles) and added into the element's sum with one atomic per
// segment.  Tiles 16..64 stage one tile per thread block in shared memory
// and run one butterfly row, then one column, per thread.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// tiles of up to 8 x 8: one thread per (element, tile), the element's
// ntiles tiles on consecutive threads
template <int T>
__global__ void __launch_bounds__(kThreads) satd_small_kernel(
    const int* __restrict__ a, const int* __restrict__ b,
    unsigned* __restrict__ out, long long ntasks, int ntiles, int ntx, int W,
    int HW) {
  const long long task = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long e = task / ntiles;
  unsigned val = 0;
  if (task < ntasks) {
    const int tile = (int)(task - e * ntiles);
    const int y0 = (tile / ntx) * T, x0 = (tile % ntx) * T;
    const size_t off = (size_t)e * HW + (size_t)y0 * W + x0;
    unsigned d[T * T];
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int j = 0; j < T; ++j)
        d[i * T + j] = (unsigned)__ldg(a + off + i * W + j) -
                       (unsigned)__ldg(b + off + i * W + j);
#pragma unroll
    for (int i = 0; i < T; ++i) wht<T>(d + i * T, 1);  // rows: D H
#pragma unroll
    for (int j = 0; j < T; ++j) wht<T>(d + j, T);      // columns: H (D H)
    unsigned s = 0;
#pragma unroll
    for (int i = 0; i < T * T; ++i) s += uabs(d[i]);
    val = tile_value(T, s, uabs(d[0]));
  }
  // reduce within the element's segment of the warp: ntiles lanes, or the
  // whole warp when the element spans several warps; when ntiles is not a
  // power of two every tile is added on its own
  const int seg = (ntiles & (ntiles - 1)) ? 1 : (ntiles < 32 ? ntiles : 32);
  for (int o = seg >> 1; o > 0; o >>= 1)
    val += __shfl_down_sync(0xffffffffu, val, o, seg);
  if (task < ntasks && (threadIdx.x & (seg - 1)) == 0) atomicAdd(out + e, val);
}

// tiles of 16 .. 64: one thread block per (element, tile), the tile in
// shared memory (rows padded by one against bank conflicts)
template <int T>
__global__ void __launch_bounds__(64) satd_large_kernel(
    const int* __restrict__ a, const int* __restrict__ b,
    unsigned* __restrict__ out, int ntiles, int ntx, int W, int HW) {
  __shared__ unsigned t[T * (T + 1)];
  __shared__ unsigned red[2];
  const long long e = blockIdx.x / ntiles;
  const int tile = blockIdx.x - (int)(e * ntiles);
  const int y0 = (tile / ntx) * T, x0 = (tile % ntx) * T;
  const size_t off = (size_t)e * HW + (size_t)y0 * W + x0;
  for (int k = threadIdx.x; k < T * T; k += blockDim.x) {
    const int i = k / T, j = k % T;
    t[i * (T + 1) + j] =
        (unsigned)__ldg(a + off + i * W + j) - (unsigned)__ldg(b + off + i * W + j);
  }
  __syncthreads();
  unsigned v[T];
  if (threadIdx.x < T) {  // row r: D H
    unsigned* row = t + threadIdx.x * (T + 1);
#pragma unroll
    for (int j = 0; j < T; ++j) v[j] = row[j];
    wht<T>(v, 1);
#pragma unroll
    for (int j = 0; j < T; ++j) row[j] = v[j];
  }
  __syncthreads();
  unsigned s = 0, dc = 0;
  if (threadIdx.x < T) {  // column c: H (D H)
#pragma unroll
    for (int i = 0; i < T; ++i) v[i] = t[i * (T + 1) + threadIdx.x];
    wht<T>(v, 1);
#pragma unroll
    for (int i = 0; i < T; ++i) s += uabs(v[i]);
    dc = uabs(v[0]);
  }
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned tot = red[0] + red[1];
    atomicAdd(out + e, tile_value(T, tot, dc));
  }
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

// a, b [B, H, W] int32 -> out [B] int32, which must hold zeros (the
// tiles are added into it); tile a power of two <= 64 dividing H and W.
extern "C" int vt_satd_batch(const void* a, const void* b, void* out,
                             long long B, int H, int W, int tile,
                             void* stream) {
  cudaGetLastError();
  if (!shape_ok(B, H, W) || tile < 1 || tile > 64 || (tile & (tile - 1)) ||
      H % tile || W % tile)
    return (int)cudaErrorInvalidValue;
  const int ntx = W / tile, ntiles = ntx * (H / tile);
  const int* pa = (const int*)a;
  const int* pb = (const int*)b;
  unsigned* po = (unsigned*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (tile <= 8) {
    const long long ntasks = B * ntiles;
    const unsigned grid = (unsigned)((ntasks + kThreads - 1) / kThreads);
    switch (tile) {
      case 1: satd_small_kernel<1><<<grid, kThreads, 0, st>>>(pa, pb, po, ntasks, ntiles, ntx, W, H * W); break;
      case 2: satd_small_kernel<2><<<grid, kThreads, 0, st>>>(pa, pb, po, ntasks, ntiles, ntx, W, H * W); break;
      case 4: satd_small_kernel<4><<<grid, kThreads, 0, st>>>(pa, pb, po, ntasks, ntiles, ntx, W, H * W); break;
      default: satd_small_kernel<8><<<grid, kThreads, 0, st>>>(pa, pb, po, ntasks, ntiles, ntx, W, H * W); break;
    }
  } else {
    const long long nblocks = B * ntiles;
    if (nblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    switch (tile) {
      case 16: satd_large_kernel<16><<<(unsigned)nblocks, 64, 0, st>>>(pa, pb, po, ntiles, ntx, W, H * W); break;
      case 32: satd_large_kernel<32><<<(unsigned)nblocks, 64, 0, st>>>(pa, pb, po, ntiles, ntx, W, H * W); break;
      default: satd_large_kernel<64><<<(unsigned)nblocks, 64, 0, st>>>(pa, pb, po, ntiles, ntx, W, H * W); break;
    }
  }
  return (int)cudaGetLastError();
}

// K6 transform_batch: forward and inverse 2-D DCT-2 of a batch of blocks
// [B, h, w] int32, w, h in {4, 8, 16, 32, 64}.
//
// Replaces vvenc_tpu/ops/transforms.py:496 fwd_transform_batch and :524
// inv_transform_batch, XLA programs on the TPU (two int32 matrix products
// on the MXU per block, each followed by a rounding shift and a clip to
// [-32768, 32767]; the forward one zeroes everything outside the top-left
// 32x32 of a 64-point block).
//
//   forward: tmp = clip((resi . Tw^T + 2^(s1-1)) >> s1),
//            out = clip((Th . tmp + 2^(s2-1)) >> s2),
//            s1 = log2w + bd + 6 - 15, s2 = log2h + 6
//   inverse: tmp = clip((Th^T . coeff + 64) >> 7),
//            out = clip((tmp . Tw + 2^(s2-1)) >> s2), s2 = 20 - bd
//
// Exact: every product and sum is the reference's int32, taken here in
// unsigned arithmetic (so that an input past the reference's bounds wraps
// as XLA's int32 does instead of being undefined), and >> on the signed
// result is arithmetic, as in XLA.
//
// Bound: bytes for the small classes, operations for the large ones
// (2 (w + h) multiply-adds per sample against 8 bytes moved).  Design: a
// thread block takes G = max(1, 4096 / (w h)) blocks, stages them in
// shared memory, runs the first stage into a second shared buffer and
// the second stage out to device memory; each thread computes whole
// output samples, the output index fastest across the threads, so that
// the matrix rows a warp reads are shared or contiguous (the forward
// pass reads Tw transposed for that).  The DCT-2 matrices are the port's
// tr_matrix (ops/tables.device_tables), read through the read-only cache.
// No tensor cores yet: the second stage's 16-bit operands are not exact
// in FP16 (ROADMAP.md, "How a part is tested").
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSamples = 4096;  // G * h * w per thread block
constexpr int kCoeffMin = -32768, kCoeffMax = 32767;

__device__ __forceinline__ int clip16(int v) {
  return v < kCoeffMin ? kCoeffMin : (v > kCoeffMax ? kCoeffMax : v);
}

// (acc + (1 << (shift - 1))) >> shift on the reference's int32
__device__ __forceinline__ int round_shift(unsigned acc, int shift) {
  return (int)(acc + (1u << (shift - 1))) >> shift;
}

// stages the n live samples of this thread block's G blocks
__device__ __forceinline__ void stage(const int* __restrict__ src, int* dst,
                                      int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads) fwd_kernel(
    const int* __restrict__ in, int* __restrict__ out, long long B, int G,
    int w, int h, int shift1, int shift2, const int* __restrict__ twT,
    const int* __restrict__ th) {
  extern __shared__ int smem[];
  const int hw = w * h;
  int* s_in = smem;            // [G][h][w]
  int* s_tmp = smem + G * hw;  // [G][h][w]: tmp[y][u]
  const long long b0 = (long long)blockIdx.x * G;
  const int n = (int)min((long long)G, B - b0) * hw;
  stage(in + b0 * hw, s_in, n);
  __syncthreads();
  // tmp[y][u] = sum_x in[y][x] * Tw[u][x]   (twT[x][u] = Tw[u][x])
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int g = i / hw, r = i - g * hw, y = r / w, u = r - y * w;
    const int* row = s_in + g * hw + y * w;
    unsigned acc = 0;
    for (int x = 0; x < w; ++x)
      acc += (unsigned)row[x] * (unsigned)__ldg(twT + x * w + u);
    s_tmp[i] = clip16(round_shift(acc, shift1));
  }
  __syncthreads();
  // out[v][u] = sum_y Th[v][y] * tmp[y][u]; 64-point zero-out
  const bool zero_out = w > 32 || h > 32;
  int* dst = out + b0 * hw;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int g = i / hw, r = i - g * hw, v = r / w, u = r - v * w;
    int val = 0;
    if (!zero_out || (u < 32 && v < 32)) {
      const int* col = s_tmp + g * hw + u;
      unsigned acc = 0;
      for (int y = 0; y < h; ++y)
        acc += (unsigned)__ldg(th + v * h + y) * (unsigned)col[y * w];
      val = clip16(round_shift(acc, shift2));
    }
    dst[i] = val;
  }
}

__global__ void __launch_bounds__(kThreads) inv_kernel(
    const int* __restrict__ in, int* __restrict__ out, long long B, int G,
    int w, int h, int shift2, const int* __restrict__ th,
    const int* __restrict__ tw) {
  extern __shared__ int smem[];
  const int hw = w * h;
  int* s_in = smem;            // [G][h][w]: coeff[v][u]
  int* s_tmp = smem + G * hw;  // [G][h][w]: tmp[y][u]
  const long long b0 = (long long)blockIdx.x * G;
  const int n = (int)min((long long)G, B - b0) * hw;
  stage(in + b0 * hw, s_in, n);
  __syncthreads();
  // tmp[y][u] = sum_v Th[v][y] * coeff[v][u]
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int g = i / hw, r = i - g * hw, y = r / w, u = r - y * w;
    const int* col = s_in + g * hw + u;
    unsigned acc = 0;
    for (int v = 0; v < h; ++v)
      acc += (unsigned)__ldg(th + v * h + y) * (unsigned)col[v * w];
    s_tmp[i] = clip16(round_shift(acc, 7));
  }
  __syncthreads();
  // out[y][x] = sum_u tmp[y][u] * Tw[u][x]
  int* dst = out + b0 * hw;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int g = i / hw, r = i - g * hw, y = r / w, x = r - y * w;
    const int* row = s_tmp + g * hw + y * w;
    unsigned acc = 0;
    for (int u = 0; u < w; ++u)
      acc += (unsigned)row[u] * (unsigned)__ldg(tw + u * w + x);
    dst[i] = clip16(round_shift(acc, shift2));
  }
}

bool valid_side(int n) { return n >= 4 && n <= 64 && (n & (n - 1)) == 0; }

// blocks per thread block
int blocks_per_cta(int w, int h) {
  return w * h >= kSamples ? 1 : kSamples / (w * h);
}

}  // namespace

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// in/out [B, h, w] int32 (contiguous, distinct), twT = DCT-2(w)^T and
// th = DCT-2(h) as [n, n] int32.  Returns cudaGetLastError() after the
// launch on `stream`.
extern "C" int vt_fwd_transform_batch(const void* in, void* out, long long B,
                                      int w, int h, int shift1, int shift2,
                                      const void* twT, const void* th,
                                      void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (!valid_side(w) || !valid_side(h) || B <= 0 || shift1 < 1 || shift2 < 1)
    return (int)cudaErrorInvalidValue;
  const int G = blocks_per_cta(w, h);
  const unsigned grid = (unsigned)((B + G - 1) / G);
  const size_t shm = 2 * (size_t)G * w * h * sizeof(int);
  fwd_kernel<<<grid, kThreads, shm, (cudaStream_t)stream>>>(
      (const int*)in, (int*)out, B, G, w, h, shift1, shift2,
      (const int*)twT, (const int*)th);
  return (int)cudaGetLastError();
}

// in/out [B, h, w] int32 (contiguous, distinct), th = DCT-2(h) and
// tw = DCT-2(w) as [n, n] int32; the first stage shifts by 7.
extern "C" int vt_inv_transform_batch(const void* in, void* out, long long B,
                                      int w, int h, int shift2,
                                      const void* th, const void* tw,
                                      void* stream) {
  cudaGetLastError();
  if (!valid_side(w) || !valid_side(h) || B <= 0 || shift2 < 1)
    return (int)cudaErrorInvalidValue;
  const int G = blocks_per_cta(w, h);
  const unsigned grid = (unsigned)((B + G - 1) / G);
  const size_t shm = 2 * (size_t)G * w * h * sizeof(int);
  inv_kernel<<<grid, kThreads, shm, (cudaStream_t)stream>>>(
      (const int*)in, (int*)out, B, G, w, h, shift2, (const int*)th,
      (const int*)tw);
  return (int)cudaGetLastError();
}

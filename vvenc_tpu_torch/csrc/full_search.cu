// K9 full_search_sse: the SSE of each block at every integer displacement
// inside its search area.
//
// Replaces vvenc_tpu/ops/me.py:38 full_search_sse_batch, an XLA program on
// the TPU that computed sum(a^2) + sum(b^2) - 2 corr(a, b) in float32, the
// correlation as a batch-grouped convolution on the matrix unit.  That
// form cancels: at 10 bits its costs are off the exact SSE by up to about
// a hundred (ROADMAP.md section 3).  Here every displacement's SSE is the
// exact integer sum of (area - block)^2, accumulated in 64 bits (a 64x64
// block of 10-bit differences reaches 4.29e9), and written as its float32
// (rounded once, to nearest).  blocks [B, h, w], areas [B, ah, aw] int32
// -> costs [B, ah - h + 1, aw - w + 1] float32.
//
// Bound: operations.  Each of the (2R + 1)^2 displacements of each block
// costs h * w subtract-multiply-adds (2.24 G for the 8,040 16x16 blocks of
// a 1080p picture at R = 16) against the inputs read once.  Design: one
// thread block per block b; the block and its area are staged in shared
// memory, and each thread takes displacements in a stride of the thread
// count, neighbouring threads on neighbouring displacements of a row, so
// that a warp's reads of the area fall on consecutive banks and its reads
// of the block are broadcasts.  No product or convolution library is
// involved (cuDNN would round the products to TF32).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) full_search_kernel(
    const int* __restrict__ blocks, const int* __restrict__ areas,
    float* __restrict__ costs, int h, int w, int ah, int aw) {
  extern __shared__ int sm[];
  int* area = sm;            // [ah, aw]
  int* blk = sm + ah * aw;   // [h, w]
  const size_t b = blockIdx.x;
  const int na = ah * aw, nb = h * w;
  for (int k = threadIdx.x; k < na; k += blockDim.x)
    area[k] = __ldg(areas + b * na + k);
  for (int k = threadIdx.x; k < nb; k += blockDim.x)
    blk[k] = __ldg(blocks + b * nb + k);
  __syncthreads();
  const int gh = ah - h + 1, gw = aw - w + 1;
  for (int c = threadIdx.x; c < gh * gw; c += blockDim.x) {
    const int oy = c / gw, ox = c - (c / gw) * gw;
    long long s = 0;
    for (int i = 0; i < h; ++i) {
      const int* ar = area + (oy + i) * aw + ox;
      const int* br = blk + i * w;
      for (int j = 0; j < w; ++j) {
        const long long d = (long long)ar[j] - br[j];
        s += d * d;
      }
    }
    costs[b * gh * gw + c] = (float)s;
  }
}

}  // namespace

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// blocks [B, h, w], areas [B, ah, aw] int32 (ah >= h, aw >= w) -> costs
// [B, ah - h + 1, aw - w + 1] float32; block and area together must fit
// the 227 KB of shared memory a thread block can use.  Returns
// cudaGetLastError() after the launch on `stream`.
extern "C" int vt_full_search_sse(const void* blocks, const void* areas,
                                  void* costs, long long B, int h, int w,
                                  int ah, int aw, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (B <= 0 || B > 0x7fffffffLL || h <= 0 || w <= 0 || ah < h || aw < w)
    return (int)cudaErrorInvalidValue;
  const size_t shm = ((size_t)ah * aw + (size_t)h * w) * sizeof(int);
  if (shm > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (shm > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        full_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (e != cudaSuccess) return (int)e;
  }
  full_search_kernel<<<(unsigned)B, kThreads, shm, (cudaStream_t)stream>>>(
      (const int*)blocks, (const int*)areas, (float*)costs, h, w, ah, aw);
  return (int)cudaGetLastError();
}

// K7 quant_batch: scalar quantisation and dequantisation of a batch of
// transform blocks, elementwise over [B, h, w] int32.
//
// Replaces vvenc_tpu/ops/transforms.py:542 quant_batch and :565
// dequant_batch, XLA programs on the TPU:
//
//   quant:   q = sign(c) * ((|c| * scale + add) >> qbits),
//            add = 171 << (qbits - 9) on intra slices, 85 << (qbits - 9)
//            otherwise (the wrapper passes scale, add and qbits)
//   dequant: q = clip(c, -32768, 32767);
//            d = (q * scale + 2^(rs-1)) >> rs      if rs > 0
//            d = (q * scale) << -rs                otherwise
//            out = clip(d, -32768, 32767), rs = 6 - (tshift + qp / 6)
//
// Exact: the arithmetic is the reference's int32, taken in unsigned
// arithmetic so that it wraps as XLA's does (|INT_MIN| stays INT_MIN)
// instead of being undefined; >> on the signed result is arithmetic.
//
// Bound: bytes (8 bytes moved per sample against a handful of integer
// operations).  Design: one thread per sample in a grid-stride loop,
// neighbouring threads on neighbouring samples.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCoeffMin = -32768, kCoeffMax = 32767;

__device__ __forceinline__ int clip16(int v) {
  return v < kCoeffMin ? kCoeffMin : (v > kCoeffMax ? kCoeffMax : v);
}

__global__ void __launch_bounds__(kThreads) quant_kernel(
    const int* __restrict__ in, int* __restrict__ out, long long n, int scale,
    int add, int qbits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = in[i];
    const unsigned a = c < 0 ? 0u - (unsigned)c : (unsigned)c;
    const int mag = (int)(a * (unsigned)scale + (unsigned)add) >> qbits;
    const int sign = (c > 0) - (c < 0);
    out[i] = (int)((unsigned)sign * (unsigned)mag);
  }
}

__global__ void __launch_bounds__(kThreads) dequant_kernel(
    const int* __restrict__ in, int* __restrict__ out, long long n, int scale,
    int rshift) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const unsigned p = (unsigned)clip16(in[i]) * (unsigned)scale;
    const int d = rshift > 0
                      ? (int)(p + (1u << (rshift - 1))) >> rshift
                      : (int)(p << -rshift);
    out[i] = clip16(d);
  }
}

unsigned grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return (unsigned)(blocks < 65536 ? blocks : 65536);
}

}  // namespace

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// in/out [n] int32 (contiguous).  Returns cudaGetLastError() after the
// launch on `stream`.
extern "C" int vt_quant_batch(const void* in, void* out, long long n,
                              int scale, int add, int qbits, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (n <= 0 || qbits < 0 || qbits > 31) return (int)cudaErrorInvalidValue;
  quant_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)in, (int*)out, n, scale, add, qbits);
  return (int)cudaGetLastError();
}

extern "C" int vt_dequant_batch(const void* in, void* out, long long n,
                                int scale, int rshift, void* stream) {
  cudaGetLastError();
  if (n <= 0 || rshift > 31 || rshift < -31) return (int)cudaErrorInvalidValue;
  dequant_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)in, (int*)out, n, scale, rshift);
  return (int)cudaGetLastError();
}

// K8 mc_batch: separable H.266 motion-compensation filter of a batch of
// pre-gathered reference windows at one fractional phase.
//
// Replaces vvenc_tpu/ops/interp.py:183 mc_batch, an XLA program on the
// TPU (one program per phase and block size: shifted slices times the
// phase's taps, summed in int32).  Same arithmetic, bit for bit: windows
// [B, h + n - 1, w + n - 1] int32 (n = 8 luma taps, 4 chroma), output
// [B, h, w] int32, four cases by phase:
//   (0, 0)        the window's centre, copied without a clip;
//   frac_y == 0   rows half .. half + h filtered horizontally, as first and
//                 last stage: (acc + off1) >> sh1, clipped to the bit depth;
//   frac_x == 0   columns half .. half + w filtered vertically, first and
//                 last stage, with (sh2, off2), clipped;
//   otherwise     every window row filtered horizontally as first, not last
//                 stage (offset -8192 << sh1, no clip) into a 14-bit
//                 intermediate, then vertically as last stage (shift 6 +
//                 head room, offset with 8192 << 6), clipped.
// The wrapper computes the taps, shifts and offsets from the reference's
// own rules and passes them as arguments.  The sums are taken in unsigned
// arithmetic, so that they wrap as XLA's int32 does instead of being
// undefined; >> on the signed value is arithmetic.
//
// Bound: bytes.  A window is read once and an output written once (about
// 25 MB for every 16x16 luma block of a 1080p picture) against 2n
// multiply-adds per output sample.  Design: one thread block per window.
// In the two-stage case the block filters the window's rows into shared
// memory, synchronises, and filters the intermediate's columns; its
// threads walk the samples row by row, so neighbouring threads read
// neighbouring window samples.  The single-stage cases read the window
// straight from device memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Taps {
  int c[8];
};

struct Params {
  int w, h, kind;
  Taps tx, ty;
  int sh1, off1, sh2, off2, maxval;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// sum_k taps[k] * p[k * step], modulo 2^32
template <int N>
__device__ __forceinline__ unsigned fir(const Taps& t, const int* p, int step) {
  unsigned acc = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) acc += (unsigned)t.c[k] * (unsigned)p[k * step];
  return acc;
}

__device__ __forceinline__ int shift_off(unsigned acc, int off, int sh) {
  return (int)(acc + (unsigned)off) >> sh;
}

template <int N>
__global__ void __launch_bounds__(256) mc_kernel(const int* __restrict__ win,
                                                 int* __restrict__ out,
                                                 const Params p) {
  extern __shared__ int tmp[];  // [h + N - 1, w] (two-stage case)
  constexpr int half = N / 2 - 1;
  const int w = p.w, h = p.h;
  const int WW = w + N - 1, WH = h + N - 1;
  const int* wb = win + (size_t)blockIdx.x * WW * WH;
  int* ob = out + (size_t)blockIdx.x * w * h;
  if (p.kind == 0) {
    for (int k = threadIdx.x; k < w * h; k += blockDim.x)
      ob[k] = wb[(k / w + half) * WW + k % w + half];
  } else if (p.kind == 1) {
    for (int k = threadIdx.x; k < w * h; k += blockDim.x) {
      const int y = k / w, x = k % w;
      ob[k] = clampi(shift_off(fir<N>(p.tx, wb + (y + half) * WW + x, 1),
                               p.off1, p.sh1),
                     0, p.maxval);
    }
  } else if (p.kind == 2) {
    for (int k = threadIdx.x; k < w * h; k += blockDim.x) {
      const int y = k / w, x = k % w;
      ob[k] = clampi(shift_off(fir<N>(p.ty, wb + y * WW + x + half, WW),
                               p.off2, p.sh2),
                     0, p.maxval);
    }
  } else {
    for (int k = threadIdx.x; k < WH * w; k += blockDim.x) {
      const int r = k / w, x = k % w;
      tmp[k] = shift_off(fir<N>(p.tx, wb + r * WW + x, 1), p.off1, p.sh1);
    }
    __syncthreads();
    for (int k = threadIdx.x; k < w * h; k += blockDim.x) {
      ob[k] = clampi(shift_off(fir<N>(p.ty, tmp + k, w), p.off2, p.sh2), 0,
                     p.maxval);
    }
  }
}

template <int N>
int launch(const int* win, int* out, long long B, const Params& p,
           cudaStream_t st) {
  const size_t shm = p.kind == 3 ? (size_t)(p.h + N - 1) * p.w * sizeof(int) : 0;
  if (shm > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mc_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = p.w * p.h >= 256 ? 256 : ((p.w * p.h + 31) / 32) * 32;
  mc_kernel<N><<<(unsigned)B, threads, shm, st>>>(win, out, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// windows [B, h + ntaps - 1, w + ntaps - 1] int32 -> out [B, h, w] int32;
// ntaps 8 or 4 (taps beyond ntaps are ignored); kind 0 copy, 1 horizontal
// only (tx, sh1, off1), 2 vertical only (ty, sh2, off2), 3 both.  Returns
// cudaGetLastError() after the launch on `stream`.
extern "C" int vt_mc_batch(const void* windows, void* out, long long B, int w,
                           int h, int ntaps, int kind, int tx0, int tx1,
                           int tx2, int tx3, int tx4, int tx5, int tx6,
                           int tx7, int ty0, int ty1, int ty2, int ty3,
                           int ty4, int ty5, int ty6, int ty7, int sh1,
                           int off1, int sh2, int off2, int maxval,
                           void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (B <= 0 || B > 0x7fffffffLL || w <= 0 || h <= 0 || kind < 0 ||
      kind > 3 || (ntaps != 8 && ntaps != 4) || sh1 < 0 || sh1 > 31 ||
      sh2 < 0 || sh2 > 31)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.w = w;
  p.h = h;
  p.kind = kind;
  const int tx[8] = {tx0, tx1, tx2, tx3, tx4, tx5, tx6, tx7};
  const int ty[8] = {ty0, ty1, ty2, ty3, ty4, ty5, ty6, ty7};
  for (int k = 0; k < 8; ++k) {
    p.tx.c[k] = tx[k];
    p.ty.c[k] = ty[k];
  }
  p.sh1 = sh1;
  p.off1 = off1;
  p.sh2 = sh2;
  p.off2 = off2;
  p.maxval = maxval;
  cudaStream_t st = (cudaStream_t)stream;
  return ntaps == 8 ? launch<8>((const int*)windows, (int*)out, B, p, st)
                    : launch<4>((const int*)windows, (int*)out, B, p, st);
}

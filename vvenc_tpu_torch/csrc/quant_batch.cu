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
// operations; the 1080p 16x16 grid's 2.06 M samples are 16.5 MB, 4.9 us
// at 3.35 TB/s).  The first kernel ran a thread a sample on 4-byte loads
// in 8,040 blocks at that grid (7.6 waves), 2.0x its bound cold.  Design:
// - a thread takes 16-byte vectors (4 samples) i and i + S of the
//   tensor, S the grid's threads, both loads issued before any
//   arithmetic, and stores 16-byte vectors; neighbouring threads on
//   neighbouring vectors;
// - one wave of blocks (the resident blocks of the card), about two
//   vectors a thread, looping when the tensor is larger;
// - the n % 4 samples past the last vector are a scalar tail on the
//   first threads;
// - an input or output off 16-byte alignment (a view) takes 4-byte loads
//   and stores through the same kernel, two samples a step.
// tests/test_torch_k7k10_models.py holds the index map (every sample
// once, n a multiple of 4 or not).
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kCoeffMin = -32768, kCoeffMax = 32767;

__device__ __forceinline__ int clip16(int v) {
  return v < kCoeffMin ? kCoeffMin : (v > kCoeffMax ? kCoeffMax : v);
}

struct Quant {
  int scale, add, qbits;
  __device__ __forceinline__ int operator()(int c) const {
    const unsigned a = c < 0 ? 0u - (unsigned)c : (unsigned)c;
    const int mag = (int)(a * (unsigned)scale + (unsigned)add) >> qbits;
    const int sign = (c > 0) - (c < 0);
    return (int)((unsigned)sign * (unsigned)mag);
  }
};

struct Dequant {
  int scale, rshift;
  __device__ __forceinline__ int operator()(int c) const {
    const unsigned p = (unsigned)clip16(c) * (unsigned)scale;
    const int d = rshift > 0 ? (int)(p + (1u << (rshift - 1))) >> rshift
                             : (int)(p << -rshift);
    return clip16(d);
  }
};

template <class Op>
__device__ __forceinline__ int4 apply(const Op& op, int4 v) {
  return make_int4(op(v.x), op(v.y), op(v.z), op(v.w));
}

template <class Op>
__device__ __forceinline__ int apply(const Op& op, int v) {
  return op(v);
}

// units of the tensor (16-byte vectors when VEC, else samples): thread t
// of the grid's S takes units t, t + S, t + 2 S, ... two at a time, both
// loads before the arithmetic; with VEC the first n % 4 threads then take
// the samples past the last vector
template <class Op, bool VEC>
__global__ void __launch_bounds__(kThreads) k7_kernel(
    const int* __restrict__ in, int* __restrict__ out, long long n,
    const Op op) {
  using Unit = typename std::conditional<VEC, int4, int>::type;
  const Unit* __restrict__ uin = reinterpret_cast<const Unit*>(in);
  Unit* __restrict__ uout = reinterpret_cast<Unit*>(out);
  const long long units = VEC ? n / 4 : n;
  const long long S = (long long)gridDim.x * kThreads;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long i = t;
  for (; i + S < units; i += 2 * S) {
    const Unit x0 = __ldg(uin + i), x1 = __ldg(uin + i + S);
    uout[i] = apply(op, x0);
    uout[i + S] = apply(op, x1);
  }
  if (i < units) uout[i] = apply(op, __ldg(uin + i));
  if constexpr (VEC)
    if (t < n - 4 * units) out[4 * units + t] = op(__ldg(in + 4 * units + t));
}

// one wave: the blocks of the kernel that fit on the card at once (the
// card's SMs times the kernel's occupancy; asked once, 0 while the query
// fails)
template <class Op, bool VEC>
int resident_blocks() {
  static std::atomic<int> blocks{0};
  int v = blocks.load(std::memory_order_relaxed);
  if (v == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ==
            cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, k7_kernel<Op, VEC>, kThreads, 0) == cudaSuccess)
      blocks.store(v = sms * per_sm, std::memory_order_relaxed);
  }
  return v;
}

// the grid for n samples: about two units a thread, at most one wave
template <class Op, bool VEC>
long long grid_for(long long n) {
  const long long units = VEC ? n / 4 : n;
  long long g = (units + 2 * kThreads - 1) / (2 * kThreads);
  if (g < 1) g = 1;
  const long long wave = resident_blocks<Op, VEC>();
  return g < wave ? g : wave;
}

template <class Op>
int launch(const void* in, void* out, long long n, const Op& op,
           void* stream) {
  const bool vec = (((uintptr_t)in | (uintptr_t)out) & 15) == 0;
  const long long grid = vec ? grid_for<Op, true>(n) : grid_for<Op, false>(n);
  if (grid <= 0) {  // the occupancy query failed
    const cudaError_t e = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
  }
  if (vec)
    k7_kernel<Op, true><<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)in, (int*)out, n, op);
  else
    k7_kernel<Op, false><<<(unsigned)grid, kThreads, 0,
                           (cudaStream_t)stream>>>((const int*)in, (int*)out,
                                                   n, op);
  return (int)cudaGetLastError();
}

template <class Op>
int attrs(bool vec, int* out) {
  const void* f = vec ? (const void*)k7_kernel<Op, true>
                      : (const void*)k7_kernel<Op, false>;
  cudaFuncAttributes at;
  cudaError_t e = cudaFuncGetAttributes(&at, f);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  out[0] = at.numRegs;
  out[1] = (int)at.sharedSizeBytes;
  out[2] = 0;
  out[3] = kThreads;
  out[4] = blocks;
  out[5] = (int)at.localSizeBytes;
  return 0;
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
  return launch(in, out, n, Quant{scale, add, qbits}, stream);
}

extern "C" int vt_dequant_batch(const void* in, void* out, long long n,
                                int scale, int rshift, void* stream) {
  cudaGetLastError();
  if (n <= 0 || rshift > 31 || rshift < -31) return (int)cudaErrorInvalidValue;
  return launch(in, out, n, Dequant{scale, rshift}, stream);
}

// the resources of quant's (dequant == 0) or dequant's kernel on aligned
// (vec != 0) or unaligned tensors: out = registers per thread, static and
// dynamic shared memory bytes, threads per block, resident blocks per SM,
// local memory bytes per thread.
extern "C" int vt_quant_batch_attrs(int dequant, int vec, int* out) {
  return dequant ? attrs<Dequant>(vec != 0, out) : attrs<Quant>(vec != 0, out);
}

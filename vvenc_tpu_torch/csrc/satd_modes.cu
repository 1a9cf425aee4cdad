// K2 satd_modes: vvenc-convention SATD of each source block against each
// of its M predictions.
//
// Replaces vvenc_tpu/ops/intra_presel.py:176 satd_batch, an XLA program on
// the TPU that ran the Hadamard transforms as float32 matmuls (exact, all
// intermediates < 2^24).  Here the transform is integer Walsh-Hadamard
// butterflies in int32, which is exact too, so the two agree bit for bit:
// per 8x8 tile (4x4 when w or h is not a multiple of 8) T = H D H of the
// difference D = int16(src) - pred, then sum|T| with (s + 2) >> 2 (8x8) or
// the 4x4 DC correction ((s - |T00| + (|T00| >> 2)) + 1) >> 1, summed over
// the block's tiles.
//
// Bound: bytes.  Every int16 prediction sample is read once (2 bytes); the
// 1080p 16x16 class (8,040 blocks, 67 modes, 286 MB) takes 0.085 ms at
// 3.35 TB/s.  Its integer work is about 9 operations a sample, which on
// Hopper's 64 int32 lanes an SM is about the same time: the kernel has to
// spend nothing beyond the transform.
//
// Design (the first kernel loaded a tile's 64 samples one at a time with
// lanes 16 bytes apart, read the int32 source again through the read-only
// cache for each of the M modes, divided in 64 bits per thread and summed
// a block's tiles in a serial loop of thread 0):
// - a thread takes one tile of one (block, mode) prediction and reads its
//   rows as 16-byte vectors (8 bytes at 4x4 tiles), all T loads issued
//   before the first use; consecutive lanes take consecutive tiles of one
//   prediction, then the next prediction's, which is contiguous;
// - a work item is a range of (block, mode) predictions; its thread block
//   stages the source blocks the range covers once, in shared memory, as
//   one word a sample that makes the int16 wrap of int16(src) - pred one
//   subtraction and one sign extension (even samples: the value, read by
//   its low half; odd samples: value << 16 | 0xFFFF, whose high half
//   minus the packed pair cannot borrow);
// - both butterfly passes run in the thread's registers; the last column
//   stage is fused with the absolute sum (|a + c| + |a - c| =
//   2 max(|a|, |c|)), the DC term kept for the 4x4 correction;
// - the tiles of one prediction are consecutive lanes (up to 32; a lane
//   takes several tiles past 32) and are summed by xor shuffles;
// - 16 resident warps an SM keep 64 KB of predictions in flight, which
//   covers the memory latency without a copy pipeline.
// A tensor that is not 16-byte aligned (8 at 4x4 tiles) takes 2-byte
// loads.  tests/test_torch_k12_models.py holds the word trick and the
// fused last stage against the reference.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSrcBytes = 40 * 1024;   // staged source words of one item
constexpr int kMaxPasses = 8;          // task passes of one item

// rows of a tile: T int16 values packed in T / 2 words each
template <int T, bool ALIGNED>
__device__ __forceinline__ void load_rows(const int16_t* p, int w,
                                          uint32_t (&x)[T][T / 2]) {
#pragma unroll
  for (int i = 0; i < T; ++i) {
    if constexpr (!ALIGNED) {
#pragma unroll
      for (int q = 0; q < T / 2; ++q)
        x[i][q] = (uint32_t)(uint16_t)__ldg(p + i * w + 2 * q) |
                  ((uint32_t)(uint16_t)__ldg(p + i * w + 2 * q + 1) << 16);
    } else if constexpr (T == 8) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + i * w));
      x[i][0] = v.x;
      x[i][1] = v.y;
      x[i][2] = v.z;
      x[i][3] = v.w;
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p + i * w));
      x[i][0] = v.x;
      x[i][1] = v.y;
    }
  }
}

// natural-order (Sylvester) butterflies of v[0], v[stride], ... with
// half-lengths from `lo` up to (excluding) `hi`
template <int T, int LO, int HI>
__device__ __forceinline__ void wht(int* v, int stride) {
#pragma unroll
  for (int len = LO; len < HI; len <<= 1)
#pragma unroll
    for (int i = 0; i < T; i += 2 * len)
#pragma unroll
      for (int j = i; j < i + len; ++j) {
        const int a = v[j * stride], c = v[(j + len) * stride];
        v[j * stride] = a + c;
        v[(j + len) * stride] = a - c;
      }
}

// the SATD value of one tile: x its prediction rows, sp its staged source
// words (row stride w)
template <int T>
__device__ __forceinline__ int tile_satd(const uint32_t (&x)[T][T / 2],
                                         const uint32_t* sp, int w) {
  int v[T][T];
#pragma unroll
  for (int i = 0; i < T; ++i) {
    uint32_t sw[T];
#pragma unroll
    for (int q = 0; q < T / 4; ++q) {
      const uint4 u = *reinterpret_cast<const uint4*>(sp + i * w + 4 * q);
      sw[4 * q] = u.x;
      sw[4 * q + 1] = u.y;
      sw[4 * q + 2] = u.z;
      sw[4 * q + 3] = u.w;
    }
#pragma unroll
    for (int q = 0; q < T / 2; ++q) {
      v[i][2 * q] = (int)(int16_t)(sw[2 * q] - x[i][q]);
      v[i][2 * q + 1] = (int)(sw[2 * q + 1] - x[i][q]) >> 16;
    }
    wht<T, 1, T>(v[i], 1);                        // rows: D H
  }
#pragma unroll
  for (int c = 0; c < T; ++c) wht<T, 1, T / 2>(&v[0][c], T);  // columns
  // the last column stage with the absolute sum
  int s2 = 0;
#pragma unroll
  for (int j = 0; j < T / 2; ++j)
#pragma unroll
    for (int c = 0; c < T; ++c)
      s2 += max(abs(v[j][c]), abs(v[j + T / 2][c]));
  const int s = 2 * s2;
  if constexpr (T == 8) {
    return (s + 2) >> 2;
  } else {
    const int dc = abs(v[0][0] + v[T / 2][0]);
    return ((s - dc + (dc >> 2)) + 1) >> 1;
  }
}

// the launch shape of one call
struct Shape {
  int lg_w, lg_ntx, lg_lpg, tpl, gpi;
};

template <int T, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, 2) satd_modes_kernel(
    const int* __restrict__ src, const int16_t* __restrict__ preds,
    int* __restrict__ out, long long N, int M, int h, const Shape sh) {
  extern __shared__ uint32_t words[];
  const int tid = threadIdx.x;
  const int w = 1 << sh.lg_w, hw = w * h;
  const long long g0 = (long long)blockIdx.x * sh.gpi;
  const int ng = (int)min((long long)sh.gpi, N - g0);
  const long long b_lo = g0 / M;
  const int m_off = (int)(g0 - b_lo * M);   // g0's mode
  const int nb = (m_off + ng - 1) / M + 1;  // source blocks of the item
  const int* sb = src + b_lo * hw;
  for (int k = tid; k < nb * hw; k += kThreads) {
    const uint32_t v = (uint32_t)__ldg(sb + k);
    words[k] = (k & 1) ? (v << 16) | 0xFFFFu : v;
  }
  __syncthreads();
  const int lpg = 1 << sh.lg_lpg;
  const int ntasks = ng << sh.lg_lpg;
  for (int t0 = 0; t0 < ntasks; t0 += kThreads) {
    const int t = t0 + tid;
    int acc = 0;
    if (t < ntasks) {
      const int gl = t >> sh.lg_lpg;
      const int bl = (m_off + gl) / M;
      const int16_t* pg = preds + (g0 + gl) * hw;
      const uint32_t* sg = words + bl * hw;
      for (int u = 0; u < sh.tpl; ++u) {
        const int tile = (t & (lpg - 1)) * sh.tpl + u;
        const int ty = tile >> sh.lg_ntx, tx = tile & ((1 << sh.lg_ntx) - 1);
        const int off = ((ty * T) << sh.lg_w) + tx * T;
        uint32_t x[T][T / 2];
        load_rows<T, ALIGNED>(pg + off, w, x);
        acc += tile_satd<T>(x, sg + off, w);
      }
    }
    // the prediction's tiles are lpg consecutive, aligned lanes
    for (int o = 1; o < lpg; o <<= 1) acc += __shfl_xor_sync(~0u, acc, o);
    if (t < ntasks && (t & (lpg - 1)) == 0) out[g0 + (t >> sh.lg_lpg)] = acc;
  }
}

int ilog2(int v) { return 31 - __builtin_clz((unsigned)v); }

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

const void* kernel_for(int T, bool aligned) {
  if (T == 8)
    return aligned ? (const void*)satd_modes_kernel<8, true>
                   : (const void*)satd_modes_kernel<8, false>;
  return aligned ? (const void*)satd_modes_kernel<4, true>
                 : (const void*)satd_modes_kernel<4, false>;
}

int g_sms[16];  // per device: SM count (0: not queried yet)

// the shape of a call on N = B * M predictions of w x h (tile T) and its
// dynamic shared memory; `sms` sizes the items so that about 4 per SM run
// (one pass of tasks at least, kMaxPasses at most)
size_t plan(int T, long long N, int M, int w, int h, int sms, Shape& sh) {
  const int ntiles = (w / T) * (h / T);
  const int lpg = ntiles < 32 ? ntiles : 32;
  sh.lg_w = ilog2(w);
  sh.lg_ntx = ilog2(w / T);
  sh.lg_lpg = ilog2(lpg);
  sh.tpl = ntiles / lpg;
  const long long passes = N * lpg / ((long long)kThreads * sms * 4);
  const int P = (int)(passes < 1 ? 1 : (passes > kMaxPasses ? kMaxPasses
                                                            : passes));
  const int hw = w * h;
  const long long cap = (long long)(kSrcBytes / (hw * 4) - 1) * M + 1;
  long long gpi = (long long)P * kThreads / lpg;
  if (gpi > cap) gpi = cap;
  sh.gpi = (int)gpi;
  return (size_t)((gpi + M - 2) / M + 1) * hw * 4;
}

}  // namespace

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// src [B, h, w] int32, preds [B, M, h, w] int16 -> out [B, M] int32 with
// N = B * M.  w, h: powers of two, multiples of 4, w*h/16 <= 256 (the tile
// is 8x8 when both are multiples of 8, else 4x4).  Returns
// cudaGetLastError() after the launch on `stream`.
extern "C" int vt_satd_modes(const void* src, const void* preds, void* out,
                             long long N, int M, int w, int h, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  const int T = (w % 8 == 0 && h % 8 == 0) ? 8 : 4;
  if (w % 4 || h % 4 || !pow2(w) || !pow2(h) || w * h / 16 > 256 ||
      M < 1 || N < 0 || N % M)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int& sms = g_sms[dev & 15];
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  Shape sh;
  const size_t shm = plan(T, N, M, w, h, sms, sh);
  const long long grid = (N + sh.gpi - 1) / sh.gpi;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool aligned = ((uintptr_t)preds & (2 * T - 1)) == 0;
  void* args[] = {(void*)&src, (void*)&preds, (void*)&out, (void*)&N,
                  (void*)&M,   (void*)&h,     (void*)&sh};
  e = cudaLaunchKernel(kernel_for(T, aligned), dim3((unsigned)grid),
                       dim3(kThreads), args, shm, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the resources of the kernel of a (w, h) class on aligned predictions as
// a large batch of 67 modes launches it: out = registers per thread,
// static and dynamic shared memory bytes, threads per block, resident
// blocks per SM, local memory bytes per thread.
extern "C" int vt_satd_modes_attrs(int w, int h, int* out) {
  if (w % 4 || h % 4 || !pow2(w) || !pow2(h) || w * h / 16 > 256)
    return (int)cudaErrorInvalidValue;
  const int T = (w % 8 == 0 && h % 8 == 0) ? 8 : 4;
  Shape sh;
  const size_t shm = plan(T, 1LL << 40, 67, w, h, 1, sh);
  const void* f = kernel_for(T, true);
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, f);
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

// K5 frame_me: best integer motion vector of every 16x16 block of a
// picture against one reference picture.
//
// Replaces vvenc_tpu/ops/me.py:92 frame_me, an XLA program on the TPU
// that built the candidate windows with gathers and reduced them as
// float32 tensors.  Same search: (1) the 4x4 mean-pooled block against
// every displacement of the 4x4 mean-pooled reference within +-R/4
// pooled samples, argmin; (2) the full-resolution block against the
// +-3 displacements around 4x the coarse winner, argmin.  Both SSEs are
// exact integers here: stage 1 on the pooled *sums* (16x the means, so
// the cost is 256x the reference's), stage 2 in int32.  Ties go to the
// lowest candidate index (row-major over (dy, dx)), as jnp.argmin.
//
// Sample range: 0 .. 2047 (11 bits).  Stage 1 sums the four squared
// differences of a pooled row in uint32, which is exact because
// 4 * (16 * 2047)^2 < 2^32, and adds the rows in 64 bits; stage 2's
// 256 * 2047^2 < 2^31 fits int32 (tests/test_torch_exact_split.py holds
// both at the extremes).
//
// Bound: operations.  A 1080p picture is 8,040 blocks of 1,089 stage-1
// candidates of 16 pooled differences and 49 stage-2 candidates of 256
// differences: about 0.7 G integer operations against 11 MB of int16
// planes read.  Design (one launch): a thread block takes a strip of
// kStrip horizontally adjacent 16x16 blocks, whose pooled windows
// overlap, and pools their common window once into shared memory (the
// old kernel pooled each block's own window, about 3x the loads of a
// 4-block strip).  Stage 1 gives each 16x16 block 64 threads; a thread
// computes kDx adjacent displacements of one row at a time, with the
// block's 16 pooled sums in registers and each window row loaded once
// for the kDx candidates, and keeps the lexicographic (cost, index)
// minimum, so the winner does not depend on which thread saw which
// candidate.  Stage 2 spreads (block, dy, row) items over all warps: a
// lane computes the 7 dx candidates of one row, and the 16 rows of a
// (block, dy) are summed by shuffles within a half warp.  (A pre-pass
// pooling the whole reference plane once would cost a launch and a
// scratch plane, which a call at 832x480, bound by its host side, pays
// in full.)
// No product or convolution library is involved.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBs = 16;     // ops/me.py ME_BS
constexpr int kPad = 96;    // ops/me.py ME_PAD
constexpr int kQ = 4;       // pooling factor
constexpr int kRefine = 3;  // ops/me.py REFINE
constexpr int kBq = kBs / kQ;                      // 4 pooled samples a side
constexpr int kStrip = 4;                          // 16x16 blocks per CTA
constexpr int kPerBlock = kThreads / kStrip;       // stage-1 threads a block
constexpr int kDx = 4;                             // displacements a thread
constexpr int kMaxSpan = 2 * (64 / kQ) + kBq;      // 36 (R <= 64)
// shared rows are odd in length, so lanes reading down a column of
// displacements (or of block rows) hit distinct banks
constexpr int kMaxWs = (kMaxSpan + kBq * (kStrip - 1)) | 1;
constexpr int kMaxWin = kMaxSpan * kMaxWs;
constexpr int kSpan2 = 2 * kRefine + kBs;          // 22
constexpr int kS2 = kSpan2 | 1;                    // its row in shared
constexpr int kSb = kBs | 1;                       // a block row in shared
constexpr int kD2 = 2 * kRefine + 1;               // 7
constexpr int kItems2 = kStrip * kD2 * kBs;        // stage-2 (block, dy, row)

static_assert(kPerBlock % 32 == 0, "a block's stage-1 threads are warps");
static_assert(kItems2 % 32 == 0, "stage-2 items fill whole warps");

__device__ __forceinline__ bool lex_less(unsigned long long c, int i,
                                         unsigned long long bc, int bi) {
  return c < bc || (c == bc && i < bi);
}

__global__ void __launch_bounds__(kThreads) frame_me_kernel(
    const int16_t* __restrict__ src, const int16_t* __restrict__ ref,
    int stride, int nx, int R, int* __restrict__ mv,
    float* __restrict__ cost) {
  // + 8: a strip's last kDx - 1 reads may pass the window's end (their
  // candidates lie past D and are dropped)
  __shared__ int win_q[kMaxWin + 8];
  __shared__ int blk_q[kStrip][kBq * kBq];
  __shared__ int win2[kStrip][kSpan2 * kS2];
  __shared__ int blk[kStrip][kBs * kSb];
  __shared__ unsigned long long red_c[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  __shared__ int best1[kStrip];
  __shared__ int2 best2[kStrip][kD2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nsx = (nx + kStrip - 1) / kStrip;
  const int by = blockIdx.x / nsx;
  const int bx0 = (blockIdx.x - by * nsx) * kStrip;
  const int nb = min(kStrip, nx - bx0);
  const int Rq = R / kQ, span = 2 * Rq + kBq, D = 2 * Rq + 1;
  const int wspan = span + kBq * (nb - 1), ws = wspan | 1;
  const int wy0 = by * kBq + kPad / kQ - Rq, wx0 = bx0 * kBq + kPad / kQ - Rq;
  const size_t row0 = (size_t)(kPad + by * kBs) * stride + kPad + bx0 * kBs;

  // ---- staging: the strip's pooled window, its blocks' pooled sums and
  // full-resolution samples ----
  const bool vec = ((uintptr_t)ref & 7) == 0 && (stride & 3) == 0;
  for (int k = tid; k < span * wspan; k += kThreads) {
    const int i = k / wspan, j = k - (k / wspan) * wspan;
    const int16_t* p = ref + (size_t)(kQ * (wy0 + i)) * stride + kQ * (wx0 + j);
    int s = 0;
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      if (vec) {
        const short4 v = *reinterpret_cast<const short4*>(p + (size_t)u * stride);
        s += v.x + v.y + v.z + v.w;
      } else {
#pragma unroll
        for (int v = 0; v < kQ; ++v) s += p[(size_t)u * stride + v];
      }
    }
    win_q[i * ws + j] = s;
  }
  if (tid < nb * kBq * kBq) {
    const int b = tid / (kBq * kBq), k = tid % (kBq * kBq);
    const int16_t* p = src + row0 + (size_t)(kQ * (k / kBq)) * stride +
                       b * kBs + kQ * (k % kBq);
    int s = 0;
#pragma unroll
    for (int u = 0; u < kQ; ++u)
#pragma unroll
      for (int v = 0; v < kQ; ++v) s += p[(size_t)u * stride + v];
    blk_q[b][k] = s;
  }
  for (int k = tid; k < nb * kBs * kBs; k += kThreads) {
    const int b = k / (kBs * kBs), r = (k / kBs) % kBs, c = k % kBs;
    blk[b][r * kSb + c] = src[row0 + (size_t)r * stride + b * kBs + c];
  }
  __syncthreads();

  // ---- stage 1: pooled SSE of every displacement, kDx at a time ----
  const int jb = tid / kPerBlock;
  unsigned long long bc = ~0ull;
  int bi = 0x7fffffff;
  if (jb < nb) {
    int q[kBq * kBq];
#pragma unroll
    for (int k = 0; k < kBq * kBq; ++k) q[k] = blk_q[jb][k];
    const int nsd = (D + kDx - 1) / kDx;
    const int* wb = win_q + kBq * jb;
    for (int t = tid % kPerBlock; t < D * nsd; t += kPerBlock) {
      // dy fastest: a warp's lanes read rows ws apart (distinct banks)
      const int ox0 = (t / D) * kDx, oy = t - (t / D) * D;
      unsigned long long acc[kDx];
#pragma unroll
      for (int d = 0; d < kDx; ++d) acc[d] = 0;
#pragma unroll
      for (int i = 0; i < kBq; ++i) {
        const int* row = wb + (oy + i) * ws + ox0;
        int w[kDx + kBq - 1];
#pragma unroll
        for (int c = 0; c < kDx + kBq - 1; ++c) w[c] = row[c];
#pragma unroll
        for (int d = 0; d < kDx; ++d) {
          unsigned part = 0;  // <= 4 (16 * 2047)^2 < 2^32
#pragma unroll
          for (int j = 0; j < kBq; ++j) {
            const int e = w[d + j] - q[i * kBq + j];
            part += (unsigned)(e * e);
          }
          acc[d] += part;
        }
      }
#pragma unroll
      for (int d = 0; d < kDx; ++d) {
        const int c = oy * D + ox0 + d;
        if (ox0 + d < D && lex_less(acc[d], c, bc, bi)) {
          bc = acc[d];
          bi = c;
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long oc = __shfl_xor_sync(0xffffffffu, bc, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (lex_less(oc, oi, bc, bi)) {
      bc = oc;
      bi = oi;
    }
  }
  if (lane == 0) {
    red_c[warp] = bc;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (tid < nb) {
    constexpr int kWarps = kPerBlock / 32;
    unsigned long long c = red_c[tid * kWarps];
    int i = red_i[tid * kWarps];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      if (lex_less(red_c[tid * kWarps + w], red_i[tid * kWarps + w], c, i)) {
        c = red_c[tid * kWarps + w];
        i = red_i[tid * kWarps + w];
      }
    best1[tid] = i;
  }
  __syncthreads();

  // ---- stage 2: full-resolution +-3 around 4x each block's winner ----
  for (int k = tid; k < nb * kSpan2 * kSpan2; k += kThreads) {
    const int b = k / (kSpan2 * kSpan2), r = k % (kSpan2 * kSpan2);
    const int c1 = best1[b];
    const int cy = c1 / D - Rq, cx = c1 % D - Rq;
    const size_t at = row0 + (size_t)(kQ * cy - kRefine + r / kSpan2) * stride +
                      b * kBs + kQ * cx - kRefine + r % kSpan2;
    win2[b][(r / kSpan2) * kS2 + r % kSpan2] = ref[at];
  }
  __syncthreads();
  for (int base = warp * 32; base < kItems2; base += kThreads) {
    const int item = base + lane;
    const int b = item / (kD2 * kBs), oy = (item / kBs) % kD2,
              row = item % kBs;
    int s[kD2];
#pragma unroll
    for (int d = 0; d < kD2; ++d) s[d] = 0;
    if (b < nb) {
      const int* w = win2[b] + (oy + row) * kS2;
      const int* x = blk[b] + row * kSb;
      int wv[kSpan2], xv[kBs];
#pragma unroll
      for (int c = 0; c < kSpan2; ++c) wv[c] = w[c];
#pragma unroll
      for (int c = 0; c < kBs; ++c) xv[c] = x[c];
#pragma unroll
      for (int d = 0; d < kD2; ++d)
#pragma unroll
        for (int c = 0; c < kBs; ++c) {
          const int e = wv[d + c] - xv[c];
          s[d] += e * e;  // <= 256 * 2047^2 < 2^31 over the 16 rows
        }
    }
    // the 16 rows of one (block, dy) are one half warp
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
#pragma unroll
      for (int d = 0; d < kD2; ++d)
        s[d] += __shfl_xor_sync(0xffffffffu, s[d], o);
    if (row == 0 && b < nb) {
      int c = s[0], i = 0;
#pragma unroll
      for (int d = 1; d < kD2; ++d)
        if (s[d] < c) {  // ascending dx: the first minimum stays
          c = s[d];
          i = d;
        }
      best2[b][oy] = make_int2(c, oy * kD2 + i);
    }
  }
  __syncthreads();
  if (tid < nb) {
    int2 w = best2[tid][0];
#pragma unroll
    for (int oy = 1; oy < kD2; ++oy)
      if (best2[tid][oy].x < w.x) w = best2[tid][oy];  // ascending dy
    const int c1 = best1[tid];
    const int cy = c1 / D - Rq, cx = c1 % D - Rq;
    const int ry = w.y / kD2 - kRefine, rx = w.y % kD2 - kRefine;
    const int b = by * nx + bx0 + tid;
    mv[2 * b] = kQ * cx + rx;
    mv[2 * b + 1] = kQ * cy + ry;
    cost[b] = (float)w.x;  // round to nearest, as the plain version
  }
}

}  // namespace

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// src/ref [(ny*16 + 192), stride] int16 edge-padded planes (stride =
// nx*16 + 192) of samples in 0 .. 2047, mv [ny*nx, 2] int32 (x, y),
// cost [ny*nx] float32, 0 <= R <= 64.  Returns cudaGetLastError() after
// the launch on `stream`.
extern "C" int vt_frame_me(const void* src, const void* ref, int stride,
                           int nx, int ny, int R, void* mv, void* cost,
                           void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (R < 0 || R > 64 || nx <= 0 || ny <= 0 || stride != nx * kBs + 2 * kPad)
    return (int)cudaErrorInvalidValue;
  const int nsx = (nx + kStrip - 1) / kStrip;
  frame_me_kernel<<<nsx * ny, kThreads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)src, (const int16_t*)ref, stride, nx, R, (int*)mv,
      (float*)cost);
  return (int)cudaGetLastError();
}

// The kernel's resources on the current card: out[6] = registers,
// static and dynamic shared bytes, threads, resident blocks per SM,
// local (stack) bytes.  Returns a cudaError_t.
extern "C" int vt_frame_me_attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, frame_me_kernel);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, frame_me_kernel,
                                                    kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = 0;
  out[3] = kThreads;
  out[4] = blocks;
  out[5] = (int)a.localSizeBytes;
  return 0;
}

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
// Exact: every output equals the reference's int32 arithmetic, taken in
// unsigned arithmetic where it is done on the CUDA cores (so that an input
// past the reference's bounds wraps as XLA's int32 does), and >> on the
// signed result is arithmetic, as in XLA.
//
// Bound: bytes (8 a sample: the int32 input read once and the output
// written once).  The earlier kernel computed each output sample as a w-
// or h-long dot product on the integer pipe, each multiply-add reading one
// operand from shared memory and one matrix entry through the read-only
// cache, behind two runtime divisions a sample; its cost grew with w + h
// (12-16x its bound at 32x32 and 64x64).  Design:
// - one instantiation per (direction, w, h): sizes are constants, loops
//   unroll, indices are shifts;
// - a persistent grid walks groups of G = max(1, 2048 / (w h)) blocks,
//   the next group's input in flight by cp.async (16-byte copies where the
//   tensors are 16-byte aligned) while the current one is transformed;
//   the output leaves through shared memory in 16-byte stores;
// - the DCT-2 matrices are staged once per thread block, as s8 (|T| <= 90)
//   byte planes for the tensor cores or as int32 for the integer pipe;
// - a stage whose contraction has 16 points or more is one split-int8
//   product on the tensor cores (mma_split.cuh): its data operand lies in
//   [-2^15, 2^15) (the clipped intermediate always, the input whenever the
//   caller's data does) and every sum stays below 2^15 * 91 * 64 < 2^31, so
//   the int32 accumulators equal the reference's int32.  The 16 * 8 tiles
//   that the 64-point forward zero-out discards are not computed;
// - a 4- or 8-point stage stays on the integer pipe: each thread computes
//   a whole row or column from the values it loads once;
// - a thread block whose staged input lies outside [-2^15, 2^15) (16-bit
//   data, or a caller's out-of-range input) transforms that group on the
//   integer pipe with the reference's wrapping arithmetic (the integer
//   route; decided with __syncthreads_or).
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_split.cuh"

namespace {

using mma_split::Plane;
using mma_split::put_split;
using mma_split::tile_product;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSamples = 2048;  // samples of a group (one block above it)
constexpr int kCoeffMin = -32768, kCoeffMax = 32767;

__device__ __forceinline__ int clip16(int v) {
  return v < kCoeffMin ? kCoeffMin : (v > kCoeffMax ? kCoeffMax : v);
}

// (acc + (1 << (shift - 1))) >> shift on the reference's int32
__device__ __forceinline__ int round_shift(unsigned acc, int shift) {
  return (int)(acc + (1u << (shift - 1))) >> shift;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// the shapes of one (direction, w, h) instantiation; stage 1 contracts K1
// points (x forward, v inverse), stage 2 K2 (y forward, u inverse)
template <bool FWD, int W, int H>
struct Geo {
  static constexpr int HW = W * H;
  static constexpr int G = HW >= kSamples ? 1 : kSamples / HW;
  static constexpr int N = G * HW;
  static constexpr int K1 = FWD ? W : H, K2 = FWD ? H : W;
  static constexpr bool TC1 = K1 >= 16, TC2 = K2 >= 16;
  // rows of each stage's data operand: (block, y) or (block, u)
  static constexpr int R1 = FWD ? G * H : G * W;
  static constexpr int R2 = FWD ? G * W : G * H;
  static constexpr int RW1 = Plane<K1>::RW, RW2 = Plane<K2>::RW;
  // words of each stage's matrix, [output index][contraction index]: an
  // s8 plane (tensor cores) or int32
  static constexpr int MW1 = TC1 ? K1 * RW1 : K1 * K1;
  static constexpr int MW2 = TC2 ? K2 * RW2 : K2 * K2;
  // words of each stage's split data planes (hi, lo)
  static constexpr int DW1 = TC1 ? 2 * R1 * RW1 : 0;
  static constexpr int DW2 = TC2 ? 2 * R2 * RW2 : 0;
  // two input buffers (the current one takes the output), the integer
  // pipe's intermediate, the matrices and the planes
  static constexpr int WORDS = 3 * N + MW1 + MW2 + DW1 + DW2;
  static constexpr bool ZERO_OUT = FWD && (W > 32 || H > 32);
};

// matrix entry (o, k) of a stage: s8 plane byte or int32
template <int K, bool TC>
__device__ __forceinline__ int mat(const uint32_t* m, int o, int k) {
  if constexpr (TC)
    return reinterpret_cast<const int8_t*>(m)[o * Plane<K>::RW * 4 + k];
  else
    return reinterpret_cast<const int*>(m)[o * K + k];
}

// m[o][k] = src[k * K + o] (TRANSPOSED) or src[o * K + k]
template <int K, bool TC, bool TRANSPOSED>
__device__ __forceinline__ void stage_matrix(uint32_t* m,
                                             const int* __restrict__ src) {
  for (int i = threadIdx.x; i < K * K; i += kThreads) {
    const int o = i / K, k = i % K;
    const int v = __ldg(src + (TRANSPOSED ? k * K + o : i));
    if constexpr (TC)
      reinterpret_cast<int8_t*>(m)[o * Plane<K>::RW * 4 + k] = (int8_t)v;
    else
      reinterpret_cast<int*>(m)[i] = v;
  }
}

// group grp's input into dst by cp.async (one commit group); the blocks
// past B are zeros
template <class Q>
__device__ __forceinline__ void load_group(const int* __restrict__ in,
                                           int* dst, long long grp,
                                           long long B, bool vec) {
  const long long b0 = grp * Q::G;
  const int n = (int)min((long long)Q::G, B - b0) * Q::HW;
  const int* src = in + b0 * Q::HW;
  if (vec) {
    for (int i = threadIdx.x * 4; i < n; i += kThreads * 4)
      cp_async16(dst + i, src + i);
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) cp_async4(dst + i, src + i);
  }
  for (int i = n + threadIdx.x; i < Q::N; i += kThreads) dst[i] = 0;
  cp_async_commit();
}

template <bool FWD, int W, int H>
__global__ void __launch_bounds__(kThreads) tr_kernel(
    const int* __restrict__ in, int* __restrict__ out, long long B,
    int shift1, int shift2, const int* __restrict__ src1,
    const int* __restrict__ src2) {
  using Q = Geo<FWD, W, H>;
  constexpr int HW = Q::HW, G = Q::G, N = Q::N;
  constexpr int RW1 = Q::RW1, RW2 = Q::RW2;
  extern __shared__ __align__(16) uint32_t sm[];
  int* const s_buf = reinterpret_cast<int*>(sm);     // [2][N]
  int* const s_tmp = s_buf + 2 * N;                   // [G][H][W]
  uint32_t* const m1 = sm + 3 * N;
  uint32_t* const m2 = m1 + Q::MW1;
  uint32_t* const d1h = m2 + Q::MW2;
  uint32_t* const d1l = d1h + Q::R1 * RW1;
  uint32_t* const d2h = d1h + Q::DW1;
  uint32_t* const d2l = d2h + Q::R2 * RW2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const long long ngroups = (B + G - 1) / G;
  const bool vec =
      ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  long long grp = blockIdx.x;
  if (grp < ngroups) load_group<Q>(in, s_buf, grp, B, vec);
  // the planes zeroed (their contraction padding stays 0), the matrices
  for (int i = tid; i < Q::MW1 + Q::MW2 + Q::DW1 + Q::DW2; i += kThreads)
    m1[i] = 0;
  __syncthreads();
  if constexpr (FWD) {
    stage_matrix<W, Q::TC1, true>(m1, src1);    // Tw[u][x] = twT[x][u]
    stage_matrix<H, Q::TC2, false>(m2, src2);   // Th[v][y]
  } else {
    stage_matrix<H, Q::TC1, true>(m1, src1);    // Th^T[y][v] = th[v][y]
    stage_matrix<W, Q::TC2, true>(m2, src2);    // Tw^T[x][u] = tw[u][x]
  }

  // a stage-1 result at (block gb, row y, column u) into stage 2's input
  auto put_mid = [&](int gb, int y, int u, int val) {
    if constexpr (Q::TC2) {
      if constexpr (FWD)
        put_split<RW2>(d2h, d2l, gb * W + u, y, val);   // [g][u][y]
      else
        put_split<RW2>(d2h, d2l, gb * H + y, u, val);   // [g][y][u]
    } else {
      s_tmp[gb * HW + y * W + u] = val;
    }
  };

  for (int it = 0; grp < ngroups; grp += gridDim.x, ++it) {
    int* const cur = s_buf + (it & 1) * N;
    if (grp + gridDim.x < ngroups) {
      load_group<Q>(in, s_buf + ((it + 1) & 1) * N, grp + gridDim.x, B, vec);
      cp_async_wait_all_but_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    bool wide = false;
    if constexpr (Q::TC1) {
      // the input split into stage 1's data planes; any value outside
      // [-2^15, 2^15) sends the group to the integer route
      for (int i = tid; i < N; i += kThreads) {
        const int gb = i / HW, r = i % HW, a = r / W, c = r % W;
        const int v = cur[i];
        wide |= v < kCoeffMin || v > kCoeffMax;
        if constexpr (FWD)
          put_split<RW1>(d1h, d1l, gb * H + a, c, v);   // [g][y][x]
        else
          put_split<RW1>(d1h, d1l, gb * W + c, a, v);   // [g][u][v]
      }
      wide = __syncthreads_or(wide);
    }
    if (wide) {
      // the integer route: both stages as the reference computes them
      for (int i = tid; i < N; i += kThreads) {
        const int gb = i / HW, r = i % HW, y = r / W, u = r % W;
        const int* blk = cur + gb * HW;
        unsigned acc = 0;
        if constexpr (FWD) {
#pragma unroll 8
          for (int x = 0; x < W; ++x)
            acc += (unsigned)blk[y * W + x] *
                   (unsigned)mat<W, Q::TC1>(m1, u, x);
          s_tmp[i] = clip16(round_shift(acc, shift1));
        } else {
#pragma unroll 8
          for (int v = 0; v < H; ++v)
            acc += (unsigned)mat<H, Q::TC1>(m1, y, v) *
                   (unsigned)blk[v * W + u];
          s_tmp[i] = clip16(round_shift(acc, 7));
        }
      }
      __syncthreads();
      for (int i = tid; i < N; i += kThreads) {
        const int gb = i / HW, r = i % HW, a = r / W, c = r % W;
        const int* t = s_tmp + gb * HW;
        unsigned acc = 0;
        if constexpr (FWD) {
#pragma unroll 8
          for (int y = 0; y < H; ++y)
            acc += (unsigned)mat<H, Q::TC2>(m2, a, y) *
                   (unsigned)t[y * W + c];
        } else {
#pragma unroll 8
          for (int u = 0; u < W; ++u)
            acc += (unsigned)t[a * W + u] *
                   (unsigned)mat<W, Q::TC2>(m2, c, u);
        }
        cur[i] = clip16(round_shift(acc, shift2));
      }
    } else {
      // ---- stage 1 ----
      if constexpr (FWD && Q::TC1) {
        // tmp[(g, y)][u] = sum_x in[(g, y)][x] Tw[u][x]; u < 32 only at 64
        constexpr int NT = (W > 32 ? 32 : W) / 8;
        for (int tt = warp; tt < (Q::R1 / 16) * NT; tt += kWarps) {
          const int m0 = (tt / NT) * 16, n0 = (tt % NT) * 8;
          int c[4];
          tile_product<Plane<W>::KP, RW1, true>(d1h, d1l, m1, nullptr, m0,
                                                n0, c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = m0 + gq + 8 * (e >> 1);
            put_mid(row / H, row % H, n0 + 2 * t4 + (e & 1),
                    clip16(round_shift((unsigned)c[e], shift1)));
          }
        }
      } else if constexpr (FWD) {
        // rows of 4 or 8: tmp[(g, y)][u] from the row loaded once
        for (int row = tid; row < G * H; row += kThreads) {
          int x[W];
#pragma unroll
          for (int k = 0; k < W; k += 4) {
            const int4 q = *reinterpret_cast<const int4*>(cur + row * W + k);
            x[k] = q.x;
            x[k + 1] = q.y;
            x[k + 2] = q.z;
            x[k + 3] = q.w;
          }
#pragma unroll
          for (int u = 0; u < W; ++u) {
            unsigned acc = 0;
#pragma unroll
            for (int k = 0; k < W; ++k)
              acc += (unsigned)x[k] * (unsigned)mat<W, false>(m1, u, k);
            put_mid(row / H, row % H, u, clip16(round_shift(acc, shift1)));
          }
        }
      } else if constexpr (Q::TC1) {
        // tmp[y][(g, u)] = sum_v Th^T[y][v] coeff^T[(g, u)][v]
        constexpr int NT = G * W / 8;
        for (int tt = warp; tt < (H / 16) * NT; tt += kWarps) {
          const int m0 = (tt / NT) * 16, n0 = (tt % NT) * 8;
          int c[4];
          tile_product<Plane<H>::KP, RW1, false>(m1, nullptr, d1h, d1l, m0,
                                                 n0, c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = n0 + 2 * t4 + (e & 1);
            put_mid(col / W, m0 + gq + 8 * (e >> 1), col % W,
                    clip16(round_shift((unsigned)c[e], 7)));
          }
        }
      } else {
        // columns of 4 or 8: tmp[y][(g, u)] from the column loaded once
        for (int col = tid; col < G * W; col += kThreads) {
          const int gb = col / W, u = col % W;
          int cv[H];
#pragma unroll
          for (int v = 0; v < H; ++v) cv[v] = cur[gb * HW + v * W + u];
#pragma unroll
          for (int y = 0; y < H; ++y) {
            unsigned acc = 0;
#pragma unroll
            for (int v = 0; v < H; ++v)
              acc += (unsigned)mat<H, false>(m1, y, v) * (unsigned)cv[v];
            put_mid(gb, y, u, clip16(round_shift(acc, 7)));
          }
        }
      }
      __syncthreads();
      // ---- stage 2, into cur ----
      if constexpr (FWD && Q::TC2) {
        // out[v][(g, u)] = sum_y Th[v][y] tmp^T[(g, u)][y]; v < 32 and
        // u < 32 only at 64 (the rest is zeroed at the store)
        constexpr int MT = (H > 32 ? 32 : H) / 16, NT = G * W / 8;
        for (int tt = warp; tt < MT * NT; tt += kWarps) {
          const int m0 = (tt / NT) * 16, n0 = (tt % NT) * 8;
          if (W > 32 && n0 % W >= 32) continue;
          int c[4];
          tile_product<Plane<H>::KP, RW2, false>(m2, nullptr, d2h, d2l, m0,
                                                 n0, c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int v = m0 + gq + 8 * (e >> 1);
            const int col = n0 + 2 * t4 + (e & 1);
            cur[(col / W) * HW + v * W + col % W] =
                clip16(round_shift((unsigned)c[e], shift2));
          }
        }
      } else if constexpr (FWD) {
        // columns of 4 or 8
        for (int col = tid; col < G * W; col += kThreads) {
          const int gb = col / W, u = col % W;
          if (W > 32 && u >= 32) continue;
          int t[H];
#pragma unroll
          for (int y = 0; y < H; ++y) t[y] = s_tmp[gb * HW + y * W + u];
#pragma unroll
          for (int v = 0; v < H; ++v) {
            unsigned acc = 0;
#pragma unroll
            for (int y = 0; y < H; ++y)
              acc += (unsigned)mat<H, false>(m2, v, y) * (unsigned)t[y];
            cur[gb * HW + v * W + u] = clip16(round_shift(acc, shift2));
          }
        }
      } else if constexpr (Q::TC2) {
        // out[(g, y)][x] = sum_u tmp[(g, y)][u] Tw^T[x][u]
        constexpr int NT = W / 8;
        for (int tt = warp; tt < (Q::R2 / 16) * NT; tt += kWarps) {
          const int m0 = (tt / NT) * 16, n0 = (tt % NT) * 8;
          int c[4];
          tile_product<Plane<W>::KP, RW2, true>(d2h, d2l, m2, nullptr, m0,
                                                n0, c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = m0 + gq + 8 * (e >> 1);
            cur[row * W + n0 + 2 * t4 + (e & 1)] =
                clip16(round_shift((unsigned)c[e], shift2));
          }
        }
      } else {
        // rows of 4 or 8
        for (int row = tid; row < G * H; row += kThreads) {
          int t[W];
#pragma unroll
          for (int k = 0; k < W; k += 4) {
            const int4 q = *reinterpret_cast<const int4*>(s_tmp + row * W + k);
            t[k] = q.x;
            t[k + 1] = q.y;
            t[k + 2] = q.z;
            t[k + 3] = q.w;
          }
#pragma unroll
          for (int x = 0; x < W; ++x) {
            unsigned acc = 0;
#pragma unroll
            for (int u = 0; u < W; ++u)
              acc += (unsigned)t[u] * (unsigned)mat<W, false>(m2, x, u);
            cur[row * W + x] = clip16(round_shift(acc, shift2));
          }
        }
      }
    }
    __syncthreads();
    // the group's live samples out (16-byte stores where aligned)
    const long long b0 = grp * G;
    const int n = (int)min((long long)G, B - b0) * HW;
    int* dst = out + b0 * HW;
    if (vec) {
      for (int i = tid * 4; i < n; i += kThreads * 4) {
        int4 v = *reinterpret_cast<const int4*>(cur + i);
        if constexpr (Q::ZERO_OUT) {
          const int r = i % HW, y = r / W, x = r % W;  // 4 | W: one row
          if (y >= 32) v = make_int4(0, 0, 0, 0);
          if (x >= 32) v.x = 0;
          if (x + 1 >= 32) v.y = 0;
          if (x + 2 >= 32) v.z = 0;
          if (x + 3 >= 32) v.w = 0;
        }
        *reinterpret_cast<int4*>(dst + i) = v;
      }
    } else {
      for (int i = tid; i < n; i += kThreads) {
        const int r = i % HW;
        dst[i] = Q::ZERO_OUT && (r / W >= 32 || r % W >= 32) ? 0 : cur[i];
      }
    }
    __syncthreads();   // cur is the next group's prefetch target
  }
  cp_async_wait_all();
}

bool valid_side(int n) { return n >= 4 && n <= 64 && (n & (n - 1)) == 0; }

int side_index(int n) {  // 4 -> 0 .. 64 -> 4
  return 31 - __builtin_clz((unsigned)n) - 2;
}

// a kernel instantiation, its dynamic shared memory and its blocks per
// group
struct Inst {
  const void* f;
  size_t shm;
};

template <bool FWD, int W, int H>
Inst inst() {
  return {(const void*)tr_kernel<FWD, W, H>,
          (size_t)Geo<FWD, W, H>::WORDS * 4};
}

template <bool FWD, int W>
Inst inst_h(int h) {
  switch (h) {
    case 4: return inst<FWD, W, 4>();
    case 8: return inst<FWD, W, 8>();
    case 16: return inst<FWD, W, 16>();
    case 32: return inst<FWD, W, 32>();
    default: return inst<FWD, W, 64>();
  }
}

template <bool FWD>
Inst inst_wh(int w, int h) {
  switch (w) {
    case 4: return inst_h<FWD, 4>(h);
    case 8: return inst_h<FWD, 8>(h);
    case 16: return inst_h<FWD, 16>(h);
    case 32: return inst_h<FWD, 32>(h);
    default: return inst_h<FWD, 64>(h);
  }
}

// per device (up to 16) and instantiation: resident blocks per SM (0: not
// queried yet; the shared memory attribute is set before the query)
int g_resident[16][2][5][5];
int g_sms[16];

// the instantiation for (w, h), its attribute set and its persistent grid
// for B blocks (0 on error, e set)
unsigned prepare(bool fwd, int w, int h, long long B, Inst& in,
                 cudaError_t& e) {
  in = fwd ? inst_wh<true>(w, h) : inst_wh<false>(w, h);
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return 0;
  int& res = g_resident[dev & 15][fwd][side_index(w)][side_index(h)];
  if (res == 0) {
    e = cudaFuncSetAttribute(in.f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)in.shm);
    if (e != cudaSuccess) return 0;
    e = cudaDeviceGetAttribute(&g_sms[dev & 15],
                               cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return 0;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, in.f, kThreads,
                                                      in.shm);
    if (e != cudaSuccess) return 0;
    res = blocks < 1 ? 1 : blocks;
  }
  const int hw = w * h;
  const long long G = hw >= kSamples ? 1 : kSamples / hw;
  const long long groups = (B + G - 1) / G;
  const long long cap = (long long)res * g_sms[dev & 15];
  return (unsigned)(groups < cap ? groups : cap);
}

int launch(bool fwd, const void* in, void* out, long long B, int w, int h,
           int shift1, int shift2, const void* src1, const void* src2,
           void* stream) {
  Inst k;
  cudaError_t e;
  const unsigned grid = prepare(fwd, w, h, B, k, e);
  if (!grid) return (int)e;
  void* args[] = {(void*)&in, (void*)&out, (void*)&B, (void*)&shift1,
                  (void*)&shift2, (void*)&src1, (void*)&src2};
  e = cudaLaunchKernel(k.f, dim3(grid), dim3(kThreads), args, k.shm,
                       (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// in/out [B, h, w] int32 (contiguous, distinct), twT = DCT-2(w)^T and
// th = DCT-2(h) as [n, n] int32 (entries within s8).  Returns
// cudaGetLastError() after the launch on `stream`.
extern "C" int vt_fwd_transform_batch(const void* in, void* out, long long B,
                                      int w, int h, int shift1, int shift2,
                                      const void* twT, const void* th,
                                      void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (!valid_side(w) || !valid_side(h) || B <= 0 || shift1 < 1 || shift2 < 1)
    return (int)cudaErrorInvalidValue;
  return launch(true, in, out, B, w, h, shift1, shift2, twT, th, stream);
}

// in/out [B, h, w] int32 (contiguous, distinct), th = DCT-2(h) and
// tw = DCT-2(w) as [n, n] int32 (entries within s8); the first stage
// shifts by 7.
extern "C" int vt_inv_transform_batch(const void* in, void* out, long long B,
                                      int w, int h, int shift2,
                                      const void* th, const void* tw,
                                      void* stream) {
  cudaGetLastError();
  if (!valid_side(w) || !valid_side(h) || B <= 0 || shift2 < 1)
    return (int)cudaErrorInvalidValue;
  return launch(false, in, out, B, w, h, 7, shift2, th, tw, stream);
}

// the resources of the kernel of a (w, h) class, forward (inverse = 0) or
// inverse: out = registers per thread, static and dynamic shared memory
// bytes, threads per block, resident blocks per SM, local memory bytes
// per thread.
extern "C" int vt_transform_batch_attrs(int w, int h, int inverse,
                                        int* out) {
  if (!valid_side(w) || !valid_side(h)) return (int)cudaErrorInvalidValue;
  Inst k;
  cudaError_t e;
  if (!prepare(!inverse, w, h, 1, k, e)) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, k.f);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k.f, kThreads,
                                                    k.shm);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)k.shm;
  out[3] = kThreads;
  out[4] = blocks;
  out[5] = (int)a.localSizeBytes;
  return 0;
}

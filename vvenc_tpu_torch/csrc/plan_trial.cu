// K3 plan_trial: top-k intra modes by SATD + mode-bit bias, then a full
// transform/quant trial of each survivor -> RD cost.
//
// Replaces vvenc_tpu/ops/intra_plan.py:109 _plan_class_core after its SATD
// (with _fwd_tr :74 and _inv_tr :95), an XLA program on the TPU.  Same
// arithmetic: f32 scores satd + mode_bits[m] * lambda_sad in that order;
// top-k with ties to the lowest mode index (jax.lax.top_k); per survivor
// the residual, the two-stage int32 forward transform (DST7/DCT2 rows
// then columns, each stage rounded, shifted and clipped to
// [COEFF_MIN, COEFF_MAX], zero-out beyond 32 for 64-point sides), scalar
// quantisation |c| * scale + (171 << (qbits - 9)) >> qbits in wrapping
// int32, dequantisation, the inverse transform, the clipped
// reconstruction, then SSE, nnz and sum log2(1 + |level|) ->
// cost = sse + lambda * (bits + mode_bits).  Built with -fmad=false so no
// f32 product and sum are contracted into an FMA.  SSE and nnz are summed
// exactly in integers and converted once; the log2 sum is an f32 sum in
// another order than XLA's (the tests allow rtol 1e-5 on costs).
//
// What bounds it on the H100: a survivor costs four s x s x s matrix
// products (8 s^3 multiply-adds a block for k = 2) against 67 * 4 bytes
// of SATD, s * s * 4 of source and k * s * s * 2 of predictions read.
// As int32 multiply-adds on the CUDA cores that is operations from 16x16
// up (1.6e8 per 1080p frame of 64x64 blocks); as split int8 products on
// the tensor cores (16 s^3 int8 operations a survivor at 1,979 T/s) every
// class is bound by the bytes it reads, and 4x4 and 8x8 are so even at
// the int32 rate.  The earlier kernel ran one block of up to 256 threads
// per candidate (32 threads, 16 busy, at 4x4), ranked the modes on one
// thread, read the row transform at a stride of w ints (32-way bank
// conflicts at w >= 32) and held 98 KB of shared memory at 64x64 (two
// blocks per SM).
//
// Design:
// - the ranking is a warp argmin over (score, mode) keys, the lowest
//   index on ties, k times (three modes a lane);
// - 16x16, 32x32, 64x64: one block per candidate, the four products on
//   the tensor cores (mma.sync m16n8k32, int8 in, int32 accumulators).
//   The transform matrices (|T| <= 91) are s8.  The data operand of each
//   product (the residual, |r| < 2^bd; the clipped stage results and
//   dequantised levels, in [-2^15, 2^15)) is split into a signed high
//   byte and an unsigned low byte, x = 256 * hi + lo, and the two
//   products recombined in int32: 256 * sum(T * hi) + sum(T * lo) is
//   sum(T * x) exactly, every partial sum inside int32 (|256 * sum(T *
//   hi)| <= 256 * 64 * 91 * 128 = 1.9e8); tests/test_torch_exact_split.py
//   holds this against int64 products at the extremes.  Operands live
//   in shared memory as byte planes with the contraction index
//   contiguous and a row stride of 4 (mod 8) words, so every fragment
//   load is conflict-free; each product's epilogue writes the next
//   product's operand (transposed where the next contraction needs it).  The next survivor's
//   prediction is in flight by cp.async while the current one runs;
// - every other shape (4x4, 8x8, the rectangular ones no encoder path
//   uses): one warp per candidate, eight to a block, the products on
//   the CUDA cores from per-warp planes at odd strides with the
//   transposed matrices, KC = 32 / (w h) survivors side by side.
//
// Two entries share these kernels.  vt_plan_trial reads the k survivors'
// predictions from K1's [B, 67, h, w] output.  vt_plan_trial_refs takes
// the candidates' reference rows (tops / lefts, int32 [B, >= LPAD])
// instead: each candidate (block or warp) stages its reference pool in
// shared memory (4 x LPAD ints, 2.1 KB at 64x64) and, after the ranking,
// predicts only its k survivors there with K1's own per-sample arithmetic
// (intra_pred.cuh), so the planning path never writes the 67 predictions
// to device memory.  The SATD it ranks by then comes from K4's gathered
// entry (presel_costs.cu), which fuses K1 and K2.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "intra_pred.cuh"
#include "mma_split.cuh"

namespace {

using mma_split::put_split;
using mma_split::tile_product;

constexpr int kModes = 67;
constexpr int kCoeffMin = -(1 << 15), kCoeffMax = (1 << 15) - 1;

struct TrialParams {
  int w, h, k, M;
  int shift1, shift2, ishift2;
  int qbits, qscale, qadd, dshift, dscale, maxval;
  float c0, c1, c2;
};

struct Inputs {
  const int* src;
  const int16_t* preds;     // vt_plan_trial
  const int* tops;          // vt_plan_trial_refs: [B, Lt] and [B, Ll]
  const int* lefts;
  int Lt, Ll, bit_depth;
  intra_pred::Tables pt;    // K1's tables of the class
  const int* satd;
  const float* lmbda;
  const float* lmbda_sad;
  const float* mode_bits;
  const int* tw;
  const int* th;
  int* modes;
  float* costs;
  int B;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int round_shift(int v, int s) {
  return (v + (1 << (s - 1))) >> s;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v, int width = 32) {
  for (int o = width >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the k lowest (score, mode) keys of candidate b by its warp: scores
// satd + mode_bits * lambda_sad (f32, that order), ties to the lowest
// mode; top[0..k) in shared memory
__device__ void rank_modes(const Inputs& in, const TrialParams& p, int b,
                           int* top) {
  const int lane = threadIdx.x & 31;
  const float lsad = in.lmbda_sad[b];
  float sc[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int m = lane + 32 * j;
    sc[j] = m < p.M ? __fadd_rn((float)in.satd[(size_t)b * p.M + m],
                                __fmul_rn(in.mode_bits[m], lsad))
                    : INFINITY;
  }
  unsigned taken = 0;
  for (int i = 0; i < p.k; ++i) {
    float bs = INFINITY;
    int bm = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int m = lane + 32 * j;
      if (m < p.M && !((taken >> j) & 1u) &&
          (sc[j] < bs || (sc[j] == bs && m < bm))) {
        bs = sc[j];
        bm = m;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bs, o);
      const int om = __shfl_xor_sync(0xffffffffu, bm, o);
      if (os < bs || (os == bs && om < bm)) {
        bs = os;
        bm = om;
      }
    }
    if ((bm & 31) == lane) taken |= 1u << (bm >> 5);
    if (lane == 0) top[i] = bm;
  }
}

// |c| * scale + add >> qbits in wrapping int32 (the reference's), the
// level's statistics, and the dequantised, clipped coefficient
__device__ __forceinline__ int quant_dequant(const TrialParams& p, int c,
                                             int& nnz, float& slog) {
  const int a = abs(c);
  const int mag =
      (int)((unsigned)a * (unsigned)p.qscale + (unsigned)p.qadd) >> p.qbits;
  const int q = c > 0 ? mag : (c < 0 ? -mag : 0);
  nnz += q != 0;
  slog = __fadd_rn(slog, log2f(__fadd_rn(1.0f, (float)mag)));
  const int qc = clampi(q, -(1 << 15), (1 << 15) - 1);
  const int d = p.dshift > 0
                    ? (qc * p.dscale + (1 << (p.dshift - 1))) >> p.dshift
                    : (qc * p.dscale) << (-p.dshift);
  return clampi(d, kCoeffMin, kCoeffMax);
}

// cost = sse + lambda * (bits + mode_bits[mode]) from a survivor's sums
__device__ __forceinline__ float trial_cost(const TrialParams& p,
                                            long long sse, int nnz,
                                            float slog, float lm, float mb) {
  const float bits =
      nnz > 0 ? __fadd_rn(__fadd_rn(p.c0, __fmul_rn(p.c1, (float)nnz)),
                          __fmul_rn(p.c2, slog))
              : 1.0f;
  return __fadd_rn((float)sse, __fmul_rn(lm, __fadd_rn(bits, mb)));
}

// ---------------------------------------------------------------------
// 16x16 .. 64x64 on the tensor cores
// ---------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
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

// byte planes of S rows (mma_split.cuh: KP bytes of contraction, S or 32
// zero-padded at 16, in a row of RW words)
template <int S>
struct TcGeom {
  static constexpr int KP = mma_split::Plane<S>::KP;
  static constexpr int RW = mma_split::Plane<S>::RW;
  static constexpr int PLANE = S * RW;            // words
  static constexpr int THREADS = S == 16 ? 64 : 256;
  static constexpr int NT = S / 8;                // n tiles (8 wide)
  static constexpr int TILES = (S / 16) * NT;     // m tiles (16 high) x n
};

template <int S, bool REFS>
__global__ void __launch_bounds__(TcGeom<S>::THREADS) plan_trial_tc_kernel(
    const Inputs in, const TrialParams p) {
  using G = TcGeom<S>;
  constexpr int NW = G::THREADS / 32;
  extern __shared__ __align__(16) uint32_t sm[];
  // matrix planes (s8): tw [u][x], th [v][y], th^T [y][v], tw^T [x][u]
  uint32_t* m_tw = sm;
  uint32_t* m_th = m_tw + G::PLANE;
  uint32_t* m_thT = m_th + G::PLANE;
  uint32_t* m_twT = m_thT + G::PLANE;
  // data planes, two split pairs used in turn
  uint32_t* x_hi = m_twT + G::PLANE;
  uint32_t* x_lo = x_hi + G::PLANE;
  uint32_t* y_hi = x_lo + G::PLANE;
  uint32_t* y_lo = y_hi + G::PLANE;
  int* s_src = reinterpret_cast<int*>(y_lo + G::PLANE);      // [S][S]
  int16_t* s_pred = reinterpret_cast<int16_t*>(s_src + S * S);  // [2][S*S]
  // REFS: the candidate's reference pool [4][LPAD] (intra_pred.cuh)
  int* s_pool = reinterpret_cast<int*>(s_pred + 2 * S * S);
  __shared__ int s_dc;
  __shared__ int s_top[kModes];
  __shared__ long long s_sse[NW];
  __shared__ int s_nnz[NW];
  __shared__ float s_slog[NW];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  if (warp == 0) rank_modes(in, p, b, s_top);
  // planes zeroed (the contraction padding at 16 stays 0), matrices as s8
  for (int i = tid; i < 8 * G::PLANE; i += G::THREADS) sm[i] = 0;
  __syncthreads();
  for (int i = tid; i < S * S; i += G::THREADS) {
    const int r = i / S, c = i - r * S;
    const int8_t tw = (int8_t)in.tw[i], th = (int8_t)in.th[i];
    reinterpret_cast<int8_t*>(m_tw)[r * G::RW * 4 + c] = tw;    // tw[u][x]
    reinterpret_cast<int8_t*>(m_twT)[c * G::RW * 4 + r] = tw;   // tw[x][u]
    reinterpret_cast<int8_t*>(m_th)[r * G::RW * 4 + c] = th;    // th[v][y]
    reinterpret_cast<int8_t*>(m_thT)[c * G::RW * 4 + r] = th;   // th[y][v]
    s_src[i] = in.src[(size_t)b * S * S + i];
  }
  if constexpr (REFS)
    intra_pred::pool_load(in.tops + (size_t)b * in.Lt,
                          in.lefts + (size_t)b * in.Ll, s_pool, in.pt.LPAD,
                          tid, G::THREADS);
  __syncthreads();
  if constexpr (REFS) {
    intra_pred::pool_filter(s_pool, in.pt.LPAD, S, S, tid, G::THREADS);
    if (tid == 0) s_dc = intra_pred::pool_dc(s_pool, in.pt.LPAD, S, S);
    __syncthreads();
  }
  auto fetch_pred = [&](int i) {
    const int16_t* pb = in.preds + ((size_t)b * p.M + s_top[i]) * S * S;
    int16_t* dst = s_pred + (i & 1) * S * S;
    for (int j = tid; j < S * S / 8; j += G::THREADS)
      cp_async16(dst + 8 * j, pb + 8 * j);
    cp_async_commit();
  };
  if constexpr (!REFS) fetch_pred(0);
  const float lm = in.lmbda[b];
  const bool zero_out = S > 32;
  for (int i = 0; i < p.k; ++i) {
    if constexpr (REFS) {
      // survivor i's prediction (its buffer was last read two survivors
      // ago, behind the barriers of the one between)
      int16_t* dst = s_pred + (i & 1) * S * S;
      const int mode = s_top[i];
      for (int j = tid; j < S * S; j += G::THREADS)
        dst[j] = (int16_t)intra_pred::pred_sample(
            s_pool, s_dc, in.pt, S, S, in.bit_depth, mode, j / S, j % S);
    } else if (i + 1 < p.k) {
      fetch_pred(i + 1);
      cp_async_wait_all_but_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const int16_t* pred = s_pred + (i & 1) * S * S;
    // the residual, split, as A of the row product: [y][x]
    for (int j = tid; j < S * S; j += G::THREADS) {
      const int y = j / S, x = j - y * S;
      put_split<G::RW>(x_hi, x_lo, y, x, s_src[j] - (int)pred[j]);
    }
    __syncthreads();
    // forward rows: a[y][u] = sum_x r[y][x] tw[u][x] -> y planes [u][y]
    for (int tt = warp; tt < G::TILES; tt += NW) {
      const int m0 = (tt / G::NT) * 16, n0 = (tt % G::NT) * 8;
      int c[4];
      tile_product<G::KP, G::RW, true>(x_hi, x_lo, m_tw, nullptr, m0, n0, c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int y = m0 + g + 8 * (e >> 1), u = n0 + 2 * t4 + (e & 1);
        put_split<G::RW>(y_hi, y_lo, u, y,
                     clampi(round_shift(c[e], p.shift1), kCoeffMin, kCoeffMax));
      }
    }
    __syncthreads();
    // forward columns: c[v][u] = sum_y th[v][y] a[y][u]; quantise and
    // dequantise -> x planes [u][v]
    int nnz = 0;
    float slog = 0.f;
    for (int tt = warp; tt < G::TILES; tt += NW) {
      const int m0 = (tt / G::NT) * 16, n0 = (tt % G::NT) * 8;
      int c[4] = {0, 0, 0, 0};
      const bool kept = !zero_out || (m0 < 32 && n0 < 32);
      if (kept)
        tile_product<G::KP, G::RW, false>(m_th, nullptr, y_hi, y_lo, m0, n0,
                                          c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int v = m0 + g + 8 * (e >> 1), u = n0 + 2 * t4 + (e & 1);
        int d = 0;
        if (kept) {
          const int cf =
              clampi(round_shift(c[e], p.shift2), kCoeffMin, kCoeffMax);
          d = quant_dequant(p, cf, nnz, slog);
        }
        put_split<G::RW>(x_hi, x_lo, u, v, d);
      }
    }
    __syncthreads();
    // inverse columns: a[y][u] = sum_v th[v][y] d[v][u] -> y planes [y][u]
    for (int tt = warp; tt < G::TILES; tt += NW) {
      const int m0 = (tt / G::NT) * 16, n0 = (tt % G::NT) * 8;
      int c[4];
      tile_product<G::KP, G::RW, false>(m_thT, nullptr, x_hi, x_lo, m0, n0, c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int y = m0 + g + 8 * (e >> 1), u = n0 + 2 * t4 + (e & 1);
        put_split<G::RW>(y_hi, y_lo, y, u,
                     clampi(round_shift(c[e], 7), kCoeffMin, kCoeffMax));
      }
    }
    __syncthreads();
    // inverse rows: r[y][x] = sum_u a[y][u] tw[u][x]; recon and SSE
    long long sse = 0;
    for (int tt = warp; tt < G::TILES; tt += NW) {
      const int m0 = (tt / G::NT) * 16, n0 = (tt % G::NT) * 8;
      int c[4];
      tile_product<G::KP, G::RW, true>(y_hi, y_lo, m_twT, nullptr, m0, n0, c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int y = m0 + g + 8 * (e >> 1), x = n0 + 2 * t4 + (e & 1);
        const int r = clampi(round_shift(c[e], p.ishift2), kCoeffMin,
                             kCoeffMax);
        const int rec = clampi((int)pred[y * S + x] + r, 0, p.maxval);
        const int er = s_src[y * S + x] - rec;
        sse += (long long)er * er;
      }
    }
    sse = warp_sum(sse);
    nnz = warp_sum(nnz);
    slog = warp_sum(slog);
    if (lane == 0) {
      s_sse[warp] = sse;
      s_nnz[warp] = nnz;
      s_slog[warp] = slog;
    }
    __syncthreads();
    if (tid == 0) {
      long long sse_t = 0;
      int nnz_t = 0;
      float slog_t = 0.f;
      for (int q = 0; q < NW; ++q) {
        sse_t += s_sse[q];
        nnz_t += s_nnz[q];
        slog_t = __fadd_rn(slog_t, s_slog[q]);
      }
      const int mode = s_top[i];
      in.modes[(size_t)b * p.k + i] = mode;
      in.costs[(size_t)b * p.k + i] =
          trial_cost(p, sse_t, nnz_t, slog_t, lm, in.mode_bits[mode]);
    }
    // x planes, the prediction buffer and the sums are reused
  }
}

template <int S>
size_t tc_smem(bool refs) {
  using G = TcGeom<S>;
  return (size_t)8 * G::PLANE * 4 + (size_t)S * S * 4 +
         (size_t)2 * S * S * 2 + (refs ? (size_t)4 * (2 * S + 3) * 4 : 0);
}

// ---------------------------------------------------------------------
// every other shape: a warp per candidate on the CUDA cores
// ---------------------------------------------------------------------

constexpr int kWarpThreads = 256;

struct WarpGeom {
  int w, h, hw, kc;         // kc survivors side by side
  int hwp;                  // a plane's stride (odd)
  int pool;                 // REFS: the pool's LPAD (else 0)
  int per_warp;             // ints of shared memory per warp
  int warps;                // warps (candidates) per block
};

// lpad: the reference pool's segment length for vt_plan_trial_refs (each
// warp then holds 4 x lpad pool ints and the DC value), 0 for
// vt_plan_trial
WarpGeom warp_geom(int w, int h, int lpad) {
  WarpGeom q;
  q.w = w;
  q.h = h;
  q.hw = w * h;
  q.kc = q.hw >= 32 ? 1 : 32 / q.hw;
  q.hwp = q.hw | 1;
  q.pool = lpad;
  // src, kc x (pred, a, b), the pass's modes, the pool and the DC value
  q.per_warp = q.hwp * (1 + 3 * q.kc) + 4 * q.kc + (lpad ? 4 * lpad + 1 : 0);
  const int budget = 40 * 1024 / 4;                  // ints for the warps
  q.warps = budget / q.per_warp;
  q.warps = q.warps < 1 ? 1 : (q.warps > 8 ? 8 : q.warps);
  return q;
}

size_t warp_smem(const WarpGeom& q) {
  // matrices tw, tw^T, th, th^T, then the warps' planes
  return (size_t)(2 * q.w * q.w + 2 * q.h * q.h + q.warps * q.per_warp) * 4;
}

template <bool REFS>
__global__ void __launch_bounds__(kWarpThreads) plan_trial_warp_kernel(
    const Inputs in, const TrialParams p, const WarpGeom q) {
  extern __shared__ int wsm[];
  const int w = q.w, h = q.h, hw = q.hw;
  int* s_tw = wsm;                  // [u][x]
  int* s_twT = s_tw + w * w;        // [x][u]
  int* s_th = s_twT + w * w;        // [v][y]
  int* s_thT = s_th + h * h;        // [y][v]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < w * w; i += blockDim.x) {
    s_tw[i] = in.tw[i];
    s_twT[(i % w) * w + i / w] = in.tw[i];
  }
  for (int i = threadIdx.x; i < h * h; i += blockDim.x) {
    s_th[i] = in.th[i];
    s_thT[(i % h) * h + i / h] = in.th[i];
  }
  __syncthreads();
  const int b = blockIdx.x * q.warps + warp;
  if (warp >= q.warps || b >= in.B) return;
  int* base = s_thT + h * h + warp * q.per_warp;
  int* s_src = base;
  int* s_top = base + q.hwp * (1 + 3 * q.kc);        // [kc] modes of a pass
  int* s_pool = s_top + 4 * q.kc;                    // REFS: [4][LPAD], DC
  for (int j = lane; j < hw; j += 32) s_src[j] = in.src[(size_t)b * hw + j];
  if constexpr (REFS) {
    const int L = q.pool;
    intra_pred::pool_load(in.tops + (size_t)b * in.Lt,
                          in.lefts + (size_t)b * in.Ll, s_pool, L, lane, 32);
    __syncwarp();
    intra_pred::pool_filter(s_pool, L, w, h, lane, 32);
    if (lane == 0) s_pool[4 * L] = intra_pred::pool_dc(s_pool, L, w, h);
    __syncwarp();
  }
  // the ranking (into the per-warp list in turns of kc survivors)
  __shared__ int s_rank[8][kModes];
  rank_modes(in, p, b, s_rank[warp]);
  __syncwarp();
  const float lm = in.lmbda[b];
  const bool zero_out = w > 32 || h > 32;
  const int items = q.kc * hw;                        // (survivor, sample)
  const int group = hw < 32 ? hw : 32;                // lanes of a survivor
  for (int i0 = 0; i0 < p.k; i0 += q.kc) {
    const int live = min(q.kc, p.k - i0);
    if (lane < live) s_top[lane] = s_rank[warp][i0 + lane];
    __syncwarp();
    for (int j = lane; j < live * hw; j += 32) {
      const int si = j / hw, jj = j - si * hw;
      if constexpr (REFS)
        base[q.hwp * (1 + 3 * si) + jj] = intra_pred::pred_sample(
            s_pool, s_pool[4 * q.pool], in.pt, w, h, in.bit_depth,
            s_top[si], jj / w, jj - (jj / w) * w);
      else
        base[q.hwp * (1 + 3 * si) + jj] =
            in.preds[((size_t)b * p.M + s_top[si]) * hw + jj];
    }
    __syncwarp();
    // forward rows: a[y][u] = sum_x r[y][x] tw[u][x]
    for (int j = lane; j < items; j += 32) {
      const int si = j / hw, jj = j - si * hw;
      if (si >= live) continue;
      const int y = jj / w, u = jj - y * w;
      int* pl = base + q.hwp * (1 + 3 * si);
      int acc = 0;
      for (int x = 0; x < w; ++x)
        acc += (s_src[y * w + x] - pl[y * w + x]) * s_twT[x * w + u];
      pl[q.hwp + jj] = clampi(round_shift(acc, p.shift1), kCoeffMin,
                              kCoeffMax);
    }
    __syncwarp();
    // forward columns, quantise / dequantise
    int nnz = 0;
    float slog = 0.f;
    for (int j = lane; j < items; j += 32) {
      const int si = j / hw, jj = j - si * hw;
      if (si >= live) continue;
      const int v = jj / w, u = jj - v * w;
      int* pl = base + q.hwp * (1 + 3 * si);
      int c = 0;
      if (!zero_out || (u < 32 && v < 32)) {
        int acc = 0;
        for (int y = 0; y < h; ++y) acc += s_thT[y * h + v] * pl[q.hwp + y * w + u];
        c = clampi(round_shift(acc, p.shift2), kCoeffMin, kCoeffMax);
      }
      pl[2 * q.hwp + jj] = quant_dequant(p, c, nnz, slog);
    }
    __syncwarp();
    // inverse columns: a[y][u] = sum_v th[v][y] d[v][u]
    for (int j = lane; j < items; j += 32) {
      const int si = j / hw, jj = j - si * hw;
      if (si >= live) continue;
      const int y = jj / w, u = jj - y * w;
      int* pl = base + q.hwp * (1 + 3 * si);
      int acc = 0;
      for (int v = 0; v < h; ++v) acc += s_th[v * h + y] * pl[2 * q.hwp + v * w + u];
      pl[q.hwp + jj] = clampi(round_shift(acc, 7), kCoeffMin, kCoeffMax);
    }
    __syncwarp();
    // inverse rows: r[y][x] = sum_u a[y][u] tw[u][x]; recon and SSE
    long long sse = 0;
    for (int j = lane; j < items; j += 32) {
      const int si = j / hw, jj = j - si * hw;
      if (si >= live) continue;
      const int y = jj / w, x = jj - y * w;
      const int* pl = base + q.hwp * (1 + 3 * si);
      int acc = 0;
      for (int u = 0; u < w; ++u) acc += pl[q.hwp + y * w + u] * s_tw[u * w + x];
      const int r = clampi(round_shift(acc, p.ishift2), kCoeffMin, kCoeffMax);
      const int rec = clampi(pl[jj] + r, 0, p.maxval);
      const int er = s_src[jj] - rec;
      sse += (long long)er * er;
    }
    // the sums of each survivor's lanes (a lane holds one survivor)
    sse = warp_sum(sse, group);
    nnz = warp_sum(nnz, group);
    slog = warp_sum(slog, group);
    const int si = lane / group;
    if (lane % group == 0 && si < live) {
      const int mode = s_top[si];
      in.modes[(size_t)b * p.k + i0 + si] = mode;
      in.costs[(size_t)b * p.k + i0 + si] =
          trial_cost(p, sse, nnz, slog, lm, in.mode_bits[mode]);
    }
    __syncwarp();
  }
}

enum Route { kWarp = 0, kTc16 = 16, kTc32 = 32, kTc64 = 64 };

Route route_for(int w, int h) {
  if (w == h && (w == 16 || w == 32 || w == 64)) return (Route)w;
  return kWarp;
}

// the kernel, its shared memory and threads for a (w, h) class; lpad: the
// reference pool's segment length of vt_plan_trial_refs (0 for
// vt_plan_trial)
struct Launch {
  const void* f;
  size_t shm;
  int threads;
  WarpGeom q;
};

Launch launch_for(int w, int h, int lpad) {
  const bool refs = lpad > 0;
  Launch l;
  l.q = warp_geom(w, h, lpad);
  switch (route_for(w, h)) {
    case kTc16:
      l.f = refs ? (const void*)plan_trial_tc_kernel<16, true>
                 : (const void*)plan_trial_tc_kernel<16, false>;
      l.shm = tc_smem<16>(refs);
      l.threads = TcGeom<16>::THREADS;
      break;
    case kTc32:
      l.f = refs ? (const void*)plan_trial_tc_kernel<32, true>
                 : (const void*)plan_trial_tc_kernel<32, false>;
      l.shm = tc_smem<32>(refs);
      l.threads = TcGeom<32>::THREADS;
      break;
    case kTc64:
      l.f = refs ? (const void*)plan_trial_tc_kernel<64, true>
                 : (const void*)plan_trial_tc_kernel<64, false>;
      l.shm = tc_smem<64>(refs);
      l.threads = TcGeom<64>::THREADS;
      break;
    default:
      l.f = refs ? (const void*)plan_trial_warp_kernel<true>
                 : (const void*)plan_trial_warp_kernel<false>;
      l.shm = warp_smem(l.q);
      l.threads = kWarpThreads;
  }
  return l;
}

int launch(const Inputs& in, const TrialParams& p, int lpad, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (p.k < 1 || p.k > p.M || p.M > kModes || in.B < 1)
    return (int)cudaErrorInvalidValue;
  const Launch l = launch_for(p.w, p.h, lpad);
  cudaError_t e = cudaFuncSetAttribute(
      l.f, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.shm);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const int B = in.B;
  const bool refs = lpad > 0;
  switch (route_for(p.w, p.h)) {
    case kTc16:
      if (refs)
        plan_trial_tc_kernel<16, true><<<B, l.threads, l.shm, st>>>(in, p);
      else
        plan_trial_tc_kernel<16, false><<<B, l.threads, l.shm, st>>>(in, p);
      break;
    case kTc32:
      if (refs)
        plan_trial_tc_kernel<32, true><<<B, l.threads, l.shm, st>>>(in, p);
      else
        plan_trial_tc_kernel<32, false><<<B, l.threads, l.shm, st>>>(in, p);
      break;
    case kTc64:
      if (refs)
        plan_trial_tc_kernel<64, true><<<B, l.threads, l.shm, st>>>(in, p);
      else
        plan_trial_tc_kernel<64, false><<<B, l.threads, l.shm, st>>>(in, p);
      break;
    default: {
      const int grid = (B + l.q.warps - 1) / l.q.warps;
      if (refs)
        plan_trial_warp_kernel<true><<<grid, l.threads, l.shm, st>>>(in, p,
                                                                     l.q);
      else
        plan_trial_warp_kernel<false><<<grid, l.threads, l.shm, st>>>(in, p,
                                                                      l.q);
    }
  }
  return (int)cudaGetLastError();
}

int attrs(int w, int h, int lpad, int* out) {
  const Launch l = launch_for(w, h, lpad);
  cudaError_t e = cudaFuncSetAttribute(
      l.f, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.shm);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, l.f);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, l.f, l.threads,
                                                    l.shm);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)l.shm;
  out[3] = l.threads;
  out[4] = blocks;
  out[5] = (int)a.localSizeBytes;
  return 0;
}

}  // namespace

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// src [B, h, w] int32, preds [B, M, h, w] int16, satd [B, M] int32,
// lmbda / lmbda_sad [B] f32, mode_bits [67] f32, tw [w, w] / th [h, h]
// int32 transform matrices of the row / column type -> modes [B, k] int32,
// costs [B, k] f32.  Returns cudaGetLastError() after the launch.
extern "C" int vt_plan_trial(
    const void* src, const void* preds, const void* satd, const void* lmbda,
    const void* lmbda_sad, const void* mode_bits, const void* tw,
    const void* th, void* modes, void* costs, int B, int M, int w, int h,
    int k, int shift1, int shift2, int ishift2, int qbits, int qscale,
    int qadd, int dshift, int dscale, int maxval, float c0, float c1,
    float c2, void* stream) {
  const TrialParams p{w, h, k, M, shift1, shift2, ishift2, qbits, qscale,
                      qadd, dshift, dscale, maxval, c0, c1, c2};
  Inputs in = {};
  in.src = (const int*)src;
  in.preds = (const int16_t*)preds;
  in.satd = (const int*)satd;
  in.lmbda = (const float*)lmbda;
  in.lmbda_sad = (const float*)lmbda_sad;
  in.mode_bits = (const float*)mode_bits;
  in.tw = (const int*)tw;
  in.th = (const int*)th;
  in.modes = (int*)modes;
  in.costs = (float*)costs;
  in.B = B;
  return launch(in, p, 0, stream);
}

// The same with the candidates' references in place of the predictions:
// tops [B, Lt] / lefts [B, Ll] int32 (Lt, Ll >= LPAD); the survivors are
// predicted at bit depth bit_depth from K1's tables of the class
// (ops/tables.device_tables(w, h): rm_flat, row_start, filt, mode_info,
// pdpc_wl, side_flat, LPAD, LR, TM, B0).  Returns cudaGetLastError()
// after the launch.
extern "C" int vt_plan_trial_refs(
    const void* src, const void* tops, int Lt, const void* lefts, int Ll,
    const void* satd, const void* lmbda, const void* lmbda_sad,
    const void* mode_bits, const void* tw, const void* th, void* modes,
    void* costs, int B, int M, int w, int h, int k, int shift1, int shift2,
    int ishift2, int qbits, int qscale, int qadd, int dshift, int dscale,
    int maxval, float c0, float c1, float c2, int bit_depth,
    const void* rm_flat, const void* row_start, const void* filt,
    const void* mode_info, const void* pdpc_wl, const void* side_flat,
    int LPAD, int LR, int TM, int B0, void* stream) {
  if (LPAD < 1 || Lt < LPAD || Ll < LPAD) return (int)cudaErrorInvalidValue;
  const TrialParams p{w, h, k, M, shift1, shift2, ishift2, qbits, qscale,
                      qadd, dshift, dscale, maxval, c0, c1, c2};
  Inputs in = {};
  in.src = (const int*)src;
  in.tops = (const int*)tops;
  in.lefts = (const int*)lefts;
  in.Lt = Lt;
  in.Ll = Ll;
  in.bit_depth = bit_depth;
  in.pt = intra_pred::Tables{(const int*)rm_flat, (const int*)row_start,
                             (const int*)filt, (const int*)mode_info,
                             (const int*)pdpc_wl, (const int*)side_flat,
                             LPAD, LR, TM, B0};
  in.satd = (const int*)satd;
  in.lmbda = (const float*)lmbda;
  in.lmbda_sad = (const float*)lmbda_sad;
  in.mode_bits = (const float*)mode_bits;
  in.tw = (const int*)tw;
  in.th = (const int*)th;
  in.modes = (int*)modes;
  in.costs = (float*)costs;
  in.B = B;
  return launch(in, p, LPAD, stream);
}

// the resources of the kernel a (w, h) class launches: out = registers
// per thread, static and dynamic shared memory bytes, threads per block,
// resident blocks per SM, local memory bytes per thread.
extern "C" int vt_plan_trial_attrs(int w, int h, int* out) {
  return attrs(w, h, 0, out);
}

// the same for vt_plan_trial_refs (the class's pool: LPAD =
// max(2w, 2h) + 3)
extern "C" int vt_plan_trial_refs_attrs(int w, int h, int* out) {
  return attrs(w, h, 2 * (w > h ? w : h) + 3, out);
}

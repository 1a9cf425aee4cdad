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
// of SATD, s * s * 4 of source, 2 (2s + 3) * 4 of references (the
// reference entry) or k * s * s * 2 of predictions (the preds form) read.
// As split int8 products on the tensor cores (16 s^3 int8 operations a
// survivor at 1,979 T/s) every class is bound by the bytes it reads, 4x4
// and 8x8 even at the int32 rate of the CUDA cores.  What holds the
// kernels from that bound is not the bytes: warm and cold times agree.
// It is the instructions a candidate issues (the survivors' predictions,
// the products' epilogues, log2f) and the latency of its chain of
// dependent steps.
//
// Design:
// - vt_plan_trial_refs on the square classes, and vt_plan_trial at 4x4
//   and 8x8, run persistent blocks: the grid is the occupancy query's
//   resident blocks an SM times the SMs (asked once per kernel, k and
//   device, the shared-memory attribute set once), and a block walks its
//   units blockIdx.x, + gridDim.x, ...; the transform matrices are staged
//   once a block, and the next unit's SATD rows, references, lambdas and
//   (except at 64x64, where a second source would cost a resident block)
//   sources are in flight by cp.async into a double buffer while the
//   current one runs;
// - 4x4 and 8x8: a unit is NC = 256 / (2 s) candidates (32, 16); each
//   group of 2 s lanes ranks a candidate (every lane scores its modes
//   once, then k scans for the least (score, mode) key above the last one
//   taken, the group's least by a segmented butterfly); then a thread
//   takes one line of one of KC = 2 survivors of one candidate: the
//   prediction's main row as one run (intra_pred.cuh pred_run: a row's
//   taps and s + 3 reference values read once; the preds form reads K1's
//   row), then a row or a column of each product on the CUDA cores from
//   planes of odd row stride, the survivor's s lanes ordered by
//   __syncwarp only, its sums by a segmented butterfly;
// - 16x16, 32x32, 64x64 (the reference entry): a unit is one candidate;
//   warp 0 ranks (a warp argmin, three modes a lane) while the other
//   warps filter the pool and warp 1 sums DC; SV survivors at a time (two
//   at 16x16, whose products give two warps a tile each: four warps then
//   have tiles and a candidate takes half the barriers), runs of 4 samples
//   along the main rows, the four products on the tensor cores
//   (mma.sync m16n8k32, int8 in, int32 accumulators).  The transform
//   matrices (|T| <= 91) are s8.  The data operand of each product (the
//   residual, |r| < 2^bd; the clipped stage results and dequantised
//   levels, in [-2^15, 2^15)) is split into a signed high byte and an
//   unsigned low byte, x = 256 * hi + lo, and the two products
//   recombined in int32: 256 * sum(T * hi) + sum(T * lo) is sum(T * x)
//   exactly, every partial sum inside int32 (|256 * sum(T * hi)| <= 256 *
//   64 * 91 * 128 = 1.9e8); tests/test_torch_exact_split.py holds this
//   against int64 products at the extremes.  Operands live in shared
//   memory as byte planes with the contraction index contiguous and a row
//   stride of 4 (mod 8) words, so every fragment load is conflict-free.
//   The first, third and fourth products are oriented so that their
//   epilogues write the next operand as adjacent pairs (one 16-bit store
//   a plane): a^T[u][y] = tw r^T, a2[y][u] = th^T d^T, r[y][x] = a2 tw;
//   the second, c[v][u] = th a, keeps plan_trial_tc_kernel's orientation,
//   tiles and warps, so that its log2 sums, and the costs, equal
//   vt_plan_trial's on K1's predictions.  At 64x64 the second product computes only the 32 x 32
//   coefficients the zero-out keeps, and the third and fourth contract
//   over those 32 alone (the rest is 0); the bound above counts the full
//   products.  vt_plan_trial keeps plan_trial_tc_kernel there (a block a
//   candidate, the next survivor's prediction in flight by cp.async);
// - the log2 of a zero level is skipped (log2(1 + 0) adds 0).
// Not built: a producer warp ranking and predicting the next candidate
// behind named barriers (the prediction costs about what the products
// do, so a producer would hold a block's warps as long as the consumers;
// other resident blocks fill the barriers' gaps instead); packing several
// candidates into one product along n (at 16x16 two survivors share a
// block instead: the same tiles a warp, without mixing candidates in a
// fragment); TMA bulk copies (a unit's inputs are a few hundred bytes to
// 16 KB of rows at any alignment; cp.async of 4 and 16 bytes carries
// them); the int8 tensor cores at 4x4 and 8x8 (a 4- or 8-point
// contraction fills an eighth or a quarter of a k32 fragment).
//
// Two entries share this file.  vt_plan_trial reads the k survivors'
// predictions from K1's [B, 67, h, w] output.  vt_plan_trial_refs takes
// the candidates' reference rows (tops / lefts, int32 [B, >= LPAD])
// instead: each candidate's reference pool (4 x LPAD ints) is staged and
// filtered in shared memory and, after the ranking, only its k survivors
// are predicted there with K1's own per-sample arithmetic
// (intra_pred.cuh), so the planning path never writes the 67 predictions
// to device memory.  The SATD it ranks by then comes from K4's gathered
// entry (presel_costs.cu), which fuses K1 and K2.  vt_plan_trial_refs_p
// takes the class's constants as one parameter block, built once by the
// wrapper.  The rectangular classes of both entries (no encoder path
// plans them) keep the warp route: one warp per candidate, eight
// to a block, the products on the CUDA cores.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

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

// the k lowest (score, mode) keys of one candidate by its warp, from its
// SATD row: scores satd + mode_bits * lambda_sad (f32, that order), ties
// to the lowest mode; top[0..k) in shared memory
__device__ void rank_modes(const int* satd, const float* mode_bits,
                           float lsad, int M, int k, int* top) {
  const int lane = threadIdx.x & 31;
  float sc[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int m = lane + 32 * j;
    sc[j] = m < M ? __fadd_rn((float)satd[m], __fmul_rn(mode_bits[m], lsad))
                  : INFINITY;
  }
  unsigned taken = 0;
  for (int i = 0; i < k; ++i) {
    float bs = INFINITY;
    int bm = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int m = lane + 32 * j;
      if (m < M && !((taken >> j) & 1u) &&
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

// the same keys by an aligned group of W lanes (a power of two up to 32)
// of one candidate: each lane scores its modes sub, sub + W, ... once,
// into registers, then k scans, each lane's least key above the last one
// taken and the group's least by a segmented butterfly; every lane of
// the warp calls it (the same k), lane sub 0 of a group writes top[0..k)
template <int W>
__device__ void rank_group(const int* satd, const float* mode_bits,
                           float lsad, int M, int k, int* top, int sub) {
  constexpr int NPL = (kModes + W - 1) / W;          // modes a lane
  float sc[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int m = sub + j * W;
    sc[j] = m < M ? __fadd_rn((float)satd[m], __fmul_rn(mode_bits[m], lsad))
                  : INFINITY;
  }
  float ls = -INFINITY;
  int lm = -1;
  for (int i = 0; i < k; ++i) {
    float bs = INFINITY;
    int bm = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int m = sub + j * W;
      if (m < M && (sc[j] > ls || (sc[j] == ls && m > lm)) &&
          (sc[j] < bs || (sc[j] == bs && m < bm))) {
        bs = sc[j];
        bm = m;
      }
    }
#pragma unroll
    for (int o = W >> 1; o > 0; o >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bs, o);
      const int om = __shfl_xor_sync(0xffffffffu, bm, o);
      if (os < bs || (os == bs && om < bm)) {
        bs = os;
        bm = om;
      }
    }
    if (sub == 0) top[i] = bm;
    ls = bs;
    lm = bm;
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
  if (mag != 0) slog = __fadd_rn(slog, log2f(__fadd_rn(1.0f, (float)mag)));
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

// vt_plan_trial's tensor-core route: a block a candidate, the
// survivors' predictions from K1's output, the next one in flight
template <int S>
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
  __shared__ int s_top[kModes];
  __shared__ long long s_sse[NW];
  __shared__ int s_nnz[NW];
  __shared__ float s_slog[NW];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  if (warp == 0)
    rank_modes(in.satd + (size_t)b * p.M, in.mode_bits, in.lmbda_sad[b], p.M,
               p.k, s_top);
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
  __syncthreads();
  auto fetch_pred = [&](int i) {
    const int16_t* pb = in.preds + ((size_t)b * p.M + s_top[i]) * S * S;
    int16_t* dst = s_pred + (i & 1) * S * S;
    for (int j = tid; j < S * S / 8; j += G::THREADS)
      cp_async16(dst + 8 * j, pb + 8 * j);
    cp_async_commit();
  };
  fetch_pred(0);
  const float lm = in.lmbda[b];
  const bool zero_out = S > 32;
  for (int i = 0; i < p.k; ++i) {
    if (i + 1 < p.k) {
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
size_t tc_smem() {
  using G = TcGeom<S>;
  return (size_t)8 * G::PLANE * 4 + (size_t)S * S * 4 + (size_t)2 * S * S * 2;
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
  rank_modes(in.satd + (size_t)b * p.M, in.mode_bits, in.lmbda_sad[b], p.M,
             p.k, s_rank[warp]);
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

// ---------------------------------------------------------------------
// vt_plan_trial_refs on the square classes: persistent blocks
// ---------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// x0, x1 (in [-2^15, 2^15)) at (row r, contraction index kk, kk + 1) of a
// split byte plane pair, kk even: one 16-bit store a plane
template <int RW>
__device__ __forceinline__ void put_split2(uint32_t* hi, uint32_t* lo, int r,
                                           int kk, int x0, int x1) {
  const int o = r * RW * 4 + kk;
  *reinterpret_cast<uint16_t*>(reinterpret_cast<uint8_t*>(hi) + o) =
      (uint16_t)__byte_perm(x0, x1, 0x0051);
  *reinterpret_cast<uint16_t*>(reinterpret_cast<uint8_t*>(lo) + o) =
      (uint16_t)__byte_perm(x0, x1, 0x0040);
}

__device__ __forceinline__ int clip_coeff(int v) {
  return clampi(v, kCoeffMin, kCoeffMax);
}

// vt_plan_trial_refs at 16x16 .. 64x64: a block walks candidates
// blockIdx.x, + gridDim.x, ...; SV survivors at a time (two at 16x16,
// where one survivor's products give two warps a tile each), WPS warps a
// survivor; registers capped for MIN_BLOCKS resident blocks an SM
template <int S>
struct TcSquare {
  using G = TcGeom<S>;
  static constexpr int SV = S == 16 ? 2 : 1;
  static constexpr int WPS = G::THREADS / 32;
  static constexpr int THREADS = SV * G::THREADS;
  static constexpr int MIN_BLOCKS = S == 16 ? 12 : (S == 32 ? 6 : 3);
  static constexpr int L = 2 * S + 3;               // LPAD of the class
  static constexpr int POOL = (4 * L + 3) & ~3;     // ints, 16-byte rows
  // a candidate's small inputs: SATD row (68 ints), pool, lambdas (4)
  static constexpr int O_POOL = 68, O_LM = O_POOL + POOL;
  static constexpr int SMALL = O_LM + 4;
  // the sources in flight: two at 16 and 32; at 64 one (3 blocks an SM)
  static constexpr int SRC_BUFS = S == 64 ? 1 : 2;
  // 4 matrix planes, 4 data planes a survivor, two candidates' small
  // inputs, the sources, the survivors' predictions, the modes
  static size_t smem() {
    return (size_t)(4 + 4 * SV) * G::PLANE * 4 +
           (size_t)(2 * SMALL + SRC_BUFS * S * S) * 4 +
           (size_t)SV * S * S * 2 + (size_t)68 * 4;
  }
};

// a candidate's SATD row, raw references (in the pool layout [top | - |
// left | -]) and lambdas into dst, by threads tid, + nt, ...
template <int S>
__device__ __forceinline__ void tc_stage_small(const Inputs& in,
                                               const TrialParams& p, int b,
                                               int* dst, int tid, int nt) {
  using R = TcSquare<S>;
  constexpr int L = R::L;
  const int* sr = in.satd + (size_t)b * p.M;
  for (int j = tid; j < p.M; j += nt) cp_async4(dst + j, sr + j);
  const int* tp = in.tops + (size_t)b * in.Lt;
  const int* lp = in.lefts + (size_t)b * in.Ll;
  for (int j = tid; j < L; j += nt) {
    cp_async4(dst + R::O_POOL + j, tp + j);
    cp_async4(dst + R::O_POOL + 2 * L + j, lp + j);
  }
  if (tid == 0) {
    cp_async4(dst + R::O_LM, in.lmbda + b);
    cp_async4(dst + R::O_LM + 1, in.lmbda_sad + b);
  }
}

// a candidate's source block into dst (16-byte copies where the input is
// 16-byte aligned)
template <int S>
__device__ __forceinline__ void tc_stage_src(const Inputs& in, int b,
                                             int* dst, bool src16, int tid,
                                             int nt) {
  const int* sp = in.src + (size_t)b * S * S;
  if (src16)
    for (int j = tid; j < S * S / 4; j += nt)
      cp_async16(dst + 4 * j, sp + 4 * j);
  else
    for (int j = tid; j < S * S; j += nt) cp_async4(dst + j, sp + j);
}

template <int S>
__global__ void __launch_bounds__(TcSquare<S>::THREADS,
                                  TcSquare<S>::MIN_BLOCKS)
    plan_refs_tc_kernel(const Inputs in, const TrialParams p) {
  using G = TcGeom<S>;
  using R = TcSquare<S>;
  constexpr int NT = R::THREADS, NW = NT / 32, L = R::L;
  constexpr int SV = R::SV, WPS = R::WPS, PL = G::PLANE;
  // products 3 and 4 at 64 contract over the coefficients the zero-out
  // keeps
  constexpr int S32 = S > 32 ? 32 : S;
  constexpr int KP3 = S > 32 ? 32 : G::KP;
  extern __shared__ __align__(16) uint32_t sm[];
  // matrix planes (s8): tw [u][x], th [v][y], th^T [y][v], tw^T [x][u]
  uint32_t* m_tw = sm;
  uint32_t* m_th = m_tw + PL;
  uint32_t* m_thT = m_th + PL;
  uint32_t* m_twT = m_thT + PL;
  // each survivor's data planes, x_hi, x_lo, y_hi, y_lo, the split pairs
  // its products use in turn
  uint32_t* planes = m_twT + PL;
  int* s_small = reinterpret_cast<int*>(planes + 4 * SV * PL);  // [2]
  int* s_srcs = s_small + 2 * R::SMALL;                 // [SRC_BUFS][S*S]
  int16_t* s_preds =
      reinterpret_cast<int16_t*>(s_srcs + R::SRC_BUFS * S * S);  // [SV]
  int* s_top = reinterpret_cast<int*>(s_preds + SV * S * S);     // [k]
  __shared__ float s_mb[kModes];
  __shared__ int s_dc;
  __shared__ long long s_sse[NW];
  __shared__ int s_nnz[NW];
  __shared__ float s_slog[NW];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // this warp's survivor slot, and its rank among the slot's warps
  const int sv = warp / WPS, ws = warp % WPS;
  uint32_t* x_hi = planes + 4 * sv * PL;
  uint32_t* x_lo = x_hi + PL;
  uint32_t* y_hi = x_lo + PL;
  uint32_t* y_lo = y_hi + PL;
  const int16_t* pred = s_preds + sv * S * S;
  const bool src16 = (reinterpret_cast<uintptr_t>(in.src) & 15) == 0;
  // once a block: the planes zeroed (the contraction padding at 16 stays
  // 0), the matrices as s8, the mode bits
  for (int i = tid; i < (4 + 4 * SV) * PL; i += NT) sm[i] = 0;
  for (int i = tid; i < kModes; i += NT) s_mb[i] = in.mode_bits[i];
  __syncthreads();
  for (int i = tid; i < S * S; i += NT) {
    const int r = i / S, c = i - r * S;
    const int8_t tw = (int8_t)in.tw[i], th = (int8_t)in.th[i];
    reinterpret_cast<int8_t*>(m_tw)[r * G::RW * 4 + c] = tw;    // tw[u][x]
    reinterpret_cast<int8_t*>(m_twT)[c * G::RW * 4 + r] = tw;   // tw[x][u]
    reinterpret_cast<int8_t*>(m_th)[r * G::RW * 4 + c] = th;    // th[v][y]
    reinterpret_cast<int8_t*>(m_thT)[c * G::RW * 4 + r] = th;   // th[y][v]
  }
  int b = blockIdx.x;
  if (b < in.B) {
    tc_stage_small<S>(in, p, b, s_small, tid, NT);
    if (R::SRC_BUFS == 2) tc_stage_src<S>(in, b, s_srcs, src16, tid, NT);
  }
  cp_async_commit();
  for (int it = 0; b < in.B; ++it, b += gridDim.x) {
    int* cur = s_small + (it & 1) * R::SMALL;
    const int* src = s_srcs + (R::SRC_BUFS == 2 ? (it & 1) * S * S : 0);
    const int nb = b + gridDim.x;
    __syncthreads();               // the last candidate's reads are done
    if (R::SRC_BUFS == 1) {
      tc_stage_src<S>(in, b, s_srcs, src16, tid, NT);
      cp_async_commit();
    }
    if (nb < in.B) {
      tc_stage_small<S>(in, p, nb, s_small + ((it + 1) & 1) * R::SMALL, tid,
                        NT);
      if (R::SRC_BUFS == 2)
        tc_stage_src<S>(in, nb, s_srcs + ((it + 1) & 1) * S * S, src16, tid,
                        NT);
    }
    cp_async_commit();
    cp_async_wait_all_but_one();   // all but the next candidate's copies
    __syncthreads();
    int* pool = cur + R::O_POOL;
    const float lm = __int_as_float(cur[R::O_LM]);
    // warp 0 ranks; the others filter the pool, warp 1 sums DC
    if (warp == 0) {
      rank_modes(cur, s_mb, __int_as_float(cur[R::O_LM + 1]), p.M, p.k,
                 s_top);
    } else {
      intra_pred::pool_filter(pool, L, S, S, tid - 32, NT - 32);
      if (warp == 1) {
        const int dc = intra_pred::pool_dc_warp(pool, L, S, S, lane);
        if (lane == 0) s_dc = dc;
      }
    }
    __syncthreads();
    for (int i0 = 0; i0 < p.k; i0 += SV) {
      const int nsv = p.k - i0 < SV ? p.k - i0 : SV;   // survivors now
      // the survivors' predictions, runs of 4 along their main rows, and
      // residuals, split, as B of the first product: [y][x]
      {
        for (int j = tid; j < nsv * S * S / 4; j += NT) {
          const int q0 = j / (S * S / 4), jj = j - q0 * (S * S / 4);
          const int row = jj / (S / 4), col0 = (jj % (S / 4)) * 4;
          int16_t* pq = s_preds + q0 * S * S;
          uint32_t* qhi = planes + 4 * q0 * PL;
          int v[4];
          const bool ver = intra_pred::pred_run<4>(
              pool, s_dc, in.pt, S, S, in.bit_depth, s_top[i0 + q0], row,
              col0, v);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int y = ver ? row : col0 + q, x = ver ? col0 + q : row;
            pq[y * S + x] = (int16_t)v[q];
            put_split<G::RW>(qhi, qhi + PL, y, x, src[y * S + x] - v[q]);
          }
        }
      }
      __syncthreads();
      const bool live = sv < nsv;
      // forward rows: a^T[u][y] = sum_x tw[u][x] r[y][x] -> y planes [u][y]
      for (int tt = ws; live && tt < G::TILES; tt += WPS) {
        const int m0 = (tt / G::NT) * 16, n0 = (tt % G::NT) * 8;
        int c[4];
        tile_product<G::KP, G::RW, false>(m_tw, nullptr, x_hi, x_lo, m0, n0,
                                          c);
        const int u = m0 + g, y = n0 + 2 * t4;
        put_split2<G::RW>(y_hi, y_lo, u, y,
                          clip_coeff(round_shift(c[0], p.shift1)),
                          clip_coeff(round_shift(c[1], p.shift1)));
        put_split2<G::RW>(y_hi, y_lo, u + 8, y,
                          clip_coeff(round_shift(c[2], p.shift1)),
                          clip_coeff(round_shift(c[3], p.shift1)));
      }
      __syncthreads();
      // forward columns: c[v][u] = sum_y th[v][y] a^T[u][y]; quantise and
      // dequantise -> x planes [u][v], at 64 only the tiles of v, u < 32
      // (the rest is zeroed out, and never read).  The tiles, their warps
      // and their elements in the order of vt_plan_trial's kernel, so
      // that the log2 sums and costs of the two entries are equal
      int nnz = 0;
      float slog = 0.f;
      for (int tt = ws; live && tt < G::TILES; tt += WPS) {
        const int m0 = (tt / G::NT) * 16, n0 = (tt % G::NT) * 8;
        if (S > 32 && (m0 >= 32 || n0 >= 32)) continue;
        int c[4];
        tile_product<G::KP, G::RW, false>(m_th, nullptr, y_hi, y_lo, m0, n0,
                                          c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int v = m0 + g + 8 * (e >> 1), u = n0 + 2 * t4 + (e & 1);
          put_split<G::RW>(
              x_hi, x_lo, u, v,
              quant_dequant(p, clip_coeff(round_shift(c[e], p.shift2)), nnz,
                            slog));
        }
      }
      __syncthreads();
      // inverse columns: a2[y][u] = sum_v th^T[y][v] d[u][v] -> y planes
      // [y][u] (u < 32 at 64)
      for (int tt = ws; live && tt < (S / 16) * (S32 / 8); tt += WPS) {
        const int m0 = (tt / (S32 / 8)) * 16, n0 = (tt % (S32 / 8)) * 8;
        int c[4];
        tile_product<KP3, G::RW, false>(m_thT, nullptr, x_hi, x_lo, m0, n0,
                                        c);
        const int y = m0 + g, u = n0 + 2 * t4;
        put_split2<G::RW>(y_hi, y_lo, y, u, clip_coeff(round_shift(c[0], 7)),
                          clip_coeff(round_shift(c[1], 7)));
        put_split2<G::RW>(y_hi, y_lo, y + 8, u,
                          clip_coeff(round_shift(c[2], 7)),
                          clip_coeff(round_shift(c[3], 7)));
      }
      __syncthreads();
      // inverse rows: r[y][x] = sum_u a2[y][u] tw^T[x][u]; recon and SSE
      long long sse = 0;
      for (int tt = ws; live && tt < G::TILES; tt += WPS) {
        const int m0 = (tt / G::NT) * 16, n0 = (tt % G::NT) * 8;
        int c[4];
        tile_product<KP3, G::RW, true>(y_hi, y_lo, m_twT, nullptr, m0, n0,
                                       c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int y = m0 + g + 8 * (e >> 1), x = n0 + 2 * t4 + (e & 1);
          const int r = clip_coeff(round_shift(c[e], p.ishift2));
          const int rec = clampi((int)pred[y * S + x] + r, 0, p.maxval);
          const int er = src[y * S + x] - rec;
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
      // the first thread of each live slot: its warps' sums in order
      if (live && ws == 0 && lane == 0) {
        long long sse_t = 0;
        int nnz_t = 0;
        float slog_t = 0.f;
        for (int q = warp; q < warp + WPS; ++q) {
          sse_t += s_sse[q];
          nnz_t += s_nnz[q];
          slog_t = __fadd_rn(slog_t, s_slog[q]);
        }
        const int mode = s_top[i0 + sv];
        in.modes[(size_t)b * p.k + i0 + sv] = mode;
        in.costs[(size_t)b * p.k + i0 + sv] =
            trial_cost(p, sse_t, nnz_t, slog_t, lm, s_mb[mode]);
      }
      // the planes, the predictions and the sums are written again only
      // behind the next pass's first barrier
    }
  }
}

// 4x4 and 8x8: a block walks tiles of NC candidates; a thread takes one
// line (a row or a column) of one of KC survivors of one candidate, the
// four products on the CUDA cores; registers capped for four resident
// blocks an SM, which the shared memory allows
template <int S>
struct SmallSquare {
  static constexpr int THREADS = 256;
  static constexpr int KC = 2;                       // survivors a pass
  static constexpr int NC = THREADS / (KC * S);      // 32 at 4x4, 16 at 8x8
  static constexpr int L = 2 * S + 3;
  static constexpr int RS = S + 1;                   // a plane's row (odd)
  static constexpr int PL = S * RS;
  static constexpr int POOL = 4 * L + 1;             // a pool's ints (odd)
  // a tile's inputs: SATD rows [NC][67], sources [NC][PL], pools
  // [NC][POOL], lambdas [NC], lambda_sads [NC]
  static constexpr int O_SRC = NC * kModes, O_POOL = O_SRC + NC * PL;
  static constexpr int O_LM = O_POOL + NC * POOL, O_LS = O_LM + NC;
  static constexpr int BUF = O_LS + NC;
  // two tiles' inputs, then [NC * KC][3][PL] planes, tw and th, DC [NC]
  // and the modes [NC][k]
  static size_t smem(int k) {
    return (size_t)(2 * BUF + NC * KC * 3 * PL + 2 * S * S + NC + NC * k) *
           4;
  }
};

// a tile's SATD rows, sources, raw references (REFS) and lambdas into
// buf, by the block's 256 threads
template <int S, bool REFS>
__device__ __forceinline__ void small_stage(const Inputs& in,
                                            const TrialParams& p, int tile,
                                            int* buf, bool satd16, int tid) {
  using R = SmallSquare<S>;
  constexpr int NC = R::NC, L = R::L, RS = R::RS, PL = R::PL;
  const int b0 = tile * NC, nc = min(NC, in.B - b0);
  if (satd16) {
    // NC * 67 is a multiple of 4: a span's 16-byte chunks, then its last
    // candidate's tail word by word
    const int* sp = in.satd + (size_t)b0 * kModes;
    const int n4 = nc * kModes / 4;
    for (int i = tid; i < n4; i += 256) cp_async16(buf + 4 * i, sp + 4 * i);
    for (int i = 4 * n4 + tid; i < nc * kModes; i += 256)
      cp_async4(buf + i, sp + i);
  } else {
    for (int i = tid; i < nc * p.M; i += 256) {
      const int c = i / p.M;
      cp_async4(buf + c * kModes + (i - c * p.M),
                in.satd + (size_t)b0 * p.M + i);
    }
  }
  for (int i = tid; i < nc * S * S; i += 256) {
    const int c = i / (S * S), j = i - c * S * S;
    cp_async4(buf + R::O_SRC + c * PL + (j / S) * RS + j % S,
              in.src + (size_t)b0 * S * S + i);
  }
  for (int i = tid; REFS && i < nc * L; i += 256) {
    const int c = i / L, j = i - c * L;
    int* pool = buf + R::O_POOL + c * R::POOL;
    cp_async4(pool + j, in.tops + (size_t)(b0 + c) * in.Lt + j);
    cp_async4(pool + 2 * L + j, in.lefts + (size_t)(b0 + c) * in.Ll + j);
  }
  for (int i = tid; i < nc; i += 256) {
    cp_async4(buf + R::O_LM + i, in.lmbda + b0 + i);
    cp_async4(buf + R::O_LS + i, in.lmbda_sad + b0 + i);
  }
}

template <int S, bool REFS>
__global__ void __launch_bounds__(256, 4) plan_square_small_kernel(
    const Inputs in, const TrialParams p) {
  using R = SmallSquare<S>;
  constexpr int NC = R::NC, KC = R::KC, L = R::L, RS = R::RS, PL = R::PL;
  extern __shared__ __align__(16) int dsm[];
  int* planes = dsm + 2 * R::BUF;
  int* s_tw = planes + NC * KC * 3 * PL;             // [u][x]
  int* s_th = s_tw + S * S;                          // [v][y]
  int* s_dc = s_th + S * S;
  int* s_top = s_dc + NC;
  __shared__ float s_mb[kModes];
  const int tid = threadIdx.x;
  const int ntiles = (in.B + NC - 1) / NC;
  // the SATD rows of a tile are one span of the input when M = 67 (the
  // planning route's): 16-byte copies where it starts 16-byte aligned
  const bool satd16 =
      p.M == kModes && (reinterpret_cast<uintptr_t>(in.satd) & 15) == 0;
  for (int i = tid; i < S * S; i += 256) {
    s_tw[i] = in.tw[i];
    s_th[i] = in.th[i];
  }
  for (int i = tid; i < kModes; i += 256) s_mb[i] = in.mode_bits[i];
  int tile = blockIdx.x;
  if (tile < ntiles) small_stage<S, REFS>(in, p, tile, dsm, satd16, tid);
  cp_async_commit();
  // this thread's item of a pass: candidate c, survivor slot sv, line
  const int line = tid % S, gs = tid / S, c = gs / KC, sv = gs % KC;
  int* P = planes + gs * 3 * PL;                     // the prediction
  int* X = P + PL;                                   // stage results
  int* Y = X + PL;
  for (int it = 0; tile < ntiles; ++it, tile += gridDim.x) {
    int* buf = dsm + (it & 1) * R::BUF;
    __syncthreads();               // the last tile's reads are done
    if (tile + gridDim.x < ntiles)
      small_stage<S, REFS>(in, p, tile + gridDim.x,
                           dsm + ((it + 1) & 1) * R::BUF, satd16, tid);
    cp_async_commit();
    cp_async_wait_all_but_one();   // all but the next tile's copies
    __syncthreads();
    const int b0 = tile * NC, nc = min(NC, in.B - b0);
    // the tile's filtered pools and DC values (REFS), then its rankings,
    // a group of KC * S lanes a candidate
    if constexpr (REFS) {
      for (int i = tid; i < nc * L; i += 256) {
        const int cc = i / L;
        intra_pred::pool_filter(buf + R::O_POOL + cc * R::POOL, L, S, S,
                                i - cc * L, L);
      }
      if (tid < nc)
        s_dc[tid] =
            intra_pred::pool_dc(buf + R::O_POOL + tid * R::POOL, L, S, S);
    }
    {
      constexpr int LPC = KC * S;                    // lanes a candidate
      const int cc = tid / LPC;
      rank_group<LPC>(buf + cc * kModes, s_mb,
                      __int_as_float(buf[R::O_LS + cc]), p.M, p.k,
                      s_top + cc * p.k, tid % LPC);
    }
    __syncthreads();
    const bool cand = c < nc;
    const float lm = cand ? __int_as_float(buf[R::O_LM + c]) : 0.f;
    const int* src = buf + R::O_SRC + c * PL;
    const int* pool = buf + R::O_POOL + c * R::POOL;
    for (int i0 = 0; i0 < p.k; i0 += KC) {
      const int i = i0 + sv;
      const bool live = cand && i < p.k;
      const int mode = live ? s_top[c * p.k + i] : 0;
      long long sse = 0;
      int nnz = 0;
      float slog = 0.f;
      if (live && REFS) {
        // the prediction's main row `line`
        int v[S];
        const bool ver = intra_pred::pred_run<S>(
            pool, s_dc[c], in.pt, S, S, in.bit_depth, mode, line, 0, v);
#pragma unroll
        for (int q = 0; q < S; ++q)
          P[ver ? line * RS + q : q * RS + line] = v[q];
      } else if (live) {
        // row `line` of K1's prediction
        const int16_t* pb =
            in.preds + ((size_t)(b0 + c) * p.M + mode) * S * S + line * S;
#pragma unroll
        for (int q = 0; q < S; ++q) P[line * RS + q] = pb[q];
      }
      __syncwarp();
      if (live) {
        // forward rows (line y): a[y][u] = sum_x r[y][x] tw[u][x]
        int r[S];
#pragma unroll
        for (int x = 0; x < S; ++x) r[x] = src[line * RS + x] - P[line * RS + x];
#pragma unroll
        for (int u = 0; u < S; ++u) {
          int acc = 0;
#pragma unroll
          for (int x = 0; x < S; ++x) acc += r[x] * s_tw[u * S + x];
          X[line * RS + u] = clip_coeff(round_shift(acc, p.shift1));
        }
      }
      __syncwarp();
      if (live) {
        // forward columns (line u): c[v][u] = sum_y th[v][y] a[y][u];
        // quantise, dequantise
        int a[S];
#pragma unroll
        for (int y = 0; y < S; ++y) a[y] = X[y * RS + line];
#pragma unroll
        for (int v = 0; v < S; ++v) {
          int acc = 0;
#pragma unroll
          for (int y = 0; y < S; ++y) acc += s_th[v * S + y] * a[y];
          Y[v * RS + line] =
              quant_dequant(p, clip_coeff(round_shift(acc, p.shift2)), nnz,
                            slog);
        }
      }
      __syncwarp();
      if (live) {
        // inverse columns (line u): a[y][u] = sum_v th[v][y] d[v][u]
        int d[S];
#pragma unroll
        for (int v = 0; v < S; ++v) d[v] = Y[v * RS + line];
#pragma unroll
        for (int y = 0; y < S; ++y) {
          int acc = 0;
#pragma unroll
          for (int v = 0; v < S; ++v) acc += s_th[v * S + y] * d[v];
          X[y * RS + line] = clip_coeff(round_shift(acc, 7));
        }
      }
      __syncwarp();
      if (live) {
        // inverse rows (line y): r[y][x] = sum_u a[y][u] tw[u][x]; recon
        // and SSE
        int a[S];
#pragma unroll
        for (int u = 0; u < S; ++u) a[u] = X[line * RS + u];
#pragma unroll
        for (int x = 0; x < S; ++x) {
          int acc = 0;
#pragma unroll
          for (int u = 0; u < S; ++u) acc += a[u] * s_tw[u * S + x];
          const int r = clip_coeff(round_shift(acc, p.ishift2));
          const int rec = clampi(P[line * RS + x] + r, 0, p.maxval);
          const int er = src[line * RS + x] - rec;
          sse += (long long)er * er;
        }
      }
      // the survivor's sums over its S lanes
      sse = warp_sum(sse, S);
      nnz = warp_sum(nnz, S);
      slog = warp_sum(slog, S);
      if (live && line == 0) {
        in.modes[(size_t)(b0 + c) * p.k + i] = mode;
        in.costs[(size_t)(b0 + c) * p.k + i] =
            trial_cost(p, sse, nnz, slog, lm, s_mb[mode]);
      }
      __syncwarp();
    }
  }
}

// the square kernels, by entry (preds 0, refs 1) and side (4 .. 64)
constexpr int kSides = 5;

int side_index(int s) {
  switch (s) {
    case 4: return 0;
    case 8: return 1;
    case 16: return 2;
    case 32: return 3;
    case 64: return 4;
  }
  return -1;
}

struct SquareLaunch {
  const void* f;
  size_t shm, shm_max;      // for this k, for any k
  int threads;
  int unit;                 // candidates a block takes at a step
};

template <bool REFS>
SquareLaunch square_launch_for(int s, int k) {
  switch (s) {
    case 4:
      return {(const void*)plan_square_small_kernel<4, REFS>,
              SmallSquare<4>::smem(k), SmallSquare<4>::smem(kModes), 256,
              SmallSquare<4>::NC};
    case 8:
      return {(const void*)plan_square_small_kernel<8, REFS>,
              SmallSquare<8>::smem(k), SmallSquare<8>::smem(kModes), 256,
              SmallSquare<8>::NC};
    case 16:
      return {(const void*)plan_refs_tc_kernel<16>, TcSquare<16>::smem(),
              TcSquare<16>::smem(), TcSquare<16>::THREADS, 1};
    case 32:
      return {(const void*)plan_refs_tc_kernel<32>, TcSquare<32>::smem(),
              TcSquare<32>::smem(), TcSquare<32>::THREADS, 1};
    default:
      return {(const void*)plan_refs_tc_kernel<64>, TcSquare<64>::smem(),
              TcSquare<64>::smem(), TcSquare<64>::THREADS, 1};
  }
}

SquareLaunch square_launch_for(int s, int k, bool refs) {
  return refs ? square_launch_for<true>(s, k) : square_launch_for<false>(s, k);
}

// per device: the shared-memory attribute set once per kernel, the SM
// count, and the resident blocks an SM per (kernel, k), each asked once
constexpr int kDevices = 16;
std::atomic<int> g_attr_set[2][kSides][kDevices];
std::atomic<int> g_sms[kDevices];
std::atomic<int> g_blocks[2][kSides][kModes + 1][kDevices];

// the resident blocks an SM and the SMs of the current device for the
// square kernel of (refs, s, k), its shared-memory attribute set first
cudaError_t square_blocks(bool refs, int s, int k, const SquareLaunch& l,
                          int* blocks, int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const int si = side_index(s), d = dev < kDevices ? dev : -1;
  if (d < 0 || !g_attr_set[refs][si][d].load(std::memory_order_relaxed)) {
    e = cudaFuncSetAttribute(l.f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)l.shm_max);
    if (e != cudaSuccess) return e;
    if (d >= 0) g_attr_set[refs][si][d].store(1, std::memory_order_relaxed);
  }
  int n = d < 0 ? 0 : g_sms[d].load(std::memory_order_relaxed);
  if (n == 0) {
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (d >= 0) g_sms[d].store(n, std::memory_order_relaxed);
  }
  int nb = d < 0 ? 0 : g_blocks[refs][si][k][d].load(std::memory_order_relaxed);
  if (nb == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, l.f, l.threads,
                                                      l.shm);
    if (e != cudaSuccess) return e;
    if (nb < 1) return cudaErrorInvalidConfiguration;
    if (d >= 0)
      g_blocks[refs][si][k][d].store(nb, std::memory_order_relaxed);
  }
  *blocks = nb;
  *sms = n;
  return cudaSuccess;
}

template <bool REFS>
int launch_square(const Inputs& in, const TrialParams& p, void* stream) {
  const int s = p.w;
  const SquareLaunch l = square_launch_for<REFS>(s, p.k);
  int blocks = 0, sms = 0;
  const cudaError_t e = square_blocks(REFS, s, p.k, l, &blocks, &sms);
  if (e != cudaSuccess) return (int)e;
  const int units = (in.B + l.unit - 1) / l.unit;
  const int grid = units < blocks * sms ? units : blocks * sms;
  cudaStream_t st = (cudaStream_t)stream;
  switch (s) {
    case 4:
      plan_square_small_kernel<4, REFS><<<grid, l.threads, l.shm, st>>>(in,
                                                                        p);
      break;
    case 8:
      plan_square_small_kernel<8, REFS><<<grid, l.threads, l.shm, st>>>(in,
                                                                        p);
      break;
    case 16:
      plan_refs_tc_kernel<16><<<grid, l.threads, l.shm, st>>>(in, p);
      break;
    case 32:
      plan_refs_tc_kernel<32><<<grid, l.threads, l.shm, st>>>(in, p);
      break;
    default:
      plan_refs_tc_kernel<64><<<grid, l.threads, l.shm, st>>>(in, p);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------

// the persistent kernels take the reference entry's square classes (the
// pool 2s + 3 wide) and the preds form's 4x4 and 8x8; the preds form's
// 16x16 .. 64x64 keep plan_trial_tc_kernel (whose tile order the
// reference entry's repeats), every other class the warp route
bool persistent(int w, int h, int lpad) {
  if (w != h || side_index(w) < 0) return false;
  return lpad > 0 ? lpad == 2 * w + 3 : w < 16;
}

// the kernel, its shared memory and threads of a class outside the
// persistent kernels
struct Launch {
  const void* f;
  size_t shm;
  int threads;
  WarpGeom q;
};

Launch launch_for(int w, int h, int lpad) {
  Launch l;
  l.q = warp_geom(w, h, lpad);
  l.threads = lpad > 0 || w != h || w < 16 ? kWarpThreads
              : (w == 16 ? TcGeom<16>::THREADS : TcGeom<32>::THREADS);
  if (lpad > 0) {
    l.f = (const void*)plan_trial_warp_kernel<true>;
    l.shm = warp_smem(l.q);
  } else if (w == h && w == 16) {
    l.f = (const void*)plan_trial_tc_kernel<16>;
    l.shm = tc_smem<16>();
  } else if (w == h && w == 32) {
    l.f = (const void*)plan_trial_tc_kernel<32>;
    l.shm = tc_smem<32>();
  } else if (w == h && w == 64) {
    l.f = (const void*)plan_trial_tc_kernel<64>;
    l.shm = tc_smem<64>();
  } else {
    l.f = (const void*)plan_trial_warp_kernel<false>;
    l.shm = warp_smem(l.q);
  }
  return l;
}

int launch(const Inputs& in, const TrialParams& p, int lpad, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (p.k < 1 || p.k > p.M || p.M > kModes || in.B < 1)
    return (int)cudaErrorInvalidValue;
  if (persistent(p.w, p.h, lpad))
    return lpad > 0 ? launch_square<true>(in, p, stream)
                    : launch_square<false>(in, p, stream);
  const Launch l = launch_for(p.w, p.h, lpad);
  cudaError_t e = cudaFuncSetAttribute(
      l.f, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.shm);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const int B = in.B;
  if (l.f == (const void*)plan_trial_tc_kernel<16>)
    plan_trial_tc_kernel<16><<<B, l.threads, l.shm, st>>>(in, p);
  else if (l.f == (const void*)plan_trial_tc_kernel<32>)
    plan_trial_tc_kernel<32><<<B, l.threads, l.shm, st>>>(in, p);
  else if (l.f == (const void*)plan_trial_tc_kernel<64>)
    plan_trial_tc_kernel<64><<<B, l.threads, l.shm, st>>>(in, p);
  else if (lpad > 0)
    plan_trial_warp_kernel<true><<<(B + l.q.warps - 1) / l.q.warps,
                                   l.threads, l.shm, st>>>(in, p, l.q);
  else
    plan_trial_warp_kernel<false><<<(B + l.q.warps - 1) / l.q.warps,
                                    l.threads, l.shm, st>>>(in, p, l.q);
  return (int)cudaGetLastError();
}

// the resources of the kernel a (w, h) class launches (a persistent
// kernel's for k = 2, the planning default)
int attrs(int w, int h, int lpad, int* out) {
  const void* f;
  size_t shm;
  int threads;
  if (persistent(w, h, lpad)) {
    const SquareLaunch l = square_launch_for(w, 2, lpad > 0);
    int blocks = 0, sms = 0;
    const cudaError_t e = square_blocks(lpad > 0, w, 2, l, &blocks, &sms);
    if (e != cudaSuccess) return (int)e;
    f = l.f;
    shm = l.shm;
    threads = l.threads;
  } else {
    const Launch l = launch_for(w, h, lpad);
    const cudaError_t e = cudaFuncSetAttribute(
        l.f, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.shm);
    if (e != cudaSuccess) return (int)e;
    f = l.f;
    shm = l.shm;
    threads = l.threads;
  }
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, f);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f, threads, shm);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)shm;
  out[3] = threads;
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

// one class's constants of the reference entry, as
// ops/intra_plan._RefsParams lays them out: built once per (class, QP,
// bit depth, transform types, k) by the wrapper, so that a launch passes
// one pointer for them
struct RefsParams {
  const void* mode_bits;
  const void* tw;
  const void* th;
  const void* rm_flat;
  const void* row_start;
  const void* filt;
  const void* mode_info;
  const void* pdpc_wl;
  const void* side_flat;
  int M, w, h, k, shift1, shift2, ishift2, qbits, qscale, qadd, dshift,
      dscale, maxval;
  float c0, c1, c2;
  int bit_depth, LPAD, LR, TM, B0;
};

// vt_plan_trial_refs with the class's constants from a RefsParams in
// host memory.  Returns cudaGetLastError() after the launch.
extern "C" int vt_plan_trial_refs_p(const void* params, const void* src,
                                    const void* tops, int Lt,
                                    const void* lefts, int Ll,
                                    const void* satd, const void* lmbda,
                                    const void* lmbda_sad, void* modes,
                                    void* costs, int B, void* stream) {
  const RefsParams& q = *(const RefsParams*)params;
  return vt_plan_trial_refs(
      src, tops, Lt, lefts, Ll, satd, lmbda, lmbda_sad, q.mode_bits, q.tw,
      q.th, modes, costs, B, q.M, q.w, q.h, q.k, q.shift1, q.shift2,
      q.ishift2, q.qbits, q.qscale, q.qadd, q.dshift, q.dscale, q.maxval,
      q.c0, q.c1, q.c2, q.bit_depth, q.rm_flat, q.row_start, q.filt,
      q.mode_info, q.pdpc_wl, q.side_flat, q.LPAD, q.LR, q.TM, q.B0, stream);
}

// the resources of the kernel a (w, h) class launches: out = registers
// per thread, static and dynamic shared memory bytes, threads per block,
// resident blocks per SM, local memory bytes per thread.
extern "C" int vt_plan_trial_attrs(int w, int h, int* out) {
  return attrs(w, h, 0, out);
}

// the same for vt_plan_trial_refs (the class's pool: LPAD =
// max(2w, 2h) + 3; the square classes' kernels at k = 2)
extern "C" int vt_plan_trial_refs_attrs(int w, int h, int* out) {
  return attrs(w, h, 2 * (w > h ? w : h) + 3, out);
}

// K4 presel_costs: the 67-mode intra SATD costs of every candidate block
// of one (w, h) class of a picture, read straight from the padded source
// plane.
//
// Replaces vvenc_tpu/ops/intra_presel.py:197 presel_costs, an XLA program
// on the TPU that ran predict_all_modes (:63) into a [B, 67, h, w] int16
// buffer and satd_batch (:176) over it, on blocks and references that the
// host had gathered into [B, h, w] / [B, 2w+3] / [B, 2h+3] arrays
// (FramePresel._build).  Here the two are fused and the host gathers
// nothing: a candidate's source block and its references are read from
// the plane at (xs[i % nx], ys[i / nx]), and no prediction is ever
// written to device memory.
//
// Same arithmetic as K1 (csrc/intra_pred_all.cu) and K2
// (csrc/satd_modes.cu), with the reference's pool layout for references
// gathered 2w+3 / 2h+3 wide: pool = [top (2w+3) | ftop (2w+3) | left
// (2h+3) | fleft (2h+3)], read at the tables' segment * LPAD + index
// positions (LPAD = max(2w, 2h) + 3), a position past the pool's end
// reading its last entry as XLA's clamped gather does.  On a square class
// this is K1's pool; on a rectangular one it reproduces the reference's
// misplaced reads (ROADMAP.md section 3).
//
// Bound: operations.  Each prediction sample costs a 4-tap sum with its
// table lookups and its share of the Hadamard butterflies (about 20
// integer operations), against a plane read once and 67 int32 costs
// written per candidate: at 1080p with the MTT classes, 29 G samples
// against 0.46 GB written.  Design: a thread block holds G candidates
// (G = 32 / tiles, at least 1); their pools, source blocks and DC values
// are staged in shared memory, and each thread takes one (mode, Hadamard
// tile, candidate) task at a time, the candidate fastest, so that a warp
// works on one mode (uniform table reads, no divergence): it predicts the
// tile's
// T x T samples into registers (T = 8, or 4 when w or h is not a multiple
// of 8) one row of the mode's orientation at a time, the row's four taps
// and its window of T + 3 pool entries read once, subtracts the source,
// runs the integer butterflies and adds the tile's SATD into the
// candidate's per-mode sum in shared memory with an integer atomic
// (order-free, so exact).  The static per-mode tables are K1's
// (ops/tables.device_tables), read through the read-only cache; all
// angular samples are the same 4-tap gather, so modes do not diverge.
//
// A second entry, vt_presel_costs_gathered, takes the reference's own
// inputs (blocks [B, h, w], tops [B, Lt], lefts [B, Ll] int32, as the
// mesh path's sharded_presel_costs and the graft entry pass them) and
// only stages them differently: the pool is [tops (nA) | ftop (nA) |
// lefts (nL) | fleft (nL)] with nA = min(Lt, LPAD), nL = min(Ll, LPAD),
// the reference's concatenated layout, so the rectangular-class misreads
// and the clamp past the pool's end are the reference's for any width.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kModes = 67;
constexpr int kFlagVer = 1, kFlagPdpc = 2, kFlagAng0 = 4;  // ops/tables.py

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int log2i(int v) { return 31 - __clz(v); }

template <int T>
__device__ __forceinline__ void wht(int* v, int stride) {
  // natural-order (Sylvester) Hadamard of T values v[0], v[stride], ...
#pragma unroll
  for (int len = 1; len < T; len <<= 1)
#pragma unroll
    for (int i = 0; i < T; i += 2 * len)
#pragma unroll
      for (int j = i; j < i + len; ++j) {
        const int a = v[j * stride], c = v[(j + len) * stride];
        v[j * stride] = a + c;
        v[(j + len) * stride] = a - c;
      }
}

struct Shape {
  int w, h, bit_depth, LR, TM, B0;
  int nA, nL, P;        // top / left segment lengths, pool length
  int per;              // ints of shared memory per candidate
};

// where a candidate's source block and references come from: the padded
// plane at grid position (xs[c % nx], ys[c / nx]), or the gathered
// arrays (row c of blocks / tops / lefts)
struct Inputs {
  const int16_t* plane;
  int stride, pad, nx;
  const int* xs;
  const int* ys;
  const int* blocks;
  const int* tops;
  const int* lefts;
  int Lt, Ll;
};

// one planar (mode 0) or DC (mode 1) sample at (yy, xx) of a candidate
// whose pool and DC value are staged at `pool` / `dc`
__device__ __forceinline__ int planar_dc(const Shape& s, const int* pool,
                                         int dc, int mode, int yy, int xx) {
  const int w = s.w, h = s.h;
  // planar uses the filtered references when w*h > 32 (MDIS)
  const bool mdis = mode == 0 && w * h > 32;
  const int* pt = pool + (mdis ? s.nA : 0);
  const int* pl = pool + 2 * s.nA + (mdis ? s.nL : 0);
  int v;
  if (mode == 0) {
    const int log2w = log2i(w), log2h = log2i(h);
    const int lc = pl[1 + yy], trr = pt[1 + xx];
    const int tr = pt[1 + w], br = pl[1 + h];
    const int hor = lc * (1 << log2w) + (xx + 1) * (tr - lc);
    const int ver = trr * (1 << log2h) + (yy + 1) * (br - trr);
    v = (hor * (1 << log2h) + ver * (1 << log2w) + (1 << (log2w + log2h))) >>
        (1 + log2w + log2h);
  } else {
    v = dc;
  }
  const int pscale = (log2i(w * h) - 2) >> 2;
  const int wt = 32 >> min(31, (yy << 1) >> pscale);
  const int wl = 32 >> min(31, (xx << 1) >> pscale);
  v = v + ((wl * (pl[1 + yy] - v) + wt * (pt[1 + xx] - v) + 32) >> 6);
  return clampi(v, 0, (1 << s.bit_depth) - 1);
}

// the T x T tile at (y0, x0) of angular mode mi + 2, minus the source,
// into d (int16 wrap as the reference's int16 difference).  The mode's
// "rows" run along y for a vertical mode (VER) and along x otherwise;
// the T samples of one row share the row's taps and read one window of
// T + 3 pool entries (rm_flat is contiguous along a row), so the tables
// and the pool are read once per row, not four times per sample.
template <int T, bool VER>
__device__ __forceinline__ void angular_tile(
    const Shape& s, const int* pool, const int* src, int mi, int y0, int x0,
    int* d, const int* __restrict__ rm_flat, const int* __restrict__ row_start,
    const int* __restrict__ filt, const int* __restrict__ mode_info,
    const int* __restrict__ pdpc_wl, const int* __restrict__ side_flat) {
  const int maxval = (1 << s.bit_depth) - 1;
  const int last = s.P - 1;
  const int shift = __ldg(mode_info + 4 * mi);
  const int rnd = __ldg(mode_info + 4 * mi + 1);
  const int flags = __ldg(mode_info + 4 * mi + 2);
  const bool pdpc = flags & kFlagPdpc, ang0 = flags & kFlagAng0;
  const int r0 = VER ? y0 : x0, c0 = VER ? x0 : y0;
  // PDPC weights depend on the column only; zero where PDPC stops
  int wl[T];
#pragma unroll
  for (int b = 0; b < T; ++b)
    wl[b] = pdpc ? __ldg(pdpc_wl + mi * s.TM + c0 + b) : 0;
  const int tl =
      ang0 ? (int16_t)pool[min(__ldg(rm_flat + mi * s.LR + s.B0), last)] : 0;
#pragma unroll
  for (int a = 0; a < T; ++a) {
    const int row = r0 + a;
    const int* rm = rm_flat + mi * s.LR + __ldg(row_start + mi * s.TM + row) + c0;
    const int* f = filt + (mi * s.TM + row) * 4;
    const int f0 = __ldg(f), f1 = __ldg(f + 1), f2 = __ldg(f + 2),
              f3 = __ldg(f + 3);
    int win[T + 3];
#pragma unroll
    for (int c = 0; c < T + 3; ++c)
      win[c] = (int16_t)pool[min(__ldg(rm + c), last)];
#pragma unroll
    for (int b = 0; b < T; ++b) {
      const int acc = f0 * win[b] + f1 * win[b + 1] + f2 * win[b + 2] +
                      f3 * win[b + 3];
      int v = clampi((acc + rnd) >> shift, 0, maxval);
      if (wl[b] != 0) {
        const int lval = (int16_t)
            pool[min(__ldg(side_flat + (mi * s.TM + row) * s.TM + c0 + b), last)];
        if (ang0)
          v = clampi(v + ((wl[b] * (lval - tl) + 32) >> 6), 0, maxval);
        else
          v = v + ((wl[b] * (lval - v) + 32) >> 6);
      }
      v = clampi(v, 0, maxval);
      const int i = VER ? a : b, j = VER ? b : a;  // tile coordinates
      d[i * T + j] =
          (int16_t)((int16_t)src[(y0 + i) * s.w + x0 + j] - (int16_t)v);
    }
  }
}

template <int T, bool GATHERED>
__global__ void __launch_bounds__(kMaxThreads) presel_costs_kernel(
    const Inputs in, long long B, int G, int* __restrict__ out, Shape s,
    const int* __restrict__ rm_flat, const int* __restrict__ row_start,
    const int* __restrict__ filt, const int* __restrict__ mode_info,
    const int* __restrict__ pdpc_wl, const int* __restrict__ side_flat) {
  // per candidate: pool [P] | source block [h*w] | costs [67] | dc
  extern __shared__ int smem[];
  const int w = s.w, h = s.h, hw = w * h, per = s.per;
  const long long c0 = (long long)blockIdx.x * G;
  const int G_live = (int)min((long long)G, B - c0);

  // stage the raw references, the source blocks and zero costs
  const int16_t* plane = in.plane;
  const int stride = in.stride, pad = in.pad, nx = in.nx;
  for (int k = threadIdx.x; k < G_live * s.nA; k += blockDim.x) {
    const int g = k / s.nA, j = k - g * s.nA;
    const long long c = c0 + g;
    if constexpr (GATHERED) {
      smem[g * per + j] = in.tops[c * in.Lt + j];
    } else {
      const int bx = __ldg(in.xs + c % nx), by = __ldg(in.ys + c / nx);
      smem[g * per + j] =
          plane[(size_t)(by + pad - 1) * stride + bx + pad - 1 + j];
    }
  }
  for (int k = threadIdx.x; k < G_live * s.nL; k += blockDim.x) {
    const int g = k / s.nL, j = k - g * s.nL;
    const long long c = c0 + g;
    if constexpr (GATHERED) {
      smem[g * per + 2 * s.nA + j] = in.lefts[c * in.Ll + j];
    } else {
      const int bx = __ldg(in.xs + c % nx), by = __ldg(in.ys + c / nx);
      smem[g * per + 2 * s.nA + j] =
          plane[(size_t)(by + pad - 1 + j) * stride + bx + pad - 1];
    }
  }
  for (int k = threadIdx.x; k < G_live * hw; k += blockDim.x) {
    const int g = k / hw, i = k - g * hw;
    const long long c = c0 + g;
    if constexpr (GATHERED) {
      smem[g * per + s.P + i] = in.blocks[c * hw + i];
    } else {
      const int bx = __ldg(in.xs + c % nx), by = __ldg(in.ys + c / nx);
      smem[g * per + s.P + i] =
          plane[(size_t)(by + pad + i / w) * stride + bx + pad + i % w];
    }
  }
  for (int k = threadIdx.x; k < G_live * kModes; k += blockDim.x) {
    const int g = k / kModes;
    smem[g * per + s.P + hw + k - g * kModes] = 0;
  }
  __syncthreads();
  // [1 2 1] filtered references and the DC values
  {
    const int n = 2 * w, m = 2 * h;
    for (int k = threadIdx.x; k < G_live * s.nA; k += blockDim.x) {
      const int g = k / s.nA, j = k - g * s.nA;
      const int* top = smem + g * per;
      const int* left = top + 2 * s.nA;
      const int corner = (top[0] + top[1] + left[0] + left[1] + 2) >> 2;
      smem[g * per + s.nA + j] =
          j == 0 ? corner
          : j < n ? (top[j - 1] + 2 * top[j] + top[j + 1] + 2) >> 2 : top[n];
    }
    for (int k = threadIdx.x; k < G_live * s.nL; k += blockDim.x) {
      const int g = k / s.nL, j = k - g * s.nL;
      const int* top = smem + g * per;
      const int* left = top + 2 * s.nA;
      const int corner = (top[0] + top[1] + left[0] + left[1] + 2) >> 2;
      smem[g * per + 2 * s.nA + s.nL + j] =
          j == 0 ? corner
          : j < m ? (left[j - 1] + 2 * left[j] + left[j + 1] + 2) >> 2
                  : left[m];
    }
    for (int g = threadIdx.x; g < G_live; g += blockDim.x) {
      // DC: average of both sides (square) or of the longer side only
      const int* top = smem + g * per;
      const int* left = top + 2 * s.nA;
      const int denom = w == h ? (w << 1) : max(w, h);
      int sum = 0;
      if (w >= h)
        for (int x = 1; x <= w; ++x) sum += top[x];
      if (w <= h)
        for (int y = 1; y <= h; ++y) sum += left[y];
      smem[g * per + per - 1] = (sum + (denom >> 1)) >> log2i(denom);
    }
  }
  __syncthreads();

  // tasks in (mode, tile, candidate) order, candidate fastest: the G x
  // tiles >= 32 tasks of one mode fill a warp, so the mode's tables are
  // read warp-uniformly and its branches do not diverge
  const int ntx = w / T, ntiles = ntx * (h / T);
  const int per_mode = G * ntiles;
  for (int t = threadIdx.x; t < kModes * per_mode; t += blockDim.x) {
    const int mode = t / per_mode;
    const int r = t - mode * per_mode;
    const int tile = r / G, g = r - (r / G) * G;
    if (g >= G_live) continue;
    const int* pool = smem + g * per;
    const int* src = pool + s.P;
    const int dc = pool[per - 1];
    const int y0 = (tile / ntx) * T, x0 = (tile % ntx) * T;
    int d[T * T];
    if (mode < 2) {
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int j = 0; j < T; ++j)
          d[i * T + j] = (int16_t)((int16_t)src[(y0 + i) * w + x0 + j] -
                                   (int16_t)planar_dc(s, pool, dc, mode,
                                                      y0 + i, x0 + j));
    } else if (__ldg(mode_info + 4 * (mode - 2) + 2) & kFlagVer) {
      angular_tile<T, true>(s, pool, src, mode - 2, y0, x0, d, rm_flat,
                            row_start, filt, mode_info, pdpc_wl, side_flat);
    } else {
      angular_tile<T, false>(s, pool, src, mode - 2, y0, x0, d, rm_flat,
                             row_start, filt, mode_info, pdpc_wl, side_flat);
    }
#pragma unroll
    for (int i = 0; i < T; ++i) wht<T>(d + i * T, 1);  // rows: D H
#pragma unroll
    for (int j = 0; j < T; ++j) wht<T>(d + j, T);      // columns: H (D H)
    int sum = 0;
#pragma unroll
    for (int i = 0; i < T * T; ++i) sum += abs(d[i]);
    int val;
    if (T == 8) {
      val = (sum + 2) >> 2;
    } else {
      const int dct = abs(d[0]);
      val = ((sum - dct + (dct >> 2)) + 1) >> 1;
    }
    atomicAdd(smem + g * per + s.P + hw + mode, val);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < G_live * kModes; k += blockDim.x) {
    const int g = k / kModes;
    out[(c0 + g) * kModes + k - g * kModes] = smem[g * per + s.P + hw + k - g * kModes];
  }
}

}  // namespace

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

namespace {

// launches the kernel over B candidates of one (w, h) class whose pool
// segments are nA / nL long
template <bool GATHERED>
int launch(const Inputs& in, long long B, void* out, int w, int h,
           int bit_depth, int nA, int nL, const void* rm_flat,
           const void* row_start, const void* filt, const void* mode_info,
           const void* pdpc_wl, const void* side_flat, int LR, int TM, int B0,
           void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (w < 4 || h < 4 || w > 64 || h > 64 || (w & (w - 1)) || (h & (h - 1)) ||
      B <= 0)
    return (int)cudaErrorInvalidValue;
  const int T = (w % 8 == 0 && h % 8 == 0) ? 8 : 4;
  const int ntiles = (w / T) * (h / T);
  const int G = ntiles >= 32 ? 1 : 32 / ntiles;  // G * ntiles >= 32
  Shape s;
  s.w = w;
  s.h = h;
  s.bit_depth = bit_depth;
  s.LR = LR;
  s.TM = TM;
  s.B0 = B0;
  s.nA = nA;
  s.nL = nL;
  s.P = 2 * s.nA + 2 * s.nL;
  s.per = s.P + w * h + kModes + 1;
  const unsigned grid = (unsigned)((B + G - 1) / G);
  const size_t shm = (size_t)G * s.per * sizeof(int);
  cudaStream_t st = (cudaStream_t)stream;
  if (T == 8)
    presel_costs_kernel<8, GATHERED><<<grid, kMaxThreads, shm, st>>>(
        in, B, G, (int*)out, s, (const int*)rm_flat, (const int*)row_start,
        (const int*)filt, (const int*)mode_info, (const int*)pdpc_wl,
        (const int*)side_flat);
  else
    presel_costs_kernel<4, GATHERED><<<grid, kMaxThreads, shm, st>>>(
        in, B, G, (int*)out, s, (const int*)rm_flat, (const int*)row_start,
        (const int*)filt, (const int*)mode_info, (const int*)pdpc_wl,
        (const int*)side_flat);
  return (int)cudaGetLastError();
}

}  // namespace

// plane [rows, stride] int16 (the picture edge-padded by `pad`), xs [nx] /
// ys [ny] int32 grid positions in picture coordinates, out [ny*nx, 67]
// int32; the tables are ops/tables.device_tables(w, h).  Returns
// cudaGetLastError() after the launch on `stream`.
extern "C" int vt_presel_costs(
    const void* plane, int stride, int pad, const void* xs, int nx,
    const void* ys, int ny, void* out, int w, int h, int bit_depth,
    const void* rm_flat, const void* row_start, const void* filt,
    const void* mode_info, const void* pdpc_wl, const void* side_flat,
    int LR, int TM, int B0, void* stream) {
  if (nx <= 0 || ny <= 0) return (int)cudaErrorInvalidValue;
  Inputs in = {};
  in.plane = (const int16_t*)plane;
  in.stride = stride;
  in.pad = pad;
  in.nx = nx;
  in.xs = (const int*)xs;
  in.ys = (const int*)ys;
  return launch<false>(in, (long long)nx * ny, out, w, h, bit_depth,
                       2 * w + 3, 2 * h + 3, rm_flat, row_start, filt,
                       mode_info, pdpc_wl, side_flat, LR, TM, B0, stream);
}

// blocks [B, h, w], tops [B, Lt] (Lt >= 2w+3), lefts [B, Ll] (Ll >= 2h+3)
// int32, out [B, 67] int32; nA / nL = the pool's segment lengths
// (min(Lt, LPAD), min(Ll, LPAD)).  Returns cudaGetLastError() after the
// launch on `stream`.
extern "C" int vt_presel_costs_gathered(
    const void* blocks, const void* tops, int Lt, const void* lefts, int Ll,
    long long B, void* out, int w, int h, int bit_depth, int nA, int nL,
    const void* rm_flat, const void* row_start, const void* filt,
    const void* mode_info, const void* pdpc_wl, const void* side_flat,
    int LR, int TM, int B0, void* stream) {
  if (nA < 2 * w + 3 || nA > Lt || nL < 2 * h + 3 || nL > Ll)
    return (int)cudaErrorInvalidValue;
  Inputs in = {};
  in.blocks = (const int*)blocks;
  in.tops = (const int*)tops;
  in.lefts = (const int*)lefts;
  in.Lt = Lt;
  in.Ll = Ll;
  return launch<true>(in, B, out, w, h, bit_depth, nA, nL, rm_flat,
                      row_start, filt, mode_info, pdpc_wl, side_flat, LR, TM,
                      B0, stream);
}

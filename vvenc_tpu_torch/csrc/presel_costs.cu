// K4 presel_costs: the 67-mode intra SATD costs of every candidate block
// of one (w, h) class of a picture.
//
// Replaces vvenc_tpu/ops/intra_presel.py:197 presel_costs, an XLA program
// on the TPU that ran predict_all_modes (:63) into a [B, 67, h, w] int16
// buffer and satd_batch (:176) over it.  Here the two are fused: no
// prediction is ever written to device memory.  Two entries share the
// body and differ only in staging: vt_presel_costs reads a candidate's
// source block and references straight from the padded int16 plane at
// (xs[i % nx], ys[i / nx]); vt_presel_costs_gathered takes the
// reference's own gathered int32 inputs (blocks [B, h, w], tops [B, Lt],
// lefts [B, Ll]; the mesh path and the graft entry).  The pool is the
// reference's [top (nA) | ftop (nA) | left (nL) | fleft (nL)], read at
// its tables' segment * LPAD + index positions with a position past the
// end reading the last entry (XLA's clamped gather): on a rectangular
// class this reproduces the reference's misreads (ROADMAP.md section 3).
//
// What bounds it on the H100: arithmetic.  A prediction sample costs a
// 4-tap sum, a round, a clip, a subtraction and its share of the
// Hadamard butterflies and of the absolute sum (chip_smoke.presel_work
// counts 20 operations a sample against the 67 T/s float32 peak); a
// 1080p picture's 23 classes are 29 G samples, against a plane read once
// and 464 MB of costs written.  Hopper issues 32-bit integer adds and
// multiply-adds at half the float32 rate (64 lanes per SM per clock), so
// this kernel runs every per-sample operation on the float32 pipe, where
// it is exact: every value is an integer below 2^24 (samples < 2^10,
// 4-tap sums < 2^17, Hadamard sums < 2^17, a tile's absolute sum < 2^23).
// Each (x + rnd) >> 6 is rint((x + 0.5) / 64), one fused multiply-add
// onto 1.5 * 2^23 (whose float spacing is 1): the argument is never a
// half-integer, so the round is the floor of the integer division.
// tests/test_torch_exact_split.py holds this algebra and the order of
// operations against the integer version.
//
// Design (the earlier kernel held a whole tile's prediction, window and
// weights in 140 registers, one 256-thread block per SM, and read its
// per-mode tables per sample through L1):
// - persistent blocks walk the class's groups of G candidates; the next
//   group's references and source rows are in flight by cp.async (4-byte
//   copies of the int16 pairs that hold them) while the current group
//   computes;
// - the candidates' pools (float, [1 2 1] filtered halves built once),
//   source blocks (float + 1.5 * 2^23, tile-major) and costs live in
//   shared memory at odd strides, so candidate-fastest lanes hit
//   distinct banks;
// - the modes run in steps of MS: a step first gathers, for each
//   (mode, candidate), the mode's reference main, PDPC side values and
//   corner into one contiguous row (ops/tables.presel_mode_tables: one
//   host-clamped pool position list per mode, so no read needs a clamp
//   and no per-sample index table is read), with the modes' row offsets
//   and taps; then every thread takes one (mode, tile, candidate) task:
//   a row's 4 taps and its window of T + 3 values, T samples, the
//   butterflies in registers, and a warp shuffle sum of the tile SATDs
//   of one (candidate, mode) before a shared-memory add;
// - planar and DC (modes 0 and 1) are computed in integers from the pool
//   once per group, into shared memory, and their tasks only subtract;
//   tasks whose tile reaches no PDPC column run code without PDPC;
// - a class of fewer groups than half the card's resident blocks (device
//   planning's classes of one picture) splits each group's mode steps
//   over as many of them as one wave holds: a work item is (group, range
//   of steps), each item stages its group and writes only its modes'
//   costs, so the per-(candidate, mode) arithmetic is the same.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kModes = 67;
constexpr int kSmemAim = 72 * 1024;             // bytes: 3 blocks per SM
constexpr int kPdpcCols = 12;                   // ops/tables.PDPC_COLS
constexpr int kFlagVer = 1, kFlagPdpc = 2, kFlagAng0 = 4;  // ops/tables.py
constexpr float kMagic = 12582912.0f;           // 1.5 * 2^23

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int log2i(int v) { return 31 - __clz(v); }

// floor(x / 64) of an integer-valued x + 0.5 (|x| < 2^22), plus 1.5 * 2^23
__device__ __forceinline__ float shr6_magic(float x_half) {
  return __fmaf_rn(x_half, 0.015625f, kMagic);
}

// an exact integer-valued float (|f| < 2^22) as an int
__device__ __forceinline__ int f2i(float f) {
  return __float_as_int(__fadd_rn(f, kMagic)) - __float_as_int(kMagic);
}

template <int T>
__device__ __forceinline__ void wht(float* v, int stride) {
  // natural-order (Sylvester) Hadamard of T values v[0], v[stride], ...
#pragma unroll
  for (int len = 1; len < T; len <<= 1)
#pragma unroll
    for (int i = 0; i < T; i += 2 * len)
#pragma unroll
      for (int j = i; j < i + len; ++j) {
        const float a = v[j * stride], c = v[(j + len) * stride];
        v[j * stride] = __fadd_rn(a, c);
        v[(j + len) * stride] = __fsub_rn(a, c);
      }
}

// lanes per tile: an 8x8 tile is split over two lanes, 4 of its mode rows
// each, so that a lane holds 32 values (T = 4: one lane, the whole tile)
template <int T>
constexpr int kLanes = T / 4;

// the offset of sample (a, b) of a source tile copy in mode coordinates
// (a along the mode's rows): T = 4, rows of 4; T = 8, rows of 9 (a pad
// after column 3) and a pad after row 3, so that the two lanes of a tile,
// which read the same (row, sample) of their halves, are 37 words apart
template <int T>
__device__ __forceinline__ int src_off(int a, int b) {
  return T == 8 ? a * 9 + b + (b >= 4) + (a >= 4) : a * 4 + b;
}

// a tile's record holds two copies: rows along y, then rows along x
template <int T>
constexpr int kSrcCopy = T == 8 ? 73 : 16;

// where a candidate's source block and references come from: the padded
// plane at grid position (xs[c % nx], ys[c / nx]), or the gathered arrays
// (row c of blocks / tops / lefts)
struct Inputs {
  const int16_t* plane;
  long long stride;
  int pad, nx;
  const int* xs;
  const int* ys;
  const int* blocks;
  const int* tops;
  const int* lefts;
  int Lt, Ll;
};

// per-class constants and the shared-memory layout, in 4-byte words
struct Shape {
  int w, h, bit_depth;
  int nA, nL, P;
  int G, MS, LM, TM, ntiles, ngroups;
  int nsteps, msplit;                        // mode steps, items per group
  int lg_G, lg_pm, lg_ntx;                   // log2 of G, a mode's tasks, w / T
  long long B;
  int raw_top, raw_left, raw_row, raw_per;   // raw staging, per candidate
  int pool_per, src_per, src_tile;           // padded strides
  // offsets
  int o_raw0, o_raw1, o_pool, o_src, o_cost, o_dc, o_par, o_corner, o_rmv,
      o_rs, o_taps, o_wl, o_soff, o_minfo, o_pp, total;
};

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

// the flat plane indices of candidate c's corner (where its top row and
// left column start) and of its first source sample
struct PlanePos {
  long long top, src;
};
__device__ __forceinline__ PlanePos plane_pos(const Inputs& in, int c) {
  const int cy = c / in.nx;
  const long long bx = __ldg(in.xs + c - cy * in.nx), by = __ldg(in.ys + cy);
  PlanePos p;
  p.top = (by + in.pad - 1) * in.stride + bx + in.pad - 1;
  p.src = (by + in.pad) * in.stride + bx + in.pad;
  return p;
}

// issue the copies of group grp's raw inputs into raw (cp.async)
template <bool GATHERED>
__device__ void stage_raw(const Inputs& in, const Shape& s, int* raw,
                          int grp) {
  const long long c0 = (long long)grp * s.G;
  const int G_live = (int)min((long long)s.G, s.B - c0);
  const int per = s.raw_per;
  if constexpr (GATHERED) {
    for (int k = threadIdx.x; k < G_live * s.nA; k += kThreads) {
      const int g = k / s.nA, j = k - g * s.nA;
      cp_async4(raw + g * per + j, in.tops + (c0 + g) * in.Lt + j);
    }
    for (int k = threadIdx.x; k < G_live * s.nL; k += kThreads) {
      const int g = k / s.nL, j = k - g * s.nL;
      cp_async4(raw + g * per + s.raw_top + j,
                in.lefts + (c0 + g) * in.Ll + j);
    }
    const int hw = s.w * s.h;
    for (int k = threadIdx.x; k < G_live * hw; k += kThreads) {
      const int g = k / hw, i = k - g * hw;
      cp_async4(raw + g * per + s.raw_top + s.raw_left + i,
                in.blocks + (c0 + g) * hw + i);
    }
  } else {
    // 4-byte copies of the aligned int16 pairs that hold a run's samples
    // (word q of a run starting at flat index f is the pair (f >> 1) + q,
    // so sample j sits at int16 (f & 1) + j); the plane's base is 4-byte
    // aligned (checked by the wrapper)
    const uint32_t* pw = reinterpret_cast<const uint32_t*>(in.plane);
    for (int k = threadIdx.x; k < G_live * s.raw_top; k += kThreads) {
      const int g = k / s.raw_top, q = k - g * s.raw_top;
      const PlanePos p = plane_pos(in, (int)(c0 + g));
      const long long last = (p.top + s.nA - 1) >> 1;
      const long long word = (p.top >> 1) + q;
      if (word <= last) cp_async4(raw + g * per + q, pw + word);
    }
    for (int k = threadIdx.x; k < G_live * s.nL; k += kThreads) {
      const int g = k / s.nL, j = k - g * s.nL;
      const PlanePos p = plane_pos(in, (int)(c0 + g));
      cp_async4(raw + g * per + s.raw_top + j,
                pw + ((p.top + j * in.stride) >> 1));
    }
    const int rw = s.raw_row;
    for (int k = threadIdx.x; k < G_live * s.h * rw; k += kThreads) {
      const int g = k / (s.h * rw), r = k - g * (s.h * rw);
      const int i = r / rw, q = r - i * rw;
      const PlanePos p = plane_pos(in, (int)(c0 + g));
      const long long f = p.src + i * in.stride;
      const long long last = (f + s.w - 1) >> 1;
      const long long word = (f >> 1) + q;
      if (word <= last)
        cp_async4(raw + g * per + s.raw_top + s.raw_left + i * rw + q,
                  pw + word);
    }
  }
}

// one planar (mode 0) or DC (mode 1) sample at (yy, xx) of a candidate
// whose pool is staged at `pool`
__device__ __forceinline__ int planar_dc(const Shape& s, const float* pool,
                                         int dc, int mode, int yy, int xx) {
  const int w = s.w, h = s.h;
  // planar uses the filtered references when w*h > 32 (MDIS)
  const bool mdis = mode == 0 && w * h > 32;
  const float* pt = pool + (mdis ? s.nA : 0);
  const float* pl = pool + 2 * s.nA + (mdis ? s.nL : 0);
  int v;
  if (mode == 0) {
    const int log2w = log2i(w), log2h = log2i(h);
    const int lc = f2i(pl[1 + yy]), trr = f2i(pt[1 + xx]);
    const int tr = f2i(pt[1 + w]), br = f2i(pl[1 + h]);
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
  v = v + ((wl * (f2i(pl[1 + yy]) - v) + wt * (f2i(pt[1 + xx]) - v) + 32) >>
           6);
  return clampi(v, 0, (1 << s.bit_depth) - 1);
}

// the pool, source tiles, DC values and zero costs of group grp from its
// raw copies
template <int T, bool GATHERED>
__device__ void build_group(const Inputs& in, const Shape& s, int* smem,
                            const int* raw, int grp, int G_live) {
  float* pool = reinterpret_cast<float*>(smem + s.o_pool);
  float* src = reinterpret_cast<float*>(smem + s.o_src);
  int* dc = smem + s.o_dc;
  int* cost = smem + s.o_cost;
  int* par = smem + s.o_par;      // plane form: the runs' int16 parities
  int* corner = smem + s.o_corner;
  const int w = s.w, h = s.h, n = 2 * w, m = 2 * h;
  const int sp = GATHERED ? 0 : (int)(in.stride & 1);
  // raw sample access: word j of a gathered run is its sample; a plane
  // run's words are the int16 pairs that hold its samples
  auto top_at = [&](int g, int j) -> int {
    const int* r = raw + g * s.raw_per;
    if constexpr (GATHERED)
      return r[j];
    else
      return reinterpret_cast<const int16_t*>(r)[(par[g] & 1) + j];
  };
  auto left_at = [&](int g, int j) -> int {
    const int* r = raw + g * s.raw_per + s.raw_top;
    if constexpr (GATHERED)
      return r[j];
    else
      return reinterpret_cast<const int16_t*>(r + j)[(par[g] ^ (j & sp)) & 1];
  };
  if constexpr (!GATHERED) {
    const long long c0 = (long long)grp * s.G;
    for (int g = threadIdx.x; g < G_live; g += kThreads) {
      const PlanePos p = plane_pos(in, (int)(c0 + g));
      par[g] = (int)(p.top & 1) | (int)((p.src & 1) << 1);
    }
    __syncthreads();
  }
  for (int g = threadIdx.x; g < G_live; g += kThreads) {
    corner[g] =
        (top_at(g, 0) + top_at(g, 1) + left_at(g, 0) + left_at(g, 1) + 2) >> 2;
    // DC: average of both sides (square) or of the longer side only
    const int denom = w == h ? (w << 1) : max(w, h);
    int sum = 0;
    if (w >= h)
      for (int x = 1; x <= w; ++x) sum += top_at(g, x);
    if (w <= h)
      for (int y = 1; y <= h; ++y) sum += left_at(g, y);
    dc[g] = (sum + (denom >> 1)) >> log2i(denom);
  }
  for (int k = threadIdx.x; k < s.G * kModes; k += kThreads) cost[k] = 0;
  __syncthreads();
  // [1 2 1] filtered halves (I.filter_reference), int16 as the reference
  for (int k = threadIdx.x; k < G_live * s.nA; k += kThreads) {
    const int g = k / s.nA, j = k - g * s.nA;
    float* pl = pool + g * s.pool_per;
    const int t = top_at(g, j);
    const int ft = j == 0 ? corner[g]
                   : j < n ? (top_at(g, j - 1) + 2 * t + top_at(g, j + 1) + 2) >> 2
                           : top_at(g, n);
    pl[j] = (float)(int16_t)t;
    pl[s.nA + j] = (float)(int16_t)ft;
  }
  for (int k = threadIdx.x; k < G_live * s.nL; k += kThreads) {
    const int g = k / s.nL, j = k - g * s.nL;
    float* pl = pool + g * s.pool_per + 2 * s.nA;
    const int l = left_at(g, j);
    const int fl = j == 0 ? corner[g]
                   : j < m ? (left_at(g, j - 1) + 2 * l + left_at(g, j + 1) + 2) >> 2
                           : left_at(g, m);
    pl[j] = (float)(int16_t)l;
    pl[s.nL + j] = (float)(int16_t)fl;
  }
  // the source, tile-major, offset by 1.5 * 2^23 (w and h are powers of 2)
  const int ntx = w / T, lw = log2i(w), lhw = log2i(w * h);
  for (int k = threadIdx.x; k < G_live << lhw; k += kThreads) {
    const int g = k >> lhw, i = k & ((1 << lhw) - 1);
    const int y = i >> lw, x = i & (w - 1);
    const int* r = raw + g * s.raw_per + s.raw_top + s.raw_left;
    int v;
    if constexpr (GATHERED)
      v = r[i];
    else
      v = reinterpret_cast<const int16_t*>(r + y * s.raw_row)
          [(((par[g] >> 1) ^ (y & sp)) & 1) + x];
    const int tile = (y / T) * ntx + x / T;
    // two copies in mode coordinates: rows along y (vertical modes,
    // planar, DC) and rows along x (horizontal modes)
    const float f = __fadd_rn((float)(int16_t)v, kMagic);
    float* rec = src + g * s.src_per + tile * s.src_tile;
    rec[src_off<T>(y % T, x % T)] = f;
    rec[kSrcCopy<T> + src_off<T>(x % T, y % T)] = f;
  }
  __syncthreads();  // the pool and the DC values
  // the planar and DC predictions (the tasks of modes 0 and 1 read them),
  // uint16, [candidate][mode][tile][T * T]
  uint16_t* pp = reinterpret_cast<uint16_t*>(smem + s.o_pp);
  for (int k = threadIdx.x; k < G_live << (lhw + 1); k += kThreads) {
    const int g = k >> (lhw + 1), r = k & ((2 << lhw) - 1);
    const int mode = r >> lhw, i = r & ((1 << lhw) - 1);
    const int y = i >> lw, x = i & (w - 1);
    const int tile = (y / T) * ntx + x / T;
    pp[((g * 2 + mode) * s.ntiles + tile) * T * T + (y % T) * T + x % T] =
        (uint16_t)planar_dc(s, pool + g * s.pool_per, dc[g], mode, y, x);
  }
}

// gather the step's per-(mode, candidate) rows and the modes' tables
__device__ void stage_step(const Shape& s, int* smem, int step, int G_live,
                           const int* __restrict__ gidx,
                           const int* __restrict__ rs_g,
                           const float* __restrict__ taps_g,
                           const float* __restrict__ wl_g,
                           const int* __restrict__ soff_g,
                           const int* __restrict__ minfo_g) {
  const float* pool = reinterpret_cast<const float*>(smem + s.o_pool);
  float* rmv = reinterpret_cast<float*>(smem + s.o_rmv);
  int* rs = smem + s.o_rs;
  float4* taps = reinterpret_cast<float4*>(smem + s.o_taps);
  float* wl = reinterpret_cast<float*>(smem + s.o_wl);
  int* soff = smem + s.o_soff;
  int* minfo = smem + s.o_minfo;
  const int m0 = step * s.MS;
  // a warp per (slot, candidate) row, its lanes along the mode's list
  // (coalesced index reads); minfo_g[.][3] is the list's length
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = warp; k < s.MS * s.G; k += kThreads / 32) {
    const int slot = k / s.G, g = k - slot * s.G;
    const int mode = m0 + slot;
    if (mode < 2 || mode >= kModes || g >= G_live) continue;
    const int* gi = gidx + (mode - 2) * s.LM;
    const int len = __ldg(minfo_g + (mode - 2) * 4 + 3);
    const float* pl = pool + g * s.pool_per;
    float* dst = rmv + k * s.LM;
#pragma unroll 4
    for (int i = lane; i < len; i += 32) dst[i] = pl[__ldg(gi + i)];
  }
  for (int k = threadIdx.x; k < s.MS * s.TM; k += kThreads) {
    const int slot = k / s.TM, row = k - slot * s.TM;
    const int mode = m0 + slot;
    if (mode < 2 || mode >= kModes) continue;
    const int mi = mode - 2;
    rs[k] = __ldg(rs_g + mi * s.TM + row);
    taps[k] = __ldg(reinterpret_cast<const float4*>(taps_g) + mi * s.TM + row);
  }
  for (int k = threadIdx.x; k < s.MS * kPdpcCols; k += kThreads) {
    const int slot = k / kPdpcCols, x = k - slot * kPdpcCols;
    const int mode = m0 + slot;
    if (mode < 2 || mode >= kModes) continue;
    wl[k] = __ldg(wl_g + (mode - 2) * kPdpcCols + x);
    soff[k] = __ldg(soff_g + (mode - 2) * kPdpcCols + x);
  }
  for (int k = threadIdx.x; k < s.MS * 4; k += kThreads) {
    const int slot = k / 4, mode = m0 + slot;
    if (mode >= 2 && mode < kModes)
      minfo[k] = __ldg(minfo_g + (mode - 2) * 4 + (k - slot * 4));
  }
}

// the residual (source minus prediction) of mode rows a0 .. a0 + 3 of one
// angular task into d[a][b] (mode coordinates: a along the mode's rows, b
// along a row); srct is the tile's source copy in the mode's coordinates;
// PDPC: the mode has PDPC and the tile reaches its columns
template <int T, bool PDPC>
__device__ __forceinline__ void angular_rows(
    const Shape& s, const float* row_vals, const float* srct, const int* rs,
    const float4* taps, const float* wl, const int* soff, int flags, int SB,
    int TL, int r0, int c0, int a0, float* d) {
  const float vmax = kMagic + (float)((1 << s.bit_depth) - 1);
  const bool ang0 = flags & kFlagAng0;
  const float tl = ang0 ? row_vals[TL] : 0.f;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = r0 + a0 + a;
    const float4 f = taps[row];
    const float* win = row_vals + rs[row] + c0;
    float wv[T + 3];
#pragma unroll
    for (int c = 0; c < T + 3; ++c) wv[c] = win[c];
#pragma unroll
    for (int b = 0; b < T; ++b) {
      float acc = __fmaf_rn(wv[b], f.x, 0.5f);
      acc = __fmaf_rn(wv[b + 1], f.y, acc);
      acc = __fmaf_rn(wv[b + 2], f.z, acc);
      acc = __fmaf_rn(wv[b + 3], f.w, acc);
      // clip((acc + 32) >> 6, 0, maxval), offset by 1.5 * 2^23
      float y = fminf(fmaxf(shr6_magic(acc), kMagic), vmax);
      if (PDPC && c0 + b < kPdpcCols) {
        const float wlb = wl[c0 + b];
        if (wlb != 0.f) {
          const float lval = row_vals[SB + row + soff[c0 + b]];
          const float v = __fsub_rn(y, kMagic);
          const float base = __fsub_rn(lval, ang0 ? tl : v);
          const float q =
              __fsub_rn(shr6_magic(__fmaf_rn(base, wlb, 0.5f)), kMagic);
          y = fminf(fmaxf(__fadd_rn(__fadd_rn(v, q), kMagic), kMagic), vmax);
        }
      }
      d[a * T + b] = __fsub_rn(srct[src_off<T>(a0 + a, b)], y);
    }
  }
}

template <int T, bool GATHERED>
__global__ void __launch_bounds__(kThreads, T == 8 ? 3 : 4)
    presel_costs_kernel(const Inputs in, int* __restrict__ out, const Shape s,
                        const int* __restrict__ gidx,
                        const int* __restrict__ rs_g,
                        const float* __restrict__ taps_g,
                        const float* __restrict__ wl_g,
                        const int* __restrict__ soff_g,
                        const int* __restrict__ minfo_g) {
  constexpr int L = kLanes<T>;
  extern __shared__ int smem[];
  const int w = s.w, ntx = w / T;
  const int per_mode = s.G * s.ntiles * L;     // a multiple of 32
  const int lane = threadIdx.x & 31;
  const float* pool = reinterpret_cast<const float*>(smem + s.o_pool);
  const float* srcs = reinterpret_cast<const float*>(smem + s.o_src);
  const float* rmv = reinterpret_cast<const float*>(smem + s.o_rmv);
  int* cost = smem + s.o_cost;

  // work items (group, part): part p of a group runs its mode steps
  // [p * nsteps / msplit, (p + 1) * nsteps / msplit)
  const long long items = (long long)s.ngroups * s.msplit;
  long long item = blockIdx.x;
  if (item >= items) return;
  stage_raw<GATHERED>(in, s, smem + s.o_raw0, (int)(item / s.msplit));
  cp_async_commit();
  for (int it = 0; item < items; item += gridDim.x, ++it) {
    const int grp = (int)(item / s.msplit);
    const int part = (int)(item - (long long)grp * s.msplit);
    const int* raw = smem + ((it & 1) ? s.o_raw1 : s.o_raw0);
    const long long next = item + gridDim.x;
    if (next < items) {
      stage_raw<GATHERED>(in, s, smem + ((it & 1) ? s.o_raw0 : s.o_raw1),
                          (int)(next / s.msplit));
      cp_async_commit();
      cp_async_wait_all_but_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const long long c0 = (long long)grp * s.G;
    const int G_live = (int)min((long long)s.G, s.B - c0);
    build_group<T, GATHERED>(in, s, smem, raw, grp, G_live);
    const int st0 = part * s.nsteps / s.msplit;
    const int st1 = (part + 1) * s.nsteps / s.msplit;
    for (int step = st0; step < st1; ++step) {
      __syncthreads();
      stage_step(s, smem, step, G_live, gidx, rs_g, taps_g, wl_g, soff_g,
                 minfo_g);
      __syncthreads();
      // (slot, tile, candidate, half) tasks, half then candidate fastest:
      // a warp holds one mode
      for (int t = threadIdx.x; t < s.MS * per_mode; t += kThreads) {
        const int slot = t >> s.lg_pm;
        const int mode = step * s.MS + slot;
        if (mode >= kModes) break;                // warp-uniform
        const int r = t & (per_mode - 1);
        const int half = r % L, q = r / L;
        const int tile = q >> s.lg_G, g = q & (s.G - 1);
        const int y0 = (tile >> s.lg_ntx) * T, x0 = (tile & (ntx - 1)) * T;
        const int a0 = 4 * half;
        const bool live = g < G_live;
        float d[4 * T];
        if (live) {
          const float* srct = srcs + g * s.src_per + tile * s.src_tile;
          if (mode < 2) {
            // staged by build_group; 0x4B400000 | v is 1.5 * 2^23 + v
            const uint16_t* pp = reinterpret_cast<const uint16_t*>(
                smem + s.o_pp) + ((g * 2 + mode) * s.ntiles + tile) * T * T;
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int b = 0; b < T; ++b)
                d[a * T + b] = __fsub_rn(
                    srct[src_off<T>(a0 + a, b)],
                    __uint_as_float(0x4B400000u | pp[(a0 + a) * T + b]));
          } else {
            const int* mi = smem + s.o_minfo + slot * 4;
            const int flags = mi[0];
            const float* row_vals = rmv + (slot * s.G + g) * s.LM;
            const int* rs = smem + s.o_rs + slot * s.TM;
            const float4* taps =
                reinterpret_cast<const float4*>(smem + s.o_taps) + slot * s.TM;
            const float* wl =
                reinterpret_cast<const float*>(smem + s.o_wl) + slot * kPdpcCols;
            const int* soff = smem + s.o_soff + slot * kPdpcCols;
            const bool ver = flags & kFlagVer;
            const int r0 = ver ? y0 : x0, c0 = ver ? x0 : y0;
            const float* sm = srct + (ver ? 0 : kSrcCopy<T>);
            if ((flags & kFlagPdpc) && c0 < kPdpcCols)
              angular_rows<T, true>(s, row_vals, sm, rs, taps, wl, soff,
                                    flags, mi[1], mi[2], r0, c0, a0, d);
            else
              angular_rows<T, false>(s, row_vals, sm, rs, taps, wl, soff,
                                     flags, mi[1], mi[2], r0, c0, a0, d);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4 * T; ++i) d[i] = 0.f;
        }
        // the Hadamard in mode coordinates (the absolute sum does not
        // depend on the orientation): the whole T-point transform along b,
        // the 4-point stages along a in the lane, and for T = 8 the last
        // stage (rows a, a + 4) across the tile's two lanes
#pragma unroll
        for (int a = 0; a < 4; ++a) wht<T>(d + a * T, 1);
#pragma unroll
        for (int b = 0; b < T; ++b) wht<4>(d + b, T);
        if (T == 8) {
#pragma unroll
          for (int i = 0; i < 4 * T; ++i) {
            const float other = __shfl_xor_sync(0xffffffffu, d[i], 1);
            d[i] = half ? __fsub_rn(other, d[i]) : __fadd_rn(d[i], other);
          }
        }
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 4 * T; ++i) sum = __fadd_rn(sum, fabsf(d[i]));
        int val;
        if (T == 8) {
          sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
          val = half || !live ? 0 : (__float2int_rn(sum) + 2) >> 2;
        } else {
          const int isum = __float2int_rn(sum);
          const int dct = __float2int_rn(fabsf(d[0]));
          val = live ? ((isum - dct + (dct >> 2)) + 1) >> 1 : 0;
        }
        // the warp's lanes with one candidate are L * G apart
        for (int o = 16; o >= L * s.G; o >>= 1)
          val += __shfl_xor_sync(0xffffffffu, val, o);
        if (lane < L * s.G && half == 0 && live)
          atomicAdd(cost + g * kModes + mode, val);
      }
    }
    __syncthreads();
    // this part's modes
    const int m0 = st0 * s.MS, nm = min(kModes, st1 * s.MS) - m0;
    for (int k = threadIdx.x; k < G_live * nm; k += kThreads) {
      const int g = k / nm, m = m0 + (k - g * nm);
      out[(c0 + g) * kModes + m] = cost[g * kModes + m];
    }
  }
}

// the class's launch shape: group size, mode step and shared-memory
// layout (4-byte words)
Shape make_shape(int w, int h, int bit_depth, int nA, int nL, long long B,
                 int LM, bool gathered) {
  Shape s = {};
  const int T = (w % 8 == 0 && h % 8 == 0) ? 8 : 4;
  s.w = w;
  s.h = h;
  s.bit_depth = bit_depth;
  s.nA = nA;
  s.nL = nL;
  s.P = 2 * nA + 2 * nL;
  s.ntiles = (w / T) * (h / T);
  const int L = T / 4;                           // lanes per tile
  // G candidates so that a mode's tasks fill 2 warps (1 for the classes
  // of one or two lanes a candidate), two tasks a thread per step (one
  // for those)
  const int lanes = s.ntiles * L, fill = lanes >= 4 ? 64 : 32;
  s.G = lanes >= fill ? 1 : fill / lanes;
  const int per_mode = s.G * lanes;
  const int tasks = (fill == 64 ? 2 : 1) * kThreads;
  s.MS = per_mode >= tasks ? 1 : tasks / per_mode;
  s.lg_G = 31 - __builtin_clz(s.G);
  s.lg_pm = 31 - __builtin_clz(per_mode);
  s.lg_ntx = 31 - __builtin_clz(w / T);
  s.LM = LM;
  s.TM = w > h ? w : h;
  s.B = B;
  s.ngroups = (int)((B + s.G - 1) / s.G);
  if (gathered) {
    s.raw_top = nA;
    s.raw_left = nL;
    s.raw_row = w;
  } else {
    s.raw_top = (nA + 2) >> 1;
    s.raw_left = nL;
    s.raw_row = (w >> 1) + 1;
  }
  s.raw_per = s.raw_top + s.raw_left + h * s.raw_row;
  s.pool_per = s.P | 1;
  // candidate-fastest lanes on distinct banks (see src_off): T = 4, two
  // copies of 16 at an odd stride; T = 8, two copies of 73 at a stride of
  // 2 (mod 32), the halves of a tile 37 words apart
  s.src_tile = T == 8 ? 162 : 33;
  s.src_per = s.ntiles * s.src_tile;
  // fewer modes a step where the step's rows would cost a resident block
  // (the aim: 3 blocks of 256 threads per SM), down to a task a thread
  for (;;) {
    int o = 0;
    s.o_raw0 = o;  o += s.G * s.raw_per;
    s.o_raw1 = o;  o += s.G * s.raw_per;
    s.o_pool = o;  o += s.G * s.pool_per;
    s.o_src = o;   o += s.G * s.src_per;
    s.o_cost = o;  o += s.G * kModes;
    s.o_dc = o;    o += s.G;
    s.o_par = o;   o += s.G;
    s.o_corner = o; o += s.G;
    s.o_rmv = o;   o += s.MS * s.G * s.LM;
    s.o_rs = o;    o += s.MS * s.TM;
    o = (o + 3) & ~3;                              // float4 alignment
    s.o_taps = o;  o += 4 * s.MS * s.TM;
    s.o_wl = o;    o += s.MS * kPdpcCols;
    s.o_soff = o;  o += s.MS * kPdpcCols;
    s.o_minfo = o; o += 4 * s.MS;
    s.o_pp = o;    o += s.G * w * h;                // uint16 [G][2][w * h]
    s.total = o;
    if (s.total * 4 <= kSmemAim || s.MS * per_mode <= kThreads) break;
    s.MS >>= 1;
  }
  s.nsteps = (kModes + s.MS - 1) / s.MS;
  s.msplit = 1;
  return s;
}

const void* kernel_for(int T, bool gathered) {
  if (T == 8)
    return gathered ? (const void*)presel_costs_kernel<8, true>
                    : (const void*)presel_costs_kernel<8, false>;
  return gathered ? (const void*)presel_costs_kernel<4, true>
                  : (const void*)presel_costs_kernel<4, false>;
}

// resident blocks per SM of the class's kernel at its shared memory
cudaError_t occupancy(const Shape& s, bool gathered, int* blocks) {
  const int T = (s.w % 8 == 0 && s.h % 8 == 0) ? 8 : 4;
  const void* f = kernel_for(T, gathered);
  const size_t shm = (size_t)s.total * 4;
  cudaError_t e = cudaFuncSetAttribute(
      f, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, f, kThreads,
                                                       shm);
}

struct Tables {
  const int* gidx;
  const int* rs;
  const float* taps;
  const float* wl;
  const int* soff;
  const int* minfo;
  int LM;
};

template <bool GATHERED>
int launch(const Inputs& in, long long B, void* out, int w, int h,
           int bit_depth, int nA, int nL, const Tables& t, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (w < 4 || h < 4 || w > 64 || h > 64 || (w & (w - 1)) || (h & (h - 1)) ||
      B <= 0 || t.LM <= 0)
    return (int)cudaErrorInvalidValue;
  Shape s = make_shape(w, h, bit_depth, nA, nL, B, t.LM, GATHERED);
  int blocks = 0, dev = 0, sms = 0;
  cudaError_t e = occupancy(s, GATHERED, &blocks);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  const long long slots = (long long)blocks * sms;
  // a class that leaves most resident blocks idle: each group's mode
  // steps split over up to nsteps work items, no more than one wave
  const long long fill = slots / s.ngroups;
  if (fill >= 2) s.msplit = (int)(fill < s.nsteps ? fill : s.nsteps);
  const long long items = (long long)s.ngroups * s.msplit;
  const int grid = (int)(items < slots ? items : slots);
  const size_t shm = (size_t)s.total * 4;
  cudaStream_t st = (cudaStream_t)stream;
  const int T = (w % 8 == 0 && h % 8 == 0) ? 8 : 4;
  if (T == 8)
    presel_costs_kernel<8, GATHERED><<<grid, kThreads, shm, st>>>(
        in, (int*)out, s, t.gidx, t.rs, t.taps, t.wl, t.soff, t.minfo);
  else
    presel_costs_kernel<4, GATHERED><<<grid, kThreads, shm, st>>>(
        in, (int*)out, s, t.gidx, t.rs, t.taps, t.wl, t.soff, t.minfo);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// plane [rows, stride] int16 (the picture edge-padded by `pad`, its base
// 4-byte aligned), xs [nx] / ys [ny] int32 grid positions in picture
// coordinates, out [ny*nx, 67] int32; the tables are
// ops/tables.presel_device_tables(w, h, 2w+3, 2h+3).  Returns
// cudaGetLastError() after the launch on `stream`.
extern "C" int vt_presel_costs(
    const void* plane, long long stride, int pad, const void* xs, int nx,
    const void* ys, int ny, void* out, int w, int h, int bit_depth,
    const void* gidx, const void* rs, const void* taps, const void* wl,
    const void* soff, const void* minfo, int LM, void* stream) {
  if (nx <= 0 || ny <= 0 || ((uintptr_t)plane & 3))
    return (int)cudaErrorInvalidValue;
  Inputs in = {};
  in.plane = (const int16_t*)plane;
  in.stride = stride;
  in.pad = pad;
  in.nx = nx;
  in.xs = (const int*)xs;
  in.ys = (const int*)ys;
  const Tables t = {(const int*)gidx, (const int*)rs, (const float*)taps,
                    (const float*)wl, (const int*)soff, (const int*)minfo, LM};
  return launch<false>(in, (long long)nx * ny, out, w, h, bit_depth,
                       2 * w + 3, 2 * h + 3, t, stream);
}

// blocks [B, h, w], tops [B, Lt] (Lt >= 2w+3), lefts [B, Ll] (Ll >= 2h+3)
// int32, out [B, 67] int32; nA / nL = the pool's segment lengths
// (min(Lt, LPAD), min(Ll, LPAD)); the tables are
// ops/tables.presel_device_tables(w, h, nA, nL).  Returns
// cudaGetLastError() after the launch on `stream`.
extern "C" int vt_presel_costs_gathered(
    const void* blocks, const void* tops, int Lt, const void* lefts, int Ll,
    long long B, void* out, int w, int h, int bit_depth, int nA, int nL,
    const void* gidx, const void* rs, const void* taps, const void* wl,
    const void* soff, const void* minfo, int LM, void* stream) {
  if (nA < 2 * w + 3 || nA > Lt || nL < 2 * h + 3 || nL > Ll)
    return (int)cudaErrorInvalidValue;
  Inputs in = {};
  in.blocks = (const int*)blocks;
  in.tops = (const int*)tops;
  in.lefts = (const int*)lefts;
  in.Lt = Lt;
  in.Ll = Ll;
  const Tables t = {(const int*)gidx, (const int*)rs, (const float*)taps,
                    (const float*)wl, (const int*)soff, (const int*)minfo, LM};
  return launch<true>(in, B, out, w, h, bit_depth, nA, nL, t, stream);
}

// the resources of the kernel a (w, h) class launches (plane form, or the
// gathered entry at its narrowest pool) with the pool list width LM of its
// tables: out = registers per thread, static and dynamic shared memory
// bytes, threads per block, resident blocks per SM, local memory bytes
// per thread.
extern "C" int vt_presel_costs_attrs(int w, int h, int gathered, int LM,
                                     int* out) {
  const int T = (w % 8 == 0 && h % 8 == 0) ? 8 : 4;
  const Shape s = make_shape(w, h, 10, 2 * w + 3, 2 * h + 3, 1, LM,
                             gathered != 0);
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel_for(T, gathered != 0));
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = occupancy(s, gathered != 0, &blocks);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = s.total * 4;
  out[3] = kThreads;
  out[4] = blocks;
  out[5] = (int)a.localSizeBytes;
  return 0;
}

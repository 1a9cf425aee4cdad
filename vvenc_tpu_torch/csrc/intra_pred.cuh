// The per-sample arithmetic of the 67 luma intra predictions, shared by
// K1 (intra_pred_all.cu, every mode of every candidate) and K3's
// reference entry (plan_trial.cu, vt_plan_trial_refs: only the k
// survivors of each candidate), so that the two cannot drift apart.
//
// The arithmetic is vvenc_tpu/ops/intra_presel.py:63 predict_all_modes
// (with _filter_refs_jnp :45 and _pdpc_planar_dc_jnp :217): [1 2 1]
// reference smoothing, the 65 angular modes as 4-tap sums over the (raw or
// filtered) reference pool driven by the static tables of
// ops/intra_vec._shape_tables(w, h, True, 0) (uploaded by
// ops/tables.device_tables), PDPC on the angular support slab, planar and
// DC with their PDPC.
//
// A candidate's pool is [top | ftop | left | fleft], LPAD int32 samples
// each, in shared memory: pool_load copies the raw halves, pool_filter
// (after a barrier) builds the filtered ones, pool_dc gives the DC value;
// pred_sample then gives any (mode, y, x) sample.  The angular modes read
// the pool through an int16 cast, as the reference's int16 pool does;
// planar and DC read the int32 values.
#pragma once
#include <stdint.h>

namespace intra_pred {

constexpr int kFlagVer = 1, kFlagPdpc = 2, kFlagAng0 = 4;  // ops/tables.py

// K1's tables of one (w, h) class (ops/tables.device_tables)
struct Tables {
  const int* rm_flat;
  const int* row_start;
  const int* filt;
  const int* mode_info;
  const int* pdpc_wl;
  const int* side_flat;
  int LPAD, LR, TM, B0;
};

__device__ __forceinline__ int clip(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int ilog2(int v) { return 31 - __clz(v); }

// the raw halves of one candidate's pool from its reference rows, by the
// threads t0, t0 + nt, ...
__device__ __forceinline__ void pool_load(const int* __restrict__ tp,
                                          const int* __restrict__ lp,
                                          int* pool, int LPAD, int t0,
                                          int nt) {
  for (int j = t0; j < LPAD; j += nt) {
    pool[j] = tp[j];
    pool[2 * LPAD + j] = lp[j];
  }
}

// the filtered halves (I.filter_reference), after the raw halves are
// visible to the calling threads
__device__ __forceinline__ void pool_filter(int* pool, int LPAD, int w,
                                            int h, int t0, int nt) {
  const int* top = pool;
  const int* left = pool + 2 * LPAD;
  int* ftop = pool + LPAD;
  int* fleft = pool + 3 * LPAD;
  const int corner = (top[0] + top[1] + left[0] + left[1] + 2) >> 2;
  const int n = 2 * w, m = 2 * h;
  for (int j = t0; j < LPAD; j += nt) {
    ftop[j] = j == 0 ? corner
              : j < n ? (top[j - 1] + 2 * top[j] + top[j + 1] + 2) >> 2
                      : top[n];
    fleft[j] = j == 0 ? corner
               : j < m ? (left[j - 1] + 2 * left[j] + left[j + 1] + 2) >> 2
                       : left[m];
  }
}

// DC: the average of both sides (square) or of the longer side only
__device__ __forceinline__ int pool_dc(const int* pool, int LPAD, int w,
                                       int h) {
  const int* top = pool;
  const int* left = pool + 2 * LPAD;
  const int denom = w == h ? (w << 1) : (w > h ? w : h);
  int s = 0;
  if (w >= h)
    for (int x = 1; x <= w; ++x) s += top[x];
  if (w <= h)
    for (int y = 1; y <= h; ++y) s += left[y];
  return (s + (denom >> 1)) >> ilog2(denom);
}

// pool_dc by the 32 lanes of a warp (every lane gets the value): the same
// integer sum, taken a lane a sample
__device__ __forceinline__ int pool_dc_warp(const int* pool, int LPAD, int w,
                                            int h, int lane) {
  const int* top = pool;
  const int* left = pool + 2 * LPAD;
  const int denom = w == h ? (w << 1) : (w > h ? w : h);
  int s = 0;
  if (w >= h)
    for (int x = 1 + lane; x <= w; x += 32) s += top[x];
  if (w <= h)
    for (int y = 1 + lane; y <= h; y += 32) s += left[y];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return (s + (denom >> 1)) >> ilog2(denom);
}

// sample (yy, xx) of planar (mode 0) or DC (mode 1) of the candidate
// whose pool (raw and filtered halves) and DC value are given: planar with
// its MDIS (filtered references when w*h > 32), both with their PDPC
__device__ __forceinline__ int planar_dc_sample(const int* pool, int dc,
                                                int LPAD, int w, int h,
                                                int bit_depth, int mode,
                                                int yy, int xx) {
  const bool mdis = mode == 0 && w * h > 32;
  const int* ptop = pool + (mdis ? LPAD : 0);
  const int* pleft = pool + (mdis ? 3 * LPAD : 2 * LPAD);
  int v;
  if (mode == 0) {
    const int log2w = ilog2(w), log2h = ilog2(h);
    const int lc = pleft[1 + yy], trr = ptop[1 + xx];
    const int tr = ptop[1 + w], br = pleft[1 + h];
    const int hor = lc * (1 << log2w) + (xx + 1) * (tr - lc);
    const int ver = trr * (1 << log2h) + (yy + 1) * (br - trr);
    v = (hor * (1 << log2h) + ver * (1 << log2w) +
         (1 << (log2w + log2h))) >> (1 + log2w + log2h);
  } else {
    v = dc;
  }
  // planar/DC PDPC weight scale
  const int pscale = (ilog2(w * h) - 2) >> 2;
  const int wt = 32 >> min(31, (yy << 1) >> pscale);
  const int wl = 32 >> min(31, (xx << 1) >> pscale);
  v = v + ((wl * (pleft[1 + yy] - v) + wt * (ptop[1 + xx] - v) + 32) >> 6);
  return clip(v, 0, (1 << bit_depth) - 1);
}

// sample (yy, xx) of mode `mode` of the candidate whose pool (raw and
// filtered halves) and DC value are given
__device__ __forceinline__ int pred_sample(const int* pool, int dc,
                                           const Tables& t, int w, int h,
                                           int bit_depth, int mode, int yy,
                                           int xx) {
  if (mode < 2)
    return planar_dc_sample(pool, dc, t.LPAD, w, h, bit_depth, mode, yy, xx);
  const int maxval = (1 << bit_depth) - 1;
  int v;
  const int mi = mode - 2;
  const int shift = __ldg(t.mode_info + 4 * mi);
  const int rnd = __ldg(t.mode_info + 4 * mi + 1);
  const int flags = __ldg(t.mode_info + 4 * mi + 2);
  // main orientation: rows run along the mode's side
  const bool ver = flags & kFlagVer;
  const int row = ver ? yy : xx, col = ver ? xx : yy;
  const int* rm =
      t.rm_flat + mi * t.LR + __ldg(t.row_start + mi * t.TM + row) + col;
  const int* f = t.filt + (mi * t.TM + row) * 4;
  int acc = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    acc += __ldg(f + k) * (int)(int16_t)pool[__ldg(rm + k)];
  v = clip((acc + rnd) >> shift, 0, maxval);
  if (flags & kFlagPdpc) {
    const int wl = __ldg(t.pdpc_wl + mi * t.TM + col);
    if (wl != 0) {
      const int lval =
          (int16_t)pool[__ldg(t.side_flat + (mi * t.TM + row) * t.TM + col)];
      if (flags & kFlagAng0) {
        const int tl = (int16_t)pool[__ldg(t.rm_flat + mi * t.LR + t.B0)];
        v = clip(v + ((wl * (lval - tl) + 32) >> 6), 0, maxval);
      } else {
        v = v + ((wl * (lval - v) + 32) >> 6);
      }
    }
  }
  return clip(v, 0, maxval);
}

// R samples of mode `mode` along row `row` of its main orientation (rows
// along y for planar, DC and the vertical modes, along x for the
// horizontal ones), columns col0 .. col0 + R - 1 of a square class (w ==
// h), each equal to pred_sample's: out[i] is sample (y, x) = (row, col0 +
// i) when the call returns true, (col0 + i, row) when it returns false.
// An angular run reads its row's taps once and its R + 3 reference values
// once (neighbouring samples share 3 of their 4 taps' values).
template <int R>
__device__ __forceinline__ bool pred_run(const int* pool, int dc,
                                         const Tables& t, int w, int h,
                                         int bit_depth, int mode, int row,
                                         int col0, int* out) {
  if (mode < 2) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      out[i] = planar_dc_sample(pool, dc, t.LPAD, w, h, bit_depth, mode,
                                row, col0 + i);
    return true;
  }
  const int maxval = (1 << bit_depth) - 1;
  const int mi = mode - 2;
  const int shift = __ldg(t.mode_info + 4 * mi);
  const int rnd = __ldg(t.mode_info + 4 * mi + 1);
  const int flags = __ldg(t.mode_info + 4 * mi + 2);
  const int* rm =
      t.rm_flat + mi * t.LR + __ldg(t.row_start + mi * t.TM + row) + col0;
  const int* f = t.filt + (mi * t.TM + row) * 4;
  const int f0 = __ldg(f), f1 = __ldg(f + 1), f2 = __ldg(f + 2),
            f3 = __ldg(f + 3);
  int ref[R + 3];
#pragma unroll
  for (int j = 0; j < R + 3; ++j) ref[j] = (int)(int16_t)pool[__ldg(rm + j)];
  const bool pdpc = flags & kFlagPdpc;
  const int tl = pdpc && (flags & kFlagAng0)
                     ? (int)(int16_t)pool[__ldg(t.rm_flat + mi * t.LR + t.B0)]
                     : 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int acc = f0 * ref[i] + f1 * ref[i + 1] + f2 * ref[i + 2] +
                    f3 * ref[i + 3];
    int v = clip((acc + rnd) >> shift, 0, maxval);
    if (pdpc) {
      const int col = col0 + i;
      const int wl = __ldg(t.pdpc_wl + mi * t.TM + col);
      if (wl != 0) {
        const int lval = (int16_t)
            pool[__ldg(t.side_flat + (mi * t.TM + row) * t.TM + col)];
        if (flags & kFlagAng0)
          v = clip(v + ((wl * (lval - tl) + 32) >> 6), 0, maxval);
        else
          v = v + ((wl * (lval - v) + 32) >> 6);
      }
    }
    out[i] = clip(v, 0, maxval);
  }
  return flags & kFlagVer;
}

}  // namespace intra_pred

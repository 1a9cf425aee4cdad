// In-loop deblocking filter of one picture (H.266 8.8.3), called once per
// picture, or per CTU-row band, through ctypes (which releases the GIL for
// the whole call).
//
// Bit-exact port of codec/deblock.py deblock_picture with its default
// batched filtering (ops/deblock_batch.py): the per-4x4 boundary-strength
// maps (_BsMaps, vvenc xGetBoundaryStrengthSingle, LoopFilter.cpp:1022),
// the edge walk over the CU list (vertical edges of the picture, then
// horizontal; CU, affine sub-block, ISP, SBT and max-TB edges; chroma
// edges on the 8-sample grid of the chroma tree), the per-edge QP from the
// per-4x4 QP map with the caller's chroma mapping as a table, the filter
// lengths (xSetMaxFilterLengthPQFromTransformSizes:805), and the luma and
// chroma decisions and filters (xEdgeFilterLuma:1373,
// xEdgeFilterChroma:1523).  Luma segments of one direction are applied in
// plan_waves' dependency waves and chroma segments in one batch, each
// batch reading the samples as they were before it, as the numpy kernel
// does; samples outside the picture read as the nearest border sample.
//
// The CU list arrives flattened by native/deblock.py: one row of CU_F
// int32 per CU (layout enum CF), with max-TB transform units and
// affine / SbTMVP / GEO per-4x4 motion in two more arrays.  Both
// directions' edges are derived before any sample changes, so an index
// that the Python model would reject leaves the planes untouched and
// returns ERR_INPUT; the caller then runs the Python model.  No state
// outlives a call: threads may filter different pictures at once.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <vector>

namespace {

const int TC_TABLE[66] = {
    0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,
    0,   0,   0,   0,   3,   4,   4,   4,   4,   5,   5,   5,   5,   7,
    7,   8,   9,   10,  10,  11,  13,  14,  15,  17,  19,  21,  24,  25,
    29,  33,  36,  41,  45,  51,  57,  64,  71,  80,  89,  100, 112, 125,
    141, 157, 177, 198, 222, 250, 280, 314, 352, 395};
const int BETA_TABLE[64] = {
    0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,
    6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24,
    26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56,
    58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88};
constexpr int DEFAULT_INTRA_TC_OFFSET = 2;
constexpr int MAX_QP = 63;
const int DB7[7] = {59, 50, 41, 32, 23, 14, 5};
const int DB5[5] = {58, 45, 32, 19, 6};
const int DB3[3] = {53, 32, 11};
const int TCC7[7] = {6, 5, 4, 3, 2, 1, 1};
const int TCC3[3] = {6, 4, 2};
constexpr int MV_TH = 8;          // half-pel in 1/16 units
constexpr int NO_REF = -1000000000;

constexpr int ERR_INPUT = -1;     // an index the Python model would reject

// CU row layout (native/deblock.py writes it)
enum CF {
  C_X, C_Y, C_W, C_H, C_FLAGS, C_JOINT, C_ISP, C_ISP_W, C_ISP_H, C_SBT,
  C_SBT_POS, C_SBT_X, C_SBT_Y, C_SBT_W, C_SBT_H, C_TU0, C_NTU, C_MV_VALID,
  C_POC0, C_MV0X, C_MV0Y, C_POC1, C_MV1X, C_MV1Y, C_SUB0, CU_F
};
enum Flag {
  F_CHROMA_ONLY = 1, F_LUMA_ONLY = 2, F_INTER = 4, F_CIIP = 8,
  F_AFFINE = 16, F_SUB_MI = 32, F_CBF_Y = 64, F_CBF_CB = 128,
  F_CBF_CR = 256, F_MTB = 512, F_BDPCM_Y = 1024, F_BDPCM_C = 2048
};
constexpr int TU_F = 8;    // tx, ty, tw, th, cbf_y, cbf_cb, cbf_cr, joint
constexpr int SUB_F = 8;   // valid0, poc0, mv0x, mv0y, valid1, poc1, ...

// picture parameters
enum P {
  P_W, P_H, P_CW, P_CH, P_CTU, P_BD, P_IS_B, P_QP_Y, P_QP_CB, P_QP_CR,
  P_QPMAP, P_QPMAP_W, P_QPMAP_H, P_CQP_LO, P_CQP_N, P_BAND, P_BAND_Y0,
  P_BAND_Y1, P_N
};

template <class T>
struct Map {
  int h = 0, w = 0;
  std::vector<T> v;
  void init(int h_, int w_, T val) {
    h = h_;
    w = w_;
    v.assign(size_t(h) * w, val);
  }
  // numpy's slice assignment a[y0:y1, x0:x1] = val (non-negative bounds)
  void fill(int y0, int y1, int x0, int x1, T val) {
    y0 = std::min(y0, h), y1 = std::min(y1, h);
    x0 = std::min(x0, w), x1 = std::min(x1, w);
    for (int y = y0; y < y1; y++)
      for (int x = x0; x < x1; x++) v[size_t(y) * w + x] = val;
  }
};

struct LSeg {
  int x, y, qp, max_p, max_q, bs, at_ctu;
};
struct CSeg {
  int x, y, qp, large, at_ctu, bs;
};

inline int clipv(int v, int lo, int hi) { return std::min(std::max(v, lo), hi); }

struct Picture {
  const int32_t* prm;
  const int32_t* cus;
  int n_cus;
  const int32_t* tus;
  int n_tus;
  const int32_t* sub;
  int n_sub;
  const int32_t* qp_map;
  const int32_t* ctab;
  bool bad = false;

  int uw, uh;
  Map<int32_t> cu_w, cu_h, refpoc[2], mvx[2], mvy[2], cblk_w, cblk_h;
  Map<uint8_t> intra, cbf[3], joint3, subblk, ciip, bdpcm_y, bdpcm_c, cintra;
  std::vector<LSeg> lsegs[2];        // [vertical, horizontal]
  std::vector<CSeg> csegs[2][2];     // [direction][Cb, Cr]

  const int32_t* cu(int i) const { return cus + size_t(i) * CU_F; }

  bool in(int y, int x, int h, int w) {
    if (y < 0 || x < 0 || y >= h || x >= w) {
      bad = true;
      return false;
    }
    return true;
  }
  template <class T>
  T at(const Map<T>& m, int y, int x) {
    return in(y, x, m.h, m.w) ? m.v[size_t(y) * m.w + x] : T(0);
  }

  // ---- _BsMaps ----------------------------------------------------------
  void build_maps() {
    const int w = prm[P_W], h = prm[P_H];
    uw = w / 4, uh = h / 4;
    cu_w.init(uh, uw, 0);
    cu_h.init(uh, uw, 0);
    intra.init(uh, uw, 1);
    for (int c = 0; c < 3; c++) cbf[c].init(uh, uw, 0);
    joint3.init(uh, uw, 0);
    for (int l = 0; l < 2; l++) {
      mvx[l].init(uh, uw, 0);
      mvy[l].init(uh, uw, 0);
      refpoc[l].init(uh, uw, NO_REF);
    }
    subblk.init(uh, uw, 0);
    ciip.init(uh, uw, 0);
    bdpcm_y.init(uh, uw, 0);
    bdpcm_c.init(uh, uw, 0);
    cintra.init(uh, uw, 1);
    for (int i = 0; i < n_cus; i++) {
      const int32_t* c = cu(i);
      const int x = c[C_X], y = c[C_Y], cw = c[C_W], ch = c[C_H];
      const int f = c[C_FLAGS], joint = c[C_JOINT];
      if (x < 0 || y < 0 || c[C_TU0] + c[C_NTU] > n_tus) {
        bad = true;
        return;
      }
      const int y0 = y >> 2, y1 = (y + ch) >> 2, x0 = x >> 2,
                x1 = (x + cw) >> 2;
      if (joint == 3) joint3.fill(y0, y1, x0, x1, 1);
      if (f & F_CHROMA_ONLY) {
        cbf[1].fill(y0, y1, x0, x1, (f & F_CBF_CB) || joint != 0);
        cbf[2].fill(y0, y1, x0, x1, (f & F_CBF_CR) || joint != 0);
        cintra.fill(y0, y1, x0, x1, 1);
        if (f & F_BDPCM_C) bdpcm_c.fill(y0, y1, x0, x1, 1);
        continue;
      }
      const int isp = c[C_ISP], sbt = c[C_SBT];
      int ry0 = 0, ry1 = 0, rx0 = 0, rx1 = 0;   // the SBT residual TU
      if (isp) {
        cu_w.fill(y0, y1, x0, x1, c[C_ISP_W]);
        cu_h.fill(y0, y1, x0, x1, c[C_ISP_H]);
      } else if (sbt) {
        const int tx = c[C_SBT_X], ty = c[C_SBT_Y], tw = c[C_SBT_W],
                  th = c[C_SBT_H];
        cu_w.fill(y0, y1, x0, x1, (sbt == 2 || sbt == 4) ? cw : cw - tw);
        cu_h.fill(y0, y1, x0, x1, (sbt == 1 || sbt == 3) ? ch : ch - th);
        ry0 = (y + ty) >> 2, ry1 = (y + ty + th) >> 2;
        rx0 = (x + tx) >> 2, rx1 = (x + tx + tw) >> 2;
        cu_w.fill(ry0, ry1, rx0, rx1, (sbt == 1 || sbt == 3) ? tw : cw);
        cu_h.fill(ry0, ry1, rx0, rx1, (sbt == 2 || sbt == 4) ? th : ch);
      } else if (f & F_MTB) {
        for (int k = 0; k < c[C_NTU]; k++) {
          const int32_t* t = tus + size_t(c[C_TU0] + k) * TU_F;
          const int ty0 = (y + t[1]) >> 2, ty1 = (y + t[1] + t[3]) >> 2;
          const int tx0 = (x + t[0]) >> 2, tx1 = (x + t[0] + t[2]) >> 2;
          cu_w.fill(ty0, ty1, tx0, tx1, t[2]);
          cu_h.fill(ty0, ty1, tx0, tx1, t[3]);
        }
      } else {
        cu_w.fill(y0, y1, x0, x1, cw);
        cu_h.fill(y0, y1, x0, x1, ch);
      }
      const bool inter = f & F_INTER;
      intra.fill(y0, y1, x0, x1, !inter);
      if (!(f & F_LUMA_ONLY)) cintra.fill(y0, y1, x0, x1, !inter);
      if (f & F_BDPCM_Y) bdpcm_y.fill(y0, y1, x0, x1, 1);
      if (f & F_BDPCM_C) bdpcm_c.fill(y0, y1, x0, x1, 1);
      if (sbt) {
        cbf[0].fill(ry0, ry1, rx0, rx1, (f & F_CBF_Y) != 0);
        cbf[1].fill(ry0, ry1, rx0, rx1, (f & F_CBF_CB) || joint != 0);
        cbf[2].fill(ry0, ry1, rx0, rx1, (f & F_CBF_CR) || joint != 0);
      } else if (f & F_MTB) {
        for (int k = 0; k < c[C_NTU]; k++) {
          const int32_t* t = tus + size_t(c[C_TU0] + k) * TU_F;
          const int ty0 = (y + t[1]) >> 2, ty1 = (y + t[1] + t[3]) >> 2;
          const int tx0 = (x + t[0]) >> 2, tx1 = (x + t[0] + t[2]) >> 2;
          cbf[0].fill(ty0, ty1, tx0, tx1, t[4] != 0);
          cbf[1].fill(ty0, ty1, tx0, tx1, t[5] != 0 || t[7] != 0);
          cbf[2].fill(ty0, ty1, tx0, tx1, t[6] != 0 || t[7] != 0);
          if (t[7] == 3) joint3.fill(ty0, ty1, tx0, tx1, 1);
        }
      } else {
        cbf[0].fill(y0, y1, x0, x1, (f & F_CBF_Y) != 0);
        if (!(f & F_LUMA_ONLY)) {
          cbf[1].fill(y0, y1, x0, x1, (f & F_CBF_CB) || joint != 0);
          cbf[2].fill(y0, y1, x0, x1, (f & F_CBF_CR) || joint != 0);
        }
      }
      if (!inter) continue;
      if (f & F_CIIP) ciip.fill(y0, y1, x0, x1, 1);
      if (f & F_SUB_MI) {
        if (f & F_AFFINE) subblk.fill(y0, y1, x0, x1, 1);
        if (c[C_SUB0] + std::max(0, y1 - y0) * std::max(0, x1 - x0) > n_sub) {
          bad = true;
          return;
        }
        const int32_t* s = sub + size_t(c[C_SUB0]) * SUB_F;
        for (int uy = y0; uy < y1; uy++)
          for (int ux = x0; ux < x1; ux++, s += SUB_F)
            for (int l = 0; l < 2; l++) {
              if (!s[4 * l]) continue;
              if (!in(uy, ux, uh, uw)) return;
              refpoc[l].v[size_t(uy) * uw + ux] = s[4 * l + 1];
              mvx[l].v[size_t(uy) * uw + ux] = s[4 * l + 2];
              mvy[l].v[size_t(uy) * uw + ux] = s[4 * l + 3];
            }
        continue;
      }
      for (int l = 0; l < 2; l++) {
        if (!(c[C_MV_VALID] & (1 << l))) continue;
        refpoc[l].fill(y0, y1, x0, x1, c[C_POC0 + 3 * l]);
        mvx[l].fill(y0, y1, x0, x1, c[C_MV0X + 3 * l]);
        mvy[l].fill(y0, y1, x0, x1, c[C_MV0Y + 3 * l]);
      }
    }
  }

  // chroma-tree block sizes (deblock_picture's cblk_w / cblk_h)
  void build_cblk() {
    const int cuw2 = std::max(1, (prm[P_W] >> 1) >> 1);
    const int cuh2 = std::max(1, (prm[P_H] >> 1) >> 1);
    cblk_w.init(cuh2, cuw2, 0);
    cblk_h.init(cuh2, cuw2, 0);
    for (int i = 0; i < n_cus; i++) {
      const int32_t* c = cu(i);
      if (c[C_FLAGS] & F_LUMA_ONLY) continue;
      const int x = c[C_X], y = c[C_Y], cw = c[C_W], ch = c[C_H];
      const int y0 = (y >> 1) >> 1, y1 = ((y + ch) >> 1) >> 1;
      const int x0 = (x >> 1) >> 1, x1 = ((x + cw) >> 1) >> 1;
      const int sbt = c[C_SBT];
      if (sbt) {
        const int tx = c[C_SBT_X], ty = c[C_SBT_Y], tw = c[C_SBT_W],
                  th = c[C_SBT_H];
        cblk_w.fill(y0, y1, x0, x1,
                    (sbt == 2 || sbt == 4) ? (cw >> 1) : (cw - tw) >> 1);
        cblk_h.fill(y0, y1, x0, x1,
                    (sbt == 1 || sbt == 3) ? (ch >> 1) : (ch - th) >> 1);
        const int ry0 = ((y + ty) >> 1) >> 1, ry1 = ((y + ty + th) >> 1) >> 1;
        const int rx0 = ((x + tx) >> 1) >> 1, rx1 = ((x + tx + tw) >> 1) >> 1;
        cblk_w.fill(ry0, ry1, rx0, rx1,
                    (sbt == 1 || sbt == 3) ? (tw >> 1) : (cw >> 1));
        cblk_h.fill(ry0, ry1, rx0, rx1,
                    (sbt == 2 || sbt == 4) ? (th >> 1) : (ch >> 1));
      } else if (c[C_FLAGS] & F_MTB) {
        for (int k = 0; k < c[C_NTU]; k++) {
          const int32_t* t = tus + size_t(c[C_TU0] + k) * TU_F;
          const int ty0 = ((y + t[1]) >> 1) >> 1;
          const int ty1 = ((y + t[1] + t[3]) >> 1) >> 1;
          const int tx0 = ((x + t[0]) >> 1) >> 1;
          const int tx1 = ((x + t[0] + t[2]) >> 1) >> 1;
          cblk_w.fill(ty0, ty1, tx0, tx1, t[2] >> 1);
          cblk_h.fill(ty0, ty1, tx0, tx1, t[3] >> 1);
        }
      } else {
        cblk_w.fill(y0, y1, x0, x1, cw >> 1);
        cblk_h.fill(y0, y1, x0, x1, ch >> 1);
      }
    }
  }

  // ---- _BsMaps.bs --------------------------------------------------------
  void bs(int py, int px, int qy, int qx, bool tu_edge, bool pu_edge,
          int out[3]) {
    out[0] = out[1] = out[2] = 0;
    if (!in(py, px, uh, uw) || !in(qy, qx, uh, uw)) return;
    const size_t p = size_t(py) * uw + px, q = size_t(qy) * uw + qx;
    const bool chroma_int = cintra.v[p] || cintra.v[q];
    const int bs_c_intra = (bdpcm_c.v[p] && bdpcm_c.v[q]) ? 0 : 2;
    if (intra.v[p] || intra.v[q]) {
      out[0] = (bdpcm_y.v[p] && bdpcm_y.v[q]) ? 0 : 2;
      out[1] = out[2] = bs_c_intra;
      return;
    }
    if (ciip.v[p] || ciip.v[q]) {
      out[0] = 2;
      out[1] = out[2] = chroma_int ? bs_c_intra : 2;
      return;
    }
    if (chroma_int) {
      out[1] = out[2] = bs_c_intra;
    } else {
      out[1] = (cbf[1].v[p] || cbf[1].v[q]) ? 1 : 0;
      out[2] = (cbf[2].v[p] || cbf[2].v[q]) ? 1 : 0;
    }
    if (tu_edge && (cbf[0].v[p] || cbf[0].v[q])) {
      out[0] = 1;
      return;
    }
    if (!pu_edge) return;
    const int rp0 = refpoc[0].v[p], rp1 = refpoc[1].v[p];
    const int rq0 = refpoc[0].v[q], rq1 = refpoc[1].v[q];
    auto far = [&](int lq, int lp) {   // far(mq<lq>, mp<lp>)
      return std::abs(mvx[lq].v[q] - mvx[lp].v[p]) >= MV_TH ||
             std::abs(mvy[lq].v[q] - mvy[lp].v[p]) >= MV_TH;
    };
    int m_bs;
    if (prm[P_IS_B]) {
      if ((rp0 == rq0 && rp1 == rq1) || (rp0 == rq1 && rp1 == rq0)) {
        if (rp0 != rp1) {
          if (rp0 == rq0)
            m_bs = (far(0, 0) || far(1, 1)) ? 1 : 0;
          else
            m_bs = (far(1, 0) || far(0, 1)) ? 1 : 0;
        } else {
          m_bs = ((far(0, 0) || far(1, 1)) && (far(1, 0) || far(0, 1))) ? 1
                                                                        : 0;
        }
      } else {
        m_bs = 1;
      }
    } else {
      m_bs = (rp0 != rq0 || far(0, 0)) ? 1 : 0;
    }
    out[0] = m_bs;
  }

  // ---- per-edge QP -------------------------------------------------------
  int qpm(int y, int x) {
    return in(y, x, prm[P_QPMAP_H], prm[P_QPMAP_W])
               ? qp_map[size_t(y) * prm[P_QPMAP_W] + x]
               : 0;
  }
  int luma_qp(int py, int px, int qy, int qx) {
    if (!prm[P_QPMAP]) return prm[P_QP_Y];
    return (qpm(py, px) + qpm(qy, qx) + 1) >> 1;
  }
  int cqp(int v, int comp, int joint) {
    const int k = v - prm[P_CQP_LO];
    if (k < 0 || k >= prm[P_CQP_N]) {
      bad = true;
      return 0;
    }
    return ctab[size_t((comp - 1) * 2 + joint) * prm[P_CQP_N] + k];
  }
  int chroma_qp(int py, int px, int qy, int qx, int comp) {
    if (!prm[P_QPMAP]) return comp == 1 ? prm[P_QP_CB] : prm[P_QP_CR];
    const int qp_p = cqp(qpm(py, px), comp, at(joint3, py, px));
    const int qp_q = cqp(qpm(qy, qx), comp, at(joint3, qy, qx));
    return (qp_p + qp_q + 1) >> 1;
  }

  static void luma_maxlen(int size_p, int size_q, bool p_sub, bool q_sub,
                          int& mp, int& mq) {
    if (size_p <= 4 || size_q <= 4) {
      mp = mq = 1;
      return;
    }
    mp = size_p >= 32 ? (p_sub ? 5 : 7) : 3;
    mq = size_q >= 32 ? 7 : 3;
    if (q_sub) mq = std::min(mq, 5);
  }
  static int sub_maxlen(int off, int size) {
    return (off == 8 || off + 8 >= size) ? 2 : 3;
  }

  // one luma segment across the edge between units P and Q
  void luma_edge(bool vert, int x, int y, int py, int px, int qy, int qx,
                 bool tu_edge, bool pu_edge, int at_ctu, int fixed_ml,
                 int mode, bool q_sub) {
    // mode 0: a CU edge, lengths from the TU sizes and P's sub-block
    // flag; 1: an affine sub-block edge, both lengths fixed_ml; 2: a
    // transform edge inside the CU (SBT, max-TB), both sides' sub-block
    // flag q_sub
    int b[3];
    bs(py, px, qy, qx, tu_edge, pu_edge, b);
    if (!b[0]) return;
    int mp, mq;
    if (mode == 1) {
      mp = mq = fixed_ml;
    } else {
      const Map<int32_t>& sz = vert ? cu_w : cu_h;
      const int sp = at(sz, py, px), sq = at(sz, qy, qx);
      luma_maxlen(sp, sq, mode == 0 ? at(subblk, py, px) != 0 : q_sub,
                  q_sub, mp, mq);
    }
    const int eqp = luma_qp(py, px, qy, qx);
    lsegs[vert ? 0 : 1].push_back({x, y, eqp, mp, mq, b[0], at_ctu});
  }

  void chroma_edge(bool vert, int x, int y, int py, int px, int qy, int qx,
                   bool pu_edge, int large, int at_ctu) {
    int b[3];
    bs(py, px, qy, qx, true, pu_edge, b);
    for (int comp = 1; comp <= 2; comp++) {
      const int bsc = b[comp];
      if (bsc == 2 || (large && bsc == 1)) {
        const int qpc = chroma_qp(py, px, qy, qx, comp);
        csegs[vert ? 0 : 1][comp - 1].push_back({x, y, qpc, large, at_ctu,
                                                 bsc});
      }
    }
  }

  // ---- the edge walk (deblock_picture's loops) ---------------------------
  void walk(bool vert) {
    const bool band = prm[P_BAND];
    const int by0 = prm[P_BAND_Y0], by1 = prm[P_BAND_Y1];
    const int ctu = prm[P_CTU];
    std::vector<int> tu_xs, tu_ys;
    auto has = [](const std::vector<int>& s, int v) {
      return std::find(s.begin(), s.end(), v) != s.end();
    };
    for (int i = 0; i < n_cus; i++) {
      const int32_t* c = cu(i);
      const int x = c[C_X], y = c[C_Y], w = c[C_W], h = c[C_H];
      const int f = c[C_FLAGS];
      if (band && !(by0 <= y && y < by1)) continue;
      if (f & F_CHROMA_ONLY) continue;
      const bool q_sub = f & F_AFFINE;
      const int isp = c[C_ISP], sbt = c[C_SBT], pos = c[C_SBT_POS];
      const int tx = c[C_SBT_X], ty = c[C_SBT_Y], tw = c[C_SBT_W],
                th = c[C_SBT_H];
      tu_xs.clear();
      tu_ys.clear();
      if (sbt) {
        if (sbt == 1 || sbt == 3)
          tu_xs.push_back(x + (pos == 0 ? tx + tw : tx));
        else
          tu_ys.push_back(y + (pos == 0 ? ty + th : ty));
      }
      if (f & F_MTB) {
        for (int o = 64; o < w; o += 64) tu_xs.push_back(x + o);
        for (int o = 64; o < h; o += 64) tu_ys.push_back(y + o);
      }
      if (vert) {
        if (x != 0)
          for (int yy = y; yy < y + h; yy += 4)
            luma_edge(true, x, yy, yy >> 2, (x - 1) >> 2, yy >> 2, x >> 2,
                      true, true, 0, 0, 0, q_sub);
        if (q_sub)
          for (int off = 8; off < w; off += 8) {
            const int xi = x + off;
            if (has(tu_xs, xi)) continue;
            const int ml = sub_maxlen(off, w);
            for (int yy = y; yy < y + h; yy += 4)
              luma_edge(true, xi, yy, yy >> 2, (xi - 1) >> 2, yy >> 2,
                        xi >> 2, false, true, 0, ml, 1, q_sub);
          }
        if (isp == 2) {
          const int pw = at(cu_w, y >> 2, x >> 2);
          const int step = std::max(4, pw);
          int mp, mq;
          luma_maxlen(pw, pw, false, false, mp, mq);
          for (int off = step; off < w; off += step) {
            const int xi = x + off;
            for (int yy = y; yy < y + h; yy += 4) {
              const int eqp = luma_qp(yy >> 2, (xi - 1) >> 2, yy >> 2,
                                      xi >> 2);
              lsegs[0].push_back({xi, yy, eqp, mp, mq, 2, 0});
            }
          }
        }
        if (sbt == 1 || sbt == 3) {
          const int xi = x + (pos == 0 ? tx + tw : tx);
          for (int yy = y; yy < y + h; yy += 4)
            luma_edge(true, xi, yy, yy >> 2, (xi - 1) >> 2, yy >> 2,
                      xi >> 2, true, q_sub, 0, 0, 2, q_sub);
        }
        if ((f & F_MTB) && w > 64)
          for (int off = 64; off < w; off += 64) {
            const int xi = x + off;
            for (int yy = y; yy < y + h; yy += 4)
              luma_edge(true, xi, yy, yy >> 2, (xi - 1) >> 2, yy >> 2,
                        xi >> 2, true, q_sub, 0, 0, 2, q_sub);
          }
      } else {
        if (y != 0)
          for (int xx = x; xx < x + w; xx += 4)
            luma_edge(false, xx, y, (y - 1) >> 2, xx >> 2, y >> 2, xx >> 2,
                      true, true, (y % ctu) == 0, 0, 0, q_sub);
        if (q_sub)
          for (int off = 8; off < h; off += 8) {
            const int yi = y + off;
            if (has(tu_ys, yi)) continue;
            const int ml = sub_maxlen(off, h);
            for (int xx = x; xx < x + w; xx += 4)
              luma_edge(false, xx, yi, (yi - 1) >> 2, xx >> 2, yi >> 2,
                        xx >> 2, false, true, 0, ml, 1, q_sub);
          }
        if (isp == 1) {
          const int ph = at(cu_h, y >> 2, x >> 2);
          const int step = std::max(4, ph);
          int mp, mq;
          luma_maxlen(ph, ph, false, false, mp, mq);
          for (int off = step; off < h; off += step) {
            const int yi = y + off;
            for (int xx = x; xx < x + w; xx += 4) {
              const int eqp = luma_qp((yi - 1) >> 2, xx >> 2, yi >> 2,
                                      xx >> 2);
              lsegs[1].push_back({xx, yi, eqp, mp, mq, 2, 0});
            }
          }
        }
        if (sbt == 2 || sbt == 4) {
          const int yi = y + (pos == 0 ? ty + th : ty);
          for (int xx = x; xx < x + w; xx += 4)
            luma_edge(false, xx, yi, (yi - 1) >> 2, xx >> 2, yi >> 2,
                      xx >> 2, true, q_sub, 0, 0, 2, q_sub);
        }
        if ((f & F_MTB) && h > 64)
          for (int off = 64; off < h; off += 64) {
            const int yi = y + off;
            for (int xx = x; xx < x + w; xx += 4)
              luma_edge(false, xx, yi, (yi - 1) >> 2, xx >> 2, yi >> 2,
                        xx >> 2, true, q_sub, 0, 0, 2, q_sub);
          }
      }
      if (bad) return;
    }
    // chroma edges on the 8-chroma-sample grid, along the chroma tree
    for (int i = 0; i < n_cus; i++) {
      const int32_t* c = cu(i);
      const int f = c[C_FLAGS];
      if (f & F_LUMA_ONLY) continue;
      const int x = c[C_X], y = c[C_Y], w = c[C_W], h = c[C_H];
      if (band && !(by0 <= y && y < by1)) continue;
      const int cx = x >> 1, cy = y >> 1, cw = w >> 1, ch = h >> 1;
      const int sbt = c[C_SBT], pos = c[C_SBT_POS];
      const int tx = c[C_SBT_X], ty = c[C_SBT_Y], tw = c[C_SBT_W],
                th = c[C_SBT_H];
      if (sbt) {
        if (vert && (sbt == 1 || sbt == 3)) {
          const int ex = (x + (pos == 0 ? tx + tw : tx)) >> 1;
          if (!(ex & 7)) {
            const int large = (tw >> 1) >= 8 && ((w - tw) >> 1) >= 8;
            for (int yy = cy; yy < cy + ch; yy += 2)
              chroma_edge(true, ex, yy, (yy << 1) >> 2, ((ex - 1) << 1) >> 2,
                          (yy << 1) >> 2, (ex << 1) >> 2, false, large, 0);
          }
        } else if (!vert && (sbt == 2 || sbt == 4)) {
          const int ey = (y + (pos == 0 ? ty + th : ty)) >> 1;
          if (!(ey & 7)) {
            const int large = (th >> 1) >= 8 && ((h - th) >> 1) >= 8;
            for (int xx = cx; xx < cx + cw; xx += 2)
              chroma_edge(false, xx, ey, ((ey - 1) << 1) >> 2, (xx << 1) >> 2,
                          (ey << 1) >> 2, (xx << 1) >> 2, false, large, 0);
          }
        }
      }
      if (f & F_MTB) {
        // internal max-TB chroma transform edges (large: BS 1 filters)
        if (vert && w > 64) {
          for (int off = 64; off < w; off += 64) {
            const int ex = (x + off) >> 1;
            for (int yy = cy; yy < cy + ch; yy += 2)
              chroma_edge(true, ex, yy, (yy << 1) >> 2, ((ex - 1) << 1) >> 2,
                          (yy << 1) >> 2, (ex << 1) >> 2, false, 1, 0);
          }
        } else if (!vert && h > 64) {
          for (int off = 64; off < h; off += 64) {
            const int ey = (y + off) >> 1;
            for (int xx = cx; xx < cx + cw; xx += 2)
              chroma_edge(false, xx, ey, ((ey - 1) << 1) >> 2, (xx << 1) >> 2,
                          (ey << 1) >> 2, (xx << 1) >> 2, false, 1, 0);
          }
        }
      }
      if (vert) {
        if (cx == 0 || (cx & 7)) continue;
        for (int yy = cy; yy < cy + ch; yy += 2) {
          const int sq = at(cblk_w, yy >> 1, cx >> 1);
          const int sp = at(cblk_w, yy >> 1, (cx - 1) >> 1);
          chroma_edge(true, cx, yy, (yy << 1) >> 2, ((cx - 1) << 1) >> 2,
                      (yy << 1) >> 2, (cx << 1) >> 2, true,
                      sp >= 8 && sq >= 8, 0);
        }
      } else {
        if (cy == 0 || (cy & 7)) continue;
        const int at_ctu = ((cy << 1) % ctu) == 0;
        for (int xx = cx; xx < cx + cw; xx += 2) {
          const int sq = at(cblk_h, cy >> 1, xx >> 1);
          const int sp = at(cblk_h, (cy - 1) >> 1, xx >> 1);
          chroma_edge(false, xx, cy, ((cy - 1) << 1) >> 2, (xx << 1) >> 2,
                      (cy << 1) >> 2, (xx << 1) >> 2, true,
                      sp >= 8 && sq >= 8, at_ctu);
        }
      }
      if (bad) return;
    }
  }
};

// ---- the batched filters (ops/deblock_batch.py) -----------------------------

inline void tc_beta(int qp, int bs, int bd, int& tc, int& beta) {
  const int idx_tc = clipv(qp + DEFAULT_INTRA_TC_OFFSET * (bs - 1), 0,
                           MAX_QP + DEFAULT_INTRA_TC_OFFSET);
  const int idx_b = clipv(qp, 0, MAX_QP);
  tc = bd < 10 ? (TC_TABLE[idx_tc] + (1 << (9 - bd))) >> (10 - bd)
               : TC_TABLE[idx_tc] << (bd - 10);
  beta = BETA_TABLE[idx_b] << (bd - 8);
}

// a segment's samples: lane j is sample j - 8 across the edge, line i
// runs along it; coordinates clamp to the picture
struct Patch {
  int32_t s[4][16];
  uint16_t written[4];   // lane bits
};

inline void gather(const int32_t* pl, int w, int h, int x, int y, bool vert,
                   int lines, Patch& P) {
  for (int i = 0; i < lines; i++)
    for (int j = 0; j < 16; j++) {
      int yy = vert ? y + i : y + j - 8, xx = vert ? x + j - 8 : x + i;
      yy = clipv(yy, 0, h - 1);
      xx = clipv(xx, 0, w - 1);
      P.s[i][j] = pl[size_t(yy) * w + xx];
    }
  for (int i = 0; i < 4; i++) P.written[i] = 0;
}

inline void scatter(int32_t* pl, int w, int h, int x, int y, bool vert,
                    int lines, const Patch& P) {
  for (int i = 0; i < lines; i++) {
    if (!P.written[i]) continue;
    for (int j = 0; j < 16; j++) {
      if (!(P.written[i] >> j & 1)) continue;
      int yy = vert ? y + i : y + j - 8, xx = vert ? x + j - 8 : x + i;
      yy = clipv(yy, 0, h - 1);
      xx = clipv(xx, 0, w - 1);
      pl[size_t(yy) * w + xx] = P.s[i][j];
    }
  }
}

inline bool use_strong(const int32_t (&S)[4][16], int line, int d2, int beta,
                       int tc, bool p_large, bool q_large, int max_p,
                       int max_q) {
  auto g = [&](int k) { return S[line][8 + k]; };
  const int m3 = g(-1), m4 = g(0);
  const int shift_beta = (p_large || q_large) ? 4 : 2;
  if (!(d2 < (beta >> shift_beta) && std::abs(m3 - m4) < ((tc * 5 + 1) >> 1)))
    return false;
  int sp3 = std::abs(g(-4) - m3), sq3 = std::abs(g(3) - m4);
  if (p_large) {
    const int mp4 = g(-max_p - 1);
    if (max_p == 7) sp3 += std::abs(g(-5) - g(-6) - g(-7) + mp4);
    sp3 = (sp3 + std::abs(g(-4) - mp4) + 1) >> 1;
  }
  if (q_large) {
    const int m11 = g(max_q);
    if (max_q == 7) sq3 += std::abs(g(4) - g(5) - g(6) + m11);
    sq3 = (sq3 + std::abs(m11 - g(3)) + 1) >> 1;
  }
  const int thr = (p_large || q_large) ? (beta * 3) >> 5 : beta >> 3;
  return sp3 + sq3 < thr;
}

inline void put(Patch& O, int i, int k, int v) {
  O.s[i][8 + k] = v;
  O.written[i] |= uint16_t(1u << (8 + k));
}

void bilinear_long(const Patch& P, Patch& O, int n_p, int n_q, int tc) {
  const int* dbp = n_p == 7 ? DB7 : n_p == 5 ? DB5 : DB3;
  const int* dbq = n_q == 7 ? DB7 : n_q == 5 ? DB5 : DB3;
  const int* tcp = n_p != 3 ? TCC7 : TCC3;
  const int* tcq = n_q != 3 ? TCC7 : TCC3;
  for (int i = 0; i < 4; i++) {
    auto g = [&](int k) { return P.s[i][8 + k]; };
    const int ref_p = n_p == 7   ? (g(-7) + g(-8) + 1) >> 1
                      : n_p == 5 ? (g(-5) + g(-6) + 1) >> 1
                                 : (g(-3) + g(-4) + 1) >> 1;
    const int ref_q = n_q == 7   ? (g(6) + g(7) + 1) >> 1
                      : n_q == 5 ? (g(4) + g(5) + 1) >> 1
                                 : (g(2) + g(3) + 1) >> 1;
    int mid;
    if (n_p == n_q) {
      if (n_p == 5)
        mid = (2 * (g(-1) + g(0) + g(-2) + g(1) + g(-3) + g(2)) + g(-4) +
               g(3) + g(-5) + g(4) + 8) >> 4;
      else
        mid = (2 * (g(-1) + g(0)) + g(-2) + g(1) + g(-3) + g(2) + g(-4) +
               g(3) + g(-5) + g(4) + g(-6) + g(5) + g(-7) + g(6) + 8) >> 4;
    } else {
      const bool big_p = n_p > n_q;
      auto gp = [&](int k) { return big_p ? g(-1 - k) : g(k); };
      auto gq = [&](int k) { return big_p ? g(k) : g(-1 - k); };
      const int np_ = std::max(n_p, n_q), nq_ = std::min(n_p, n_q);
      if (np_ == 7 && nq_ == 5)
        mid = (2 * (g(-1) + g(0) + g(-2) + g(1)) + g(-3) + g(2) + g(-4) +
               g(3) + g(-5) + g(4) + g(-6) + g(5) + 8) >> 4;
      else if (np_ == 7 && nq_ == 3)
        mid = (2 * (gp(0) + gq(0)) + gq(0) + 2 * (gq(1) + gq(2)) + gp(1) +
               gq(1) + gp(2) + gp(3) + gp(4) + gp(5) + gp(6) + 8) >> 4;
      else
        mid = (g(-1) + g(0) + g(-2) + g(1) + g(-3) + g(2) + g(-4) + g(3) +
               4) >> 3;
    }
    for (int pos = 0; pos < n_p; pos++) {
      const int src = g(-1 - pos), cval = (tc * tcp[pos]) >> 1;
      const int v = (mid * dbp[pos] + ref_p * (64 - dbp[pos]) + 32) >> 6;
      put(O, i, -1 - pos, clipv(v, src - cval, src + cval));
    }
    for (int pos = 0; pos < n_q; pos++) {
      const int src = g(pos), cval = (tc * tcq[pos]) >> 1;
      const int v = (mid * dbq[pos] + ref_q * (64 - dbq[pos]) + 32) >> 6;
      put(O, i, pos, clipv(v, src - cval, src + cval));
    }
  }
}

// filter_luma_edges for one segment: P the samples before its wave, O the
// output lanes it writes
void luma_segment(const LSeg& sg, int bd, const Patch& P, Patch& O) {
  const int maxval = (1 << bd) - 1;
  const bool p_large = sg.max_p > 3 && !sg.at_ctu;
  const int max_p = sg.at_ctu ? std::min(sg.max_p, 3) : sg.max_p;
  const int max_q = sg.max_q;
  const bool q_large = max_q > 3;
  int tc, beta;
  tc_beta(sg.qp, sg.bs, bd, tc, beta);
  const int side_thr = (beta + (beta >> 1)) >> 3;
  const int thr_cut = tc * 10;
  auto g = [&](int i, int k) { return P.s[i][8 + k]; };
  auto dp = [&](int i) { return std::abs(g(i, -3) - 2 * g(i, -2) + g(i, -1)); };
  auto dq = [&](int i) { return std::abs(g(i, 0) - 2 * g(i, 1) + g(i, 2)); };
  const int dp0 = dp(0), dq0 = dq(0), dp3 = dp(3), dq3 = dq(3);
  if (p_large || q_large) {
    const int dp0l = p_large
        ? (dp0 + std::abs(g(0, -6) - 2 * g(0, -5) + g(0, -4)) + 1) >> 1 : dp0;
    const int dq0l = q_large
        ? (dq0 + std::abs(g(0, 3) - 2 * g(0, 4) + g(0, 5)) + 1) >> 1 : dq0;
    const int dp3l = p_large
        ? (dp3 + std::abs(g(3, -6) - 2 * g(3, -5) + g(3, -4)) + 1) >> 1 : dp3;
    const int dq3l = q_large
        ? (dq3 + std::abs(g(3, 3) - 2 * g(3, 4) + g(3, 5)) + 1) >> 1 : dq3;
    const int d0l = dp0l + dq0l, d3l = dp3l + dq3l;
    if (d0l + d3l < beta &&
        use_strong(P.s, 0, 2 * d0l, beta, tc, p_large, q_large, max_p,
                   max_q) &&
        use_strong(P.s, 3, 2 * d3l, beta, tc, p_large, q_large, max_p,
                   max_q)) {
      const int n_p = p_large ? max_p : 3, n_q = q_large ? max_q : 3;
      auto tap = [](int n) { return n == 3 || n == 5 || n == 7; };
      if (tap(n_p) && tap(n_q)) bilinear_long(P, O, n_p, n_q, tc);
      return;
    }
  }
  if (!(dp0 + dq0 + dp3 + dq3 < beta)) return;
  const bool filt_p = max_p > 1 && max_q > 1 && dp0 + dp3 < side_thr;
  const bool filt_q = max_p > 1 && max_q > 1 && dq0 + dq3 < side_thr;
  const bool sw = max_p > 2 && max_q > 2 &&
      use_strong(P.s, 0, 2 * (dp0 + dq0), beta, tc, false, false, max_p,
                 max_q) &&
      use_strong(P.s, 3, 2 * (dp3 + dq3), beta, tc, false, false, max_p,
                 max_q);
  for (int i = 0; i < 4; i++) {
    const int m0 = g(i, -4), m1 = g(i, -3), m2 = g(i, -2), m3 = g(i, -1);
    const int m4 = g(i, 0), m5 = g(i, 1), m6 = g(i, 2), m7 = g(i, 3);
    if (sw) {
      put(O, i, -3, clipv((2 * m0 + 3 * m1 + m2 + m3 + m4 + 4) >> 3,
                          m1 - tc, m1 + tc));
      put(O, i, -2, clipv((m1 + m2 + m3 + m4 + 2) >> 2, m2 - 2 * tc,
                          m2 + 2 * tc));
      put(O, i, -1, clipv((m1 + 2 * m2 + 2 * m3 + 2 * m4 + m5 + 4) >> 3,
                          m3 - 3 * tc, m3 + 3 * tc));
      put(O, i, 0, clipv((m2 + 2 * m3 + 2 * m4 + 2 * m5 + m6 + 4) >> 3,
                         m4 - 3 * tc, m4 + 3 * tc));
      put(O, i, 1, clipv((m3 + m4 + m5 + m6 + 2) >> 2, m5 - 2 * tc,
                         m5 + 2 * tc));
      put(O, i, 2, clipv((m3 + m4 + m5 + 3 * m6 + 2 * m7 + 4) >> 3,
                         m6 - tc, m6 + tc));
      continue;
    }
    const int delta = (9 * (m4 - m3) - 3 * (m5 - m2) + 8) >> 4;
    if (!(std::abs(delta) < thr_cut)) continue;
    const int dlt = clipv(delta, -tc, tc), tc2 = tc >> 1;
    put(O, i, -1, clipv(m3 + dlt, 0, maxval));
    put(O, i, 0, clipv(m4 - dlt, 0, maxval));
    if (filt_p)
      put(O, i, -2, clipv(m2 + clipv((((m1 + m3 + 1) >> 1) - m2 + dlt) >> 1,
                                     -tc2, tc2), 0, maxval));
    if (filt_q)
      put(O, i, 1, clipv(m5 + clipv((((m6 + m4 + 1) >> 1) - m5 - dlt) >> 1,
                                    -tc2, tc2), 0, maxval));
  }
}

// filter_chroma_edges for one segment (two chroma lines)
void chroma_segment(const CSeg& sg, int bd, const Patch& P, Patch& O) {
  const int maxval = (1 << bd) - 1;
  int tc, beta;
  tc_beta(sg.qp, sg.bs, bd, tc, beta);
  if (tc == 0) return;
  auto g = [&](int i, int k) { return P.s[i][8 + k]; };
  auto dp = [&](int i) {
    return sg.at_ctu ? std::abs(g(i, -2) - 2 * g(i, -2) + g(i, -1))
                     : std::abs(g(i, -3) - 2 * g(i, -2) + g(i, -1));
  };
  auto dq = [&](int i) { return std::abs(g(i, 0) - 2 * g(i, 1) + g(i, 2)); };
  auto strong_line = [&](int i, int d2) {
    const int m3 = g(i, -1), m4 = g(i, 0);
    if (!(d2 < (beta >> 2) && std::abs(m3 - m4) < ((tc * 5 + 1) >> 1)))
      return false;
    const int sp3 = sg.at_ctu ? std::abs(g(i, -2) - m3)
                              : std::abs(g(i, -4) - m3);
    return sp3 + std::abs(g(i, 3) - m4) < (beta >> 3);
  };
  const int d0 = dp(0) + dq(0), d3 = dp(1) + dq(1);
  const bool sw = sg.large && d0 + d3 < beta && strong_line(0, 2 * d0) &&
                  strong_line(1, 2 * d3);
  for (int i = 0; i < 2; i++) {
    const int m0 = g(i, -4), m1 = g(i, -3), m2 = g(i, -2), m3 = g(i, -1);
    const int m4 = g(i, 0), m5 = g(i, 1), m6 = g(i, 2), m7 = g(i, 3);
    if (sw) {
      if (sg.at_ctu) {
        put(O, i, -1, clipv((3 * m2 + 2 * m3 + m4 + m5 + m6 + 4) >> 3,
                            m3 - tc, m3 + tc));
        put(O, i, 0, clipv((2 * m2 + m3 + 2 * m4 + m5 + m6 + m7 + 4) >> 3,
                           m4 - tc, m4 + tc));
      } else {
        put(O, i, -3, clipv((3 * m0 + 2 * m1 + m2 + m3 + m4 + 4) >> 3,
                            m1 - tc, m1 + tc));
        put(O, i, -2, clipv((2 * m0 + m1 + 2 * m2 + m3 + m4 + m5 + 4) >> 3,
                            m2 - tc, m2 + tc));
        put(O, i, -1,
            clipv((m0 + m1 + m2 + 2 * m3 + m4 + m5 + m6 + 4) >> 3, m3 - tc,
                  m3 + tc));
        put(O, i, 0,
            clipv((m1 + m2 + m3 + 2 * m4 + m5 + m6 + m7 + 4) >> 3, m4 - tc,
                  m4 + tc));
      }
      put(O, i, 1, clipv((m2 + m3 + m4 + 2 * m5 + m6 + 2 * m7 + 4) >> 3,
                         m5 - tc, m5 + tc));
      put(O, i, 2, clipv((m3 + m4 + m5 + 2 * m6 + 3 * m7 + 4) >> 3, m6 - tc,
                         m6 + tc));
      continue;
    }
    const int dlt = clipv((4 * (m4 - m3) + m2 - m5 + 4) >> 3, -tc, tc);
    put(O, i, -1, clipv(m3 + dlt, 0, maxval));
    put(O, i, 0, clipv(m4 - dlt, 0, maxval));
  }
}

inline int reach(int max_s, bool large) {
  if (large) return std::max(6, max_s + 1);
  return max_s > 2 ? 4 : 3;
}

// plan_waves: the least wave index such that no segment conflicts with an
// earlier one (in (t, par) order) in the same or a later wave
int plan_waves(const std::vector<LSeg>& segs, bool vert,
               std::vector<int>& waves) {
  const int n = int(segs.size());
  auto t_of = [&](int i) { return vert ? segs[i].x : segs[i].y; };
  auto par_of = [&](int i) { return vert ? segs[i].y : segs[i].x; };
  auto mp_eff = [&](int i) {
    return segs[i].at_ctu ? std::min(segs[i].max_p, 3) : segs[i].max_p;
  };
  std::vector<int> order(n);
  int max_par = 0;
  for (int i = 0; i < n; i++) {
    order[i] = i;
    max_par = std::max(max_par, par_of(i));
  }
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    return t_of(a) != t_of(b) ? t_of(a) < t_of(b) : par_of(a) < par_of(b);
  });
  waves.assign(n, 0);
  std::vector<std::vector<int>> by_par(size_t(max_par) + 1);
  int top = 0;
  for (int i : order) {
    const int t = t_of(i);
    int w = 0;
    const bool p_lg = segs[i].max_p > 3 && !segs[i].at_ctu;
    const int s_w_lo = t - mp_eff(i), s_r_lo = t - reach(mp_eff(i), p_lg);
    std::vector<int>& row = by_par[par_of(i)];
    for (auto it = row.rbegin(); it != row.rend(); ++it) {
      const int j = *it, dt = t - t_of(j);
      if (dt >= 32) break;
      if (dt <= 0) continue;
      const int o_w_hi = t_of(j) + segs[j].max_q - 1;
      const int o_r_hi =
          t_of(j) + reach(segs[j].max_q, segs[j].max_q > 3) - 1;
      if (o_w_hi >= s_r_lo || o_w_hi >= s_w_lo || o_r_hi >= s_w_lo)
        w = std::max(w, waves[j] + 1);
    }
    waves[i] = w;
    top = std::max(top, w);
    row.push_back(i);
  }
  return top;
}

void filter_luma(int32_t* pl, int w, int h, int bd,
                 const std::vector<LSeg>& segs, bool vert) {
  if (segs.empty()) return;
  std::vector<int> waves;
  const int top = plan_waves(segs, vert, waves);
  std::vector<int> idx;
  std::vector<Patch> in, out;
  for (int wv = 0; wv <= top; wv++) {
    idx.clear();
    for (int i = 0; i < int(segs.size()); i++)
      if (waves[i] == wv) idx.push_back(i);
    in.resize(idx.size());
    out.resize(idx.size());
    for (size_t k = 0; k < idx.size(); k++)
      gather(pl, w, h, segs[idx[k]].x, segs[idx[k]].y, vert, 4, in[k]);
    for (size_t k = 0; k < idx.size(); k++) {
      out[k] = in[k];
      luma_segment(segs[idx[k]], bd, in[k], out[k]);
    }
    for (size_t k = 0; k < idx.size(); k++)
      scatter(pl, w, h, segs[idx[k]].x, segs[idx[k]].y, vert, 4, out[k]);
  }
}

void filter_chroma(int32_t* pl, int w, int h, int bd,
                   const std::vector<CSeg>& segs, bool vert) {
  std::vector<Patch> in(segs.size());
  for (size_t k = 0; k < segs.size(); k++)
    gather(pl, w, h, segs[k].x, segs[k].y, vert, 2, in[k]);
  for (size_t k = 0; k < segs.size(); k++) {
    Patch o = in[k];
    chroma_segment(segs[k], bd, in[k], o);
    scatter(pl, w, h, segs[k].x, segs[k].y, vert, 2, o);
  }
}

}  // namespace

extern "C" {

int vtd_cu_fields() { return CU_F; }
int vtd_params() { return P_N; }

// Deblocks one picture (or the band prm[P_BAND_Y0..Y1) of it) in place.
// Returns the number of edge segments filtered, or a negative error with
// the planes untouched.
int vtd_deblock_picture(const int32_t* prm, const int32_t* cus, int n_cus,
                        const int32_t* tus, int n_tus, const int32_t* sub,
                        int n_sub, const int32_t* qp_map,
                        const int32_t* ctab, int32_t* y, int32_t* cb,
                        int32_t* cr) {
  Picture pic;
  pic.prm = prm;
  pic.cus = cus;
  pic.n_cus = n_cus;
  pic.tus = tus;
  pic.n_tus = n_tus;
  pic.sub = sub;
  pic.n_sub = n_sub;
  pic.qp_map = qp_map;
  pic.ctab = ctab;
  pic.build_maps();
  if (pic.bad) return ERR_INPUT;
  pic.build_cblk();
  pic.walk(true);
  if (!pic.bad) pic.walk(false);
  if (pic.bad) return ERR_INPUT;
  const int w = prm[P_W], h = prm[P_H], cw = prm[P_CW], ch = prm[P_CH];
  const int bd = prm[P_BD];
  int32_t* chroma[2] = {cb, cr};
  int n = 0;
  for (int d = 0; d < 2; d++) {
    filter_luma(y, w, h, bd, pic.lsegs[d], d == 0);
    n += int(pic.lsegs[d].size());
    for (int c = 0; c < 2; c++) {
      filter_chroma(chroma[c], cw, ch, bd, pic.csegs[d][c], d == 0);
      n += int(pic.csegs[d][c].size());
    }
  }
  return n;
}

}  // extern "C"

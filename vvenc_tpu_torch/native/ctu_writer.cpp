// CTU syntax writer for intra slices, called once per CTU through ctypes
// (which releases the GIL for the whole call).
//
// Bit-exact port of the encode path of codec/ctu_syntax.py
// SyntaxCoder.encode_ctu for an intra slice whose tree the native CTU
// search decided (vvenc CABACWriter::coding_tree_unit:156, split_cu_mode
// :563, coding_unit:641, intra_luma_pred_modes:955,
// intra_chroma_pred_mode:1178, transform_unit:2032, cu_qp_delta:2173,
// residual_lfnst_mode:2403, isp_mode:2383).  The tree arrives as the
// search's serialized record (native/entropy.cpp ctusearch::serialize):
// split tokens and CU fields in coding order, coefficients in a second
// array.  The writer updates the context states, the arithmetic state,
// the PictureState maps (codec/picture.py mark_cu / mark_chroma), the
// quantization-group state and the motion field of intra CUs exactly as
// the Python writer does for CUs whose reconstruction the search staged
// (CuData.recon_done).
//
// Covered: QT and MTT splits, single and dual tree, MPM luma modes, MIP,
// MRL, ISP, chroma modes with CCLM, cbf flags, cu_qp_delta, JCCR, LFNST,
// regular residual coding with dependent quantization or sign hiding.
// Not covered (the caller keeps the Python writer): inter slices,
// transform skip / BDPCM / IBC, explicit MTS, LMCS, tiles, SCIPU regions.
//
// The residual coding goes through native/entropy.cpp's
// vte_write_residual, handed over as a function pointer by vtw_init; the
// arithmetic engine below is a copy of entropy.cpp's Engine, and the
// partitioner, split-context, MPM and scan derivations are copies of its
// ctusearch / scan_info code (that file is shared with the JAX package and
// stays as it is).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

constexpr int PROB_BITS = 15;
constexpr uint32_t MASK_0 = ((1u << 10) - 1) << (PROB_BITS - 10);
constexpr uint32_t MASK_1 = ((1u << 14) - 1) << (PROB_BITS - 14);

constexpr int NO_SPLIT = 0, QT_SPLIT = 1, BT_H = 2, BT_V = 3, TT_H = 4,
              TT_V = 5;
constexpr int MODE_ALL = 0, MODE_INTER = 1, MODE_INTRA = 2;
constexpr int TREE_D = 0, TREE_L = 1, TREE_C = 2, CHROMA_TREE = 3;
constexpr int LDT_INHERIT = 0, LDT_INFER = 1;
constexpr int PLANAR = 0, DC = 1, HOR = 18, VER = 50, VDIA = 66;
constexpr int N_MODES = 67, NUM_MPM = 6;
constexpr int DM_CHROMA = 67;
constexpr int CCLM_MODES[3] = {81, 82, 83};
constexpr int MAX_TB = 64;

// error codes (negative returns of vtw_write_ctu)
constexpr int ERR_RECORD = -1;    // the record ended early or ran over
constexpr int ERR_SCIPU = -2;     // a split that needs a region chroma CU
constexpr int ERR_MRL_MPM = -3;   // MRL with a mode outside MPM 1..5
constexpr int ERR_NO_COEFF = -4;  // an inferred cbf without coefficients
constexpr int ERR_OUT = -5;       // the byte buffer is too small

// context-set offsets (ctx_tables.CTX_SETS), installed by vtw_init
struct Offs {
  int split, qt, hv, h12, mpm, planar, chroma_mode, cclm_flag, cclm_idx,
      cbf_y, cbf_cb, cbf_cr, delta_qp, mip, mrl, lfnst, jccr, isp;
};
Offs g_offs;

// native/entropy.cpp vte_write_residual
typedef int (*ResidualFn)(const int32_t*, int, int, int, int, int,
                          uint16_t*, uint16_t*, const uint8_t*,
                          const uint8_t*, int64_t*, uint8_t*);
ResidualFn g_residual = nullptr;

// ---- binary arithmetic encoder (entropy.cpp Engine) ----------------------
const int RENORM_TABLE_32[32] = {6, 5, 4, 4, 3, 3, 3, 3, 2, 2, 2, 2,
                                 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1,
                                 1, 1, 1, 1, 1, 1, 1, 1};

struct Engine {
  uint64_t low;
  int range, buffered_byte, num_buffered_bytes, bits_left;
  uint16_t* s0;
  uint16_t* s1;
  const uint8_t* r0;
  const uint8_t* r1;
  uint8_t* out;
  int n_out = 0;

  void write_out() {
    uint32_t lead_byte = uint32_t(low >> (24 - bits_left));
    bits_left += 8;
    low &= 0xFFFFFFFFull >> bits_left;
    if (lead_byte == 0xFF) {
      ++num_buffered_bytes;
    } else if (num_buffered_bytes > 0) {
      uint32_t carry = lead_byte >> 8;
      out[n_out++] = uint8_t((buffered_byte + carry) & 0xFF);
      buffered_byte = lead_byte & 0xFF;
      uint8_t fill = uint8_t((0xFF + carry) & 0xFF);
      while (num_buffered_bytes > 1) {
        out[n_out++] = fill;
        --num_buffered_bytes;
      }
    } else {
      num_buffered_bytes = 1;
      buffered_byte = lead_byte & 0xFF;
    }
  }

  void encode_bin(int binval, int ctx) {
    int st8 = (int(s0[ctx]) + int(s1[ctx])) >> 8;
    int q = st8;
    if (q & 0x80) q ^= 0xFF;
    int lps = (((q >> 2) * (range >> 5)) >> 1) + 4;
    range -= lps;
    if (binval != (st8 >> 7)) {
      int num_bits = RENORM_TABLE_32[lps >> 3];
      bits_left -= num_bits;
      low = (low + uint64_t(range)) << num_bits;
      range = lps << num_bits;
      if (bits_left < 12) write_out();
    } else if (range < 256) {
      --bits_left;
      low <<= 1;
      range <<= 1;
      if (bits_left < 12) write_out();
    }
    int a = s0[ctx], b = s1[ctx];
    a -= (a >> r0[ctx]) & int(MASK_0);
    b -= (b >> r1[ctx]) & int(MASK_1);
    if (binval) {
      a += (0x7FFF >> r0[ctx]) & int(MASK_0);
      b += (0x7FFF >> r1[ctx]) & int(MASK_1);
    }
    s0[ctx] = uint16_t(a);
    s1[ctx] = uint16_t(b);
  }

  void encode_bin_ep(int binval) {
    low <<= 1;
    if (binval) low += uint64_t(range);
    --bits_left;
    if (bits_left < 12) write_out();
  }

  void encode_bins_ep(uint64_t bins, int num_bins) {
    if (range == 256) {  // aligned mode
      int rem = num_bins;
      while (rem > 0) {
        int take = std::min(rem, 8);
        uint64_t mask = (uint64_t(1) << take) - 1;
        uint64_t nb = (bins >> (rem - take)) & mask;
        low = (low << take) + (nb << 8);
        rem -= take;
        bits_left -= take;
        if (bits_left < 12) write_out();
      }
      return;
    }
    while (num_bins > 8) {
      num_bins -= 8;
      uint64_t pattern = bins >> num_bins;
      low = (low << 8) + uint64_t(range) * pattern;
      bins -= pattern << num_bins;
      bits_left -= 8;
      if (bits_left < 12) write_out();
    }
    low = (low << num_bins) + uint64_t(range) * bins;
    bits_left -= num_bins;
    if (bits_left < 12) write_out();
  }

  void save(int64_t* st) const {
    st[0] = int64_t(low);
    st[1] = range;
    st[2] = buffered_byte;
    st[3] = num_buffered_bytes;
    st[4] = bits_left;
  }
  void load(const int64_t* st) {
    low = uint64_t(st[0]);
    range = int(st[1]);
    buffered_byte = int(st[2]);
    num_buffered_bytes = int(st[3]);
    bits_left = int(st[4]);
  }
};

// ---- grouped diagonal scan (entropy.cpp scan_info) -----------------------
struct ScanInfo {
  std::vector<int> sx, sy;
};

void log2_sbb(int lw, int lh, int& lcw, int& lch) {
  if (lw == 0) { lcw = 0; lch = std::min(lh, 4); }
  else if (lh == 0) { lcw = std::min(lw, 4); lch = 0; }
  else if (lw == 1) {
    if (lh == 1 || lh == 2) { lcw = 1; lch = 1; } else { lcw = 1; lch = 3; }
  } else if (lh == 1) {
    if (lw == 1 || lw == 2) { lcw = 1; lch = 1; } else { lcw = 3; lch = 1; }
  } else { lcw = 2; lch = 2; }
}

void diag_scan(int w, int h, std::vector<int>& xs, std::vector<int>& ys) {
  int x = 0, y = 0;
  for (int i = 0; i < w * h; ++i) {
    xs.push_back(x);
    ys.push_back(y);
    if (x == w - 1 || y == 0) {
      int ny = y + x + 1;
      x = 0;
      if (ny >= h) { x = ny - (h - 1); ny = h - 1; }
      y = ny;
    } else {
      ++x;
      --y;
    }
  }
}

ScanInfo g_scan[7][7];
bool g_scan_ready[7][7] = {};
std::mutex g_scan_mutex;

const ScanInfo& scan_info(int log2w, int log2h) {
  std::lock_guard<std::mutex> lock(g_scan_mutex);
  if (!g_scan_ready[log2w][log2h]) {
    ScanInfo si;
    int w = 1 << log2w, h = 1 << log2h;
    int zw = std::min(32, w), zh = std::min(32, h);
    int lcw, lch;
    log2_sbb(log2w, log2h, lcw, lch);
    std::vector<int> cgx, cgy, px, py;
    diag_scan(zw >> lcw, zh >> lch, cgx, cgy);
    diag_scan(1 << lcw, 1 << lch, px, py);
    for (size_t g = 0; g < cgx.size(); ++g)
      for (size_t k = 0; k < px.size(); ++k) {
        si.sx.push_back((cgx[g] << lcw) + px[k]);
        si.sy.push_back((cgy[g] << lch) + py[k]);
      }
    g_scan[log2w][log2h] = std::move(si);
    g_scan_ready[log2w][log2h] = true;
  }
  return g_scan[log2w][log2h];
}

inline int log2i(int v) { return 31 - __builtin_clz(unsigned(v)); }

// a coefficient block of the record: null when absent
struct Blk {
  const int32_t* c = nullptr;
  int w = 0, h = 0;
  bool any() const {
    if (!c) return false;
    for (int i = 0, n = w * h; i < n; ++i)
      if (c[i]) return true;
    return false;
  }
  // ctu_syntax.scan_pos_last: last nonzero in grouped diagonal order
  int scan_pos_last() const {
    const ScanInfo& si = scan_info(log2i(w), log2i(h));
    for (int sp = int(si.sx.size()) - 1; sp >= 0; --sp)
      if (c[si.sy[sp] * w + si.sx[sp]]) return sp;
    return -1;
  }
};

// ---- per-picture parameters (layout of the int array from Python) -------
enum P {
  P_PIC_W, P_PIC_H, P_CTU, P_UW, P_UH, P_CW2, P_CH2, P_MF_UW, P_MF_UH,
  P_MIN_QT, P_MAX_MTT = P_MIN_QT + 3, P_MAX_BT = P_MAX_MTT + 3,
  P_MAX_TT = P_MAX_BT + 3, P_MIN_CB_LOG2 = P_MAX_TT + 3, P_TREE_IDX,
  P_DUAL, P_USE_DQP, P_QG_SUBDIV, P_QP_BD_OFF, P_SLICE_QP, P_DQ, P_SDH,
  P_JCCR, P_CCLM, P_MIP, P_MRL, P_ISP, P_LFNST, P_MAX_TB,
  // per CTU
  P_CTU_X, P_CTU_Y, P_TREE_QP
};

// map pointers (layout of the int64 array from Python)
enum M {
  M_CODED_LUMA, M_INTRA_MODE, M_IS_INTRA, M_IS_MIP, M_CU_W, M_CU_H, M_CU_X,
  M_CU_Y, M_QT_DEPTH, M_QP_MAP, M_CODED_CHROMA, M_CCU_W, M_CCU_H,
  M_CQT_DEPTH, M_MF_VALID, M_MF_SKIP, M_MF_ISAFF, M_MF_AFF_VALID
};

// quantization-group state io (int32 array): [cur_qp, qg_start,
// dqp_coded, qg_pred_qp, qg_delta_at (-1 = none), qp_y]
enum Q { Q_CUR_QP, Q_START, Q_CODED, Q_PRED, Q_DELTA_AT, Q_QP_Y };

struct Part {
  int qt_depth = 0, mtt_depth = 0, bt_depth = 0, impl_bt_depth = 0;
  int last_split = -1, part_idx = 0;
  int mode_type = MODE_ALL, tree_type = TREE_D, subdiv = 0;
};

struct Cu {
  int x, y, w, h;
  int luma_mode = PLANAR, chroma_dir = DM_CHROMA;
  bool mip = false, mip_t = false, cclm_allowed = true;
  bool luma_only = false, chroma_only = false;
  int ref_line = 0, lfnst_idx = 0, joint = 0, isp = 0;
  Blk y_, cb, cr;
  Blk isp_blk[4];  // ISP codes at most four partitions
  int n_isp = 0;
  int dm_luma() const { return mip ? PLANAR : luma_mode; }
};

struct Writer {
  const int32_t* pr;  // parameters
  int W, H, ctu;
  uint8_t *coded_luma, *is_intra, *is_mip, *coded_chroma;
  int32_t *intra_mode, *cu_w, *cu_h, *cu_x, *cu_y, *qt_depth, *qp_map;
  int32_t *ccu_w, *ccu_h, *cqt_depth;
  uint8_t *mf_valid, *mf_skip, *mf_isaff, *mf_aff_valid;
  int uw, uh, cw2, ch2, mf_uw, mf_uh;
  Engine e;
  int out_cap;
  // record
  const int32_t* tree;
  int n_tree, ti = 0;
  const int32_t* coeff;
  int n_coeff, ci = 0;
  int err = 0;
  // dual tree: per 64-unit, the split of the luma root and the ISP of an
  // unsplit one (SyntaxCoder.luma64)
  int32_t* luma64;
  int n_luma64 = 0;
  // quantization groups
  bool use_dqp;
  int qg_subdiv, qp_bd_off, slice_qp, tree_qp;
  int cur_qp, qg_pred_qp, qg_delta_at, qp_y;
  bool qg_start, dqp_coded;
  std::vector<int> qg_cus;  // x, y, w, h per CU of the open group

  int tok() {
    if (ti >= n_tree) { err = ERR_RECORD; return 0; }
    return tree[ti++];
  }
  Blk block(int w, int h) {
    Blk b;
    if (ci + w * h > n_coeff) { err = ERR_RECORD; return b; }
    b.c = coeff + ci;
    b.w = w;
    b.h = h;
    ci += w * h;
    return b;
  }
  void fail(int code) {
    if (!err) err = code;
  }
  bool room() {
    // a CU writes far less than this margin; checked between CUs
    if (e.n_out > out_cap - (1 << 16)) fail(ERR_OUT);
    return !err;
  }

  // ---- PictureState queries (codec/picture.py) ---------------------------
  bool coded(int x, int y) const {
    if (x < 0 || y < 0 || x >= W || y >= H) return false;
    return coded_luma[(y >> 2) * uw + (x >> 2)] != 0;
  }
  int unit(int x, int y) const { return (y >> 2) * uw + (x >> 2); }
  bool chroma_cu_at(int x, int y, int* w, int* h, int* qtd) const {
    if (x < 0 || y < 0 || x >= W || y >= H) return false;
    int u = ((y >> 1) >> 1) * cw2 + ((x >> 1) >> 1);
    if (!coded_chroma[u]) return false;
    *w = ccu_w[u];
    *h = ccu_h[u];
    *qtd = cqt_depth[u];
    return true;
  }
  void mark_chroma(int x, int y, int w, int h, int qtd) {
    int cx0 = (x >> 1) >> 1, cy0 = (y >> 1) >> 1;
    int cx1 = std::min(((x + w) >> 1) >> 1, cw2);
    int cy1 = std::min(((y + h) >> 1) >> 1, ch2);
    for (int cy = cy0; cy < cy1; ++cy)
      for (int cx = cx0; cx < cx1; ++cx) {
        int u = cy * cw2 + cx;
        coded_chroma[u] = 1;
        ccu_w[u] = w;
        ccu_h[u] = h;
        cqt_depth[u] = qtd;
      }
  }
  void mark_cu(const Cu& cu, int qtd, int qp) {
    int ux0 = cu.x >> 2, uy0 = cu.y >> 2;
    int ux1 = std::min((cu.x + cu.w) >> 2, uw);
    int uy1 = std::min((cu.y + cu.h) >> 2, uh);
    int mode = cu.dm_luma();
    for (int uy = uy0; uy < uy1; ++uy)
      for (int ux = ux0; ux < ux1; ++ux) {
        int u = uy * uw + ux;
        coded_luma[u] = 1;
        intra_mode[u] = mode;
        is_intra[u] = 1;
        is_mip[u] = cu.mip ? 1 : 0;
        cu_w[u] = cu.w;
        cu_h[u] = cu.h;
        cu_x[u] = cu.x;
        cu_y[u] = cu.y;
        qt_depth[u] = qtd;
        qp_map[u] = qp;
      }
    if (!cu.luma_only) mark_chroma(cu.x, cu.y, cu.w, cu.h, qtd);
  }
  // MotionField.set_cu(..., None, False) of an intra CU
  void clear_motion(const Cu& cu) {
    if (!mf_valid) return;
    int ux0 = cu.x >> 2, uy0 = cu.y >> 2;
    int ux1 = std::min((cu.x + cu.w) >> 2, mf_uw);
    int uy1 = std::min((cu.y + cu.h) >> 2, mf_uh);
    for (int uy = uy0; uy < uy1; ++uy)
      for (int ux = ux0; ux < ux1; ++ux) {
        int u = uy * mf_uw + ux;
        mf_valid[u] = 0;
        mf_skip[u] = 0;
        mf_isaff[u] = 0;
        mf_aff_valid[u] = 0;
      }
  }

  // ---- partitioning (ctu_syntax.py implicit_split .. write_split_mode) ---
  int implicit_split(int x, int y, int w, int h, const Part& part,
                     int tidx) const {
    bool bl_in = (x < W) && (y + h <= H);
    bool tr_in = (x + w <= W) && (y < H);
    if (bl_in && tr_in) return NO_SPLIT;
    int max_btd = pr[P_MAX_MTT + tidx] + part.impl_bt_depth;
    bool bt_ok = (w <= pr[P_MAX_BT + tidx] && h <= pr[P_MAX_BT + tidx] &&
                  part.mtt_depth < max_btd);
    bool qt_ok = w > pr[P_MIN_QT + tidx] && part.bt_depth == 0;
    if (!bl_in && !tr_in && qt_ok) return QT_SPLIT;
    if (!bl_in && bt_ok && w <= MAX_TB) return BT_H;
    if (!tr_in && bt_ok && h <= MAX_TB) return BT_V;
    return QT_SPLIT;
  }

  void split_options(int x, int y, int w, int h, const Part& part, int tidx,
                     bool can[6]) const {
    int min_t = 1 << pr[P_MIN_CB_LOG2];
    int max_bt = pr[P_MAX_BT + tidx], max_tt = pr[P_MAX_TT + tidx];
    int max_btd = pr[P_MAX_MTT + tidx] + part.impl_bt_depth;
    bool can_no = true, can_qt = true, can_bh = true, can_bv = true,
         can_th = true, can_tv = true;
    bool can_btt = part.mtt_depth < max_btd;
    if (part.last_split != -1 && part.last_split != QT_SPLIT) can_qt = false;
    if (w <= pr[P_MIN_QT + tidx]) can_qt = false;
    bool ctree = part.tree_type == CHROMA_TREE;
    int wc = w >> 1, hc = h >> 1;
    if (ctree && wc <= 4) can_qt = false;
    int impl = implicit_split(x, y, w, h, part, tidx);
    if (impl != NO_SPLIT) {
      can_no = can_th = can_tv = false;
      can_bh = impl == BT_H;
      can_bv = impl == BT_V;
      if (ctree && wc == 4) can_bv = false;
      if (!can_bh && !can_bv && !can_qt) can_qt = true;
      can[0] = can_no; can[1] = can_qt; can[2] = can_bh;
      can[3] = can_bv; can[4] = can_th; can[5] = can_tv;
      return;
    }
    if ((part.last_split == TT_H || part.last_split == TT_V) &&
        part.part_idx == 1) {
      if (part.last_split == TT_H)
        can_bh = false;
      else
        can_bv = false;
    }
    if (can_btt && (w <= min_t && h <= min_t)) can_btt = false;
    if (can_btt && (w > max_bt || h > max_bt) && (w > max_tt || h > max_tt))
      can_btt = false;
    if (!can_btt) {
      can[0] = can_no; can[1] = can_qt;
      can[2] = can[3] = can[4] = can[5] = false;
      return;
    }
    if (w > max_bt || h > max_bt) can_bh = can_bv = false;
    if (h <= min_t) can_bh = false;
    if (w > MAX_TB && h <= MAX_TB) can_bh = false;
    if (ctree && wc * hc <= 16) can_bh = false;
    if (w <= min_t) can_bv = false;
    if (w <= MAX_TB && h > MAX_TB) can_bv = false;
    if (ctree && (wc * hc <= 16 || wc == 4)) can_bv = false;
    if (h <= 2 * min_t || h > max_tt || w > max_tt) can_th = false;
    if (w > MAX_TB || h > MAX_TB) can_th = false;
    if (ctree && wc * hc <= 32) can_th = false;
    if (w <= 2 * min_t || w > max_tt || h > max_tt) can_tv = false;
    if (w > MAX_TB || h > MAX_TB) can_tv = false;
    if (ctree && (wc * hc <= 32 || wc == 8)) can_tv = false;
    if (part.mode_type == MODE_INTER && w * h == 32) can_bh = can_bv = false;
    if (part.mode_type == MODE_INTER && w * h == 64) can_th = can_tv = false;
    can[0] = can_no; can[1] = can_qt; can[2] = can_bh;
    can[3] = can_bv; can[4] = can_th; can[5] = can_tv;
  }

  void write_split_mode(int x, int y, int w, int h, const Part& part,
                        int split, int tidx) {
    bool can[6];
    split_options(x, y, w, h, part, tidx, can);
    // split_ctx_ids (vvenc DeriveCtx::CtxSplit:147)
    int lw = 0, lh = 0, lq = 0, aw = 0, ah = 0, aq = 0;
    bool has_l, has_a;
    if (part.tree_type == CHROMA_TREE) {
      has_l = chroma_cu_at(x - 1, y, &lw, &lh, &lq);
      has_a = chroma_cu_at(x, y - 1, &aw, &ah, &aq);
    } else {
      has_l = coded(x - 1, y);
      if (has_l) {
        int u = unit(x - 1, y);
        lw = cu_w[u]; lh = cu_h[u]; lq = qt_depth[u];
      }
      has_a = coded(x, y - 1);
      if (has_a) {
        int u = unit(x, y - 1);
        aw = cu_w[u]; ah = cu_h[u]; aq = qt_depth[u];
      }
    }
    int cs = 0;
    if (has_l) cs += lh < h ? 1 : 0;
    if (has_a) cs += aw < w ? 1 : 0;
    int num_split = (can[1] ? 2 : 0) + (can[2] ? 1 : 0) + (can[3] ? 1 : 0) +
                    (can[4] ? 1 : 0) + (can[5] ? 1 : 0);
    if (num_split > 0) num_split -= 1;
    cs += 3 * (num_split >> 1);
    int cq = 0;
    if (has_l && lq > part.qt_depth) cq += 1;
    if (has_a && aq > part.qt_depth) cq += 1;
    cq += part.qt_depth < 2 ? 0 : 3;
    int num_hor = (can[2] ? 1 : 0) + (can[4] ? 1 : 0);
    int num_ver = (can[3] ? 1 : 0) + (can[5] ? 1 : 0);
    int chv;
    if (num_ver == num_hor) {
      int dep_above = w / (has_a ? aw : 1);
      int dep_left = h / (has_l ? lh : 1);
      if (dep_above == dep_left || !has_l || !has_a)
        chv = 0;
      else if (dep_above < dep_left)
        chv = 1;
      else
        chv = 2;
    } else {
      chv = num_ver < num_hor ? 3 : 4;
    }
    int ch12 = part.mtt_depth <= 1 ? 1 : 0;
    int cv12 = part.mtt_depth <= 1 ? 3 : 2;

    bool can_any = can[1] || can[2] || can[3] || can[4] || can[5];
    bool is_no = split == NO_SPLIT;
    if (can[0] && can_any) e.encode_bin(is_no ? 0 : 1, g_offs.split + cs);
    if (is_no) return;
    bool can_btt = can[2] || can[3] || can[4] || can[5];
    bool is_qt = split == QT_SPLIT;
    if (can[1] && can_btt) e.encode_bin(is_qt ? 1 : 0, g_offs.qt + cq);
    if (is_qt) return;
    bool can_hor = can[2] || can[4];
    bool can_ver = can[3] || can[5];
    bool is_ver = split == BT_V || split == TT_V;
    if (can_ver && can_hor) e.encode_bin(is_ver ? 1 : 0, g_offs.hv + chv);
    bool can14 = is_ver ? can[5] : can[4];
    bool can12 = is_ver ? can[3] : can[2];
    bool is12 = split == (is_ver ? BT_V : BT_H);
    if (can12 && can14)
      e.encode_bin(is12 ? 1 : 0, g_offs.h12 + (is_ver ? cv12 : ch12));
  }

  static int split_geometry(int split, int x, int y, int w, int h,
                            int g[4][4]) {
    auto set = [&](int i, int a, int b, int c, int d) {
      g[i][0] = a; g[i][1] = b; g[i][2] = c; g[i][3] = d;
    };
    if (split == QT_SPLIT) {
      int hw = w >> 1, hh = h >> 1;
      set(0, x, y, hw, hh); set(1, x + hw, y, hw, hh);
      set(2, x, y + hh, hw, hh); set(3, x + hw, y + hh, hw, hh);
      return 4;
    }
    if (split == BT_H) {
      set(0, x, y, w, h >> 1); set(1, x, y + (h >> 1), w, h >> 1);
      return 2;
    }
    if (split == BT_V) {
      set(0, x, y, w >> 1, h); set(1, x + (w >> 1), y, w >> 1, h);
      return 2;
    }
    if (split == TT_H) {
      int q = h >> 2;
      set(0, x, y, w, q); set(1, x, y + q, w, h >> 1);
      set(2, x, y + 3 * q, w, q);
      return 3;
    }
    int q = w >> 2;
    set(0, x, y, q, h); set(1, x + q, y, w >> 1, h);
    set(2, x + 3 * q, y, q, h);
    return 3;
  }

  static int signal_mode_cons(int w, int h, int split, int mode_type_parent) {
    if (mode_type_parent != MODE_ALL) return LDT_INHERIT;
    int min_luma_area =
        (w * h) >> ((split == QT_SPLIT || split == TT_H || split == TT_V) ? 2
                                                                          : 1);
    bool is_2xn =
        ((w >> 1) == 4 && split == BT_V) || ((w >> 1) == 8 && split == TT_V);
    if ((min_luma_area >> 2) >= 16 && !is_2xn) return LDT_INHERIT;
    return LDT_INFER;  // an intra slice never signals the constraint
  }

  // ---- quantization groups (SyntaxCoder._qg_leaf_start .. _enc_dqp) ------
  int qp_at(int x, int y, bool* ok) const {
    *ok = coded(x, y);
    return *ok ? qp_map[unit(x, y)] : 0;
  }
  void finalize_qg() {
    int n = int(qg_cus.size()) / 4;
    int cut = qg_delta_at >= 0 ? qg_delta_at : n;
    for (int i = 0; i < n; ++i) {
      int q = i < cut ? qg_pred_qp : cur_qp;
      int x = qg_cus[4 * i], y = qg_cus[4 * i + 1];
      int ux1 = std::min((x + qg_cus[4 * i + 2]) >> 2, uw);
      int uy1 = std::min((y + qg_cus[4 * i + 3]) >> 2, uh);
      for (int uy = y >> 2; uy < uy1; ++uy)
        for (int ux = x >> 2; ux < ux1; ++ux) qp_map[uy * uw + ux] = q;
    }
    qg_cus.clear();
  }
  void qg_leaf_start(int x, int y) {
    if (!use_dqp || !qg_start) return;
    finalize_qg();
    qg_start = false;
    // _predict_qp (CU::predictQP)
    int mask = ctu - 1;
    int in_a = y & mask, in_l = x & mask;
    bool has_above;
    int above = qp_at(x, y - 1, &has_above);
    int pred;
    if (x == 0 && !in_l && !in_a && has_above) {
      pred = above;
    } else {
      int a = in_a ? above : cur_qp;
      bool has_left;
      int left = qp_at(x - 1, y, &has_left);
      int b = in_l ? left : cur_qp;
      pred = (a + b + 1) >> 1;
    }
    cur_qp = pred;
    qg_pred_qp = pred;
    qg_delta_at = -1;
  }
  static int pymod(int a, int m) { return ((a % m) + m) % m; }
  void enc_dqp(int qp) {
    int off = qp_bd_off;
    int dqp = pymod(qp - cur_qp + 64 + 32 + off + off / 2, 64 + off) - 32 -
              off / 2;
    int abs_dqp = dqp < 0 ? -dqp : dqp;
    for (int i = 0; i < std::min(abs_dqp + 1, 5); ++i)
      e.encode_bin(abs_dqp > i ? 1 : 0, g_offs.delta_qp + (i == 0 ? 0 : 1));
    if (abs_dqp >= 5) {
      int rem = abs_dqp - 5, k = 0;
      while (rem >= (1 << k)) {
        e.encode_bin_ep(1);
        rem -= 1 << k;
        ++k;
      }
      e.encode_bin_ep(0);
      if (k) e.encode_bins_ep(uint64_t(rem), k);
    }
    if (abs_dqp > 0) e.encode_bin_ep(dqp < 0 ? 1 : 0);
    cur_qp = pymod(cur_qp + dqp + 64 + 2 * off, 64 + off) - off;
    dqp_coded = true;
    qg_delta_at = int(qg_cus.size()) / 4;
  }
  void maybe_code_dqp(const Cu& cu, bool any_cbf) {
    if (!use_dqp || dqp_coded || cu.chroma_only) return;
    if (any_cbf || cu.w > 64 || cu.h > 64)
      enc_dqp(tree_qp >= 0 ? tree_qp : cur_qp);
  }
  // SyntaxCoder.finish_cu of a CU whose reconstruction the search staged
  void finish_cu(const Cu& cu, int qtd) {
    if (use_dqp) qp_y = cur_qp >= 0 ? cur_qp : slice_qp;  // set_cu_qp
    if (cu.chroma_only) {
      mark_chroma(cu.x, cu.y, cu.w, cu.h, qtd);
      return;
    }
    mark_cu(cu, qtd, qp_y);
    clear_motion(cu);
  }

  // ---- residual ----------------------------------------------------------
  void residual(const Blk& b, bool is_luma, bool sign_hiding) {
    if (!b.c) { fail(ERR_NO_COEFF); return; }
    int64_t st[5];
    e.save(st);
    int n = g_residual(b.c, b.w, b.h, is_luma ? 1 : 0, pr[P_DQ],
                       sign_hiding ? 1 : 0, e.s0, e.s1, e.r0, e.r1, st,
                       e.out + e.n_out);
    e.n_out += n;
    e.load(st);
  }
  void chroma_residuals(const Cu& cu, bool cbf_cb, bool cbf_cr) {
    bool sdh = pr[P_SDH] != 0;
    if (cu.joint) {
      residual((cu.joint == 2 || cu.joint == 3) ? cu.cb : cu.cr, false, sdh);
      return;
    }
    if (cbf_cb) residual(cu.cb, false, sdh);
    if (cbf_cr) residual(cu.cr, false, sdh);
  }

  // ---- intra modes -------------------------------------------------------
  void write_trunc_bin(int symbol, int max_symbol) {
    int thresh = log2i(max_symbol);
    int val = 1 << thresh;
    int b = max_symbol - val;
    if (symbol < val - b) {
      e.encode_bins_ep(uint64_t(symbol), thresh);
    } else {
      symbol += val - b;
      e.encode_bins_ep(uint64_t(symbol >> 1), thresh);
      e.encode_bin_ep(symbol & 1);
    }
  }
  void get_mpms(int x, int y, int w, int h, int mpm[6]) const {
    int left_dir = PLANAR, above_dir = PLANAR;
    if (coded(x - 1, y + h - 1)) {
      int u = unit(x - 1, y + h - 1);
      if (is_intra[u] && !is_mip[u]) left_dir = intra_mode[u];
    }
    if ((y % ctu) != 0 && coded(x + w - 1, y - 1)) {
      int u = unit(x + w - 1, y - 1);
      if (is_intra[u] && !is_mip[u]) above_dir = intra_mode[u];
    }
    const int offset = N_MODES - 6, mod = offset + 3;
    auto wrap = [&](int v) { return pymod(v, mod); };
    int m[6] = {PLANAR, DC, VER, HOR, VER - 4, VER + 4};
    if (left_dir == above_dir) {
      if (left_dir > DC) {
        m[1] = left_dir;
        m[2] = wrap(left_dir + offset) + 2;
        m[3] = wrap(left_dir - 1) + 2;
        m[4] = wrap(left_dir + offset - 1) + 2;
        m[5] = wrap(left_dir) + 2;
      }
    } else if (left_dir > DC && above_dir > DC) {
      m[1] = left_dir;
      m[2] = above_dir;
      int mx = std::max(left_dir, above_dir);
      int mn = std::min(left_dir, above_dir);
      if (mx - mn == 1) {
        m[3] = wrap(mn + offset) + 2;
        m[4] = wrap(mx - 1) + 2;
        m[5] = wrap(mn + offset - 1) + 2;
      } else if (mx - mn >= 62) {
        m[3] = wrap(mn - 1) + 2;
        m[4] = wrap(mx + offset) + 2;
        m[5] = wrap(mn) + 2;
      } else if (mx - mn == 2) {
        m[3] = wrap(mn - 1) + 2;
        m[4] = wrap(mn + offset) + 2;
        m[5] = wrap(mx - 1) + 2;
      } else {
        m[3] = wrap(mn + offset) + 2;
        m[4] = wrap(mn - 1) + 2;
        m[5] = wrap(mx + offset) + 2;
      }
    } else if (left_dir + above_dir >= 2) {
      int md = std::max(left_dir, above_dir);
      m[1] = md;
      m[2] = wrap(md + offset) + 2;
      m[3] = wrap(md - 1) + 2;
      m[4] = wrap(md + offset - 1) + 2;
      m[5] = wrap(md) + 2;
    }
    std::memcpy(mpm, m, sizeof(m));
  }
  bool isp_coded(const Cu& cu) const {
    if (cu.chroma_only || cu.mip || cu.ref_line || !pr[P_ISP]) return false;
    if (cu.w > pr[P_MAX_TB] || cu.h > pr[P_MAX_TB]) return false;
    return log2i(cu.w) + log2i(cu.h) > 4;
  }
  void enc_intra_luma_mode(const Cu& cu) {
    if (pr[P_MIP]) {
      int ctx = 0;
      if (cu.w > 2 * cu.h || cu.h > 2 * cu.w) {
        ctx = 3;
      } else {
        if (coded(cu.x - 1, cu.y) && is_mip[unit(cu.x - 1, cu.y)]) ++ctx;
        if (coded(cu.x, cu.y - 1) && is_mip[unit(cu.x, cu.y - 1)]) ++ctx;
      }
      e.encode_bin(cu.mip ? 1 : 0, g_offs.mip + ctx);
      if (cu.mip) {
        e.encode_bin_ep(cu.mip_t ? 1 : 0);
        int sid = (cu.w == 4 && cu.h == 4)
                      ? 0
                      : ((cu.w == 4 || cu.h == 4 || (cu.w == 8 && cu.h == 8))
                             ? 1
                             : 2);
        static const int N_MIP[3] = {16, 8, 6};
        write_trunc_bin(cu.luma_mode, N_MIP[sid]);
        return;
      }
    }
    if (pr[P_MRL] && (cu.y % ctu) != 0) {
      e.encode_bin(cu.ref_line != 0 ? 1 : 0, g_offs.mrl);
      if (cu.ref_line != 0)
        e.encode_bin(cu.ref_line != 1 ? 1 : 0, g_offs.mrl + 1);
    }
    if (isp_coded(cu)) {
      e.encode_bin(cu.isp ? 1 : 0, g_offs.isp);
      if (cu.isp) e.encode_bin(cu.isp - 1, g_offs.isp + 1);
    }
    int mpm[6];
    get_mpms(cu.x, cu.y, cu.w, cu.h, mpm);
    int idx = NUM_MPM;
    for (int i = 0; i < NUM_MPM; ++i)
      if (mpm[i] == cu.luma_mode) { idx = i; break; }
    if (cu.ref_line) {
      if (idx < 1 || idx >= NUM_MPM) { fail(ERR_MRL_MPM); return; }
    } else {
      e.encode_bin(idx < NUM_MPM ? 1 : 0, g_offs.mpm);
    }
    if (idx < NUM_MPM) {
      if (cu.ref_line == 0)
        e.encode_bin(idx > 0 ? 1 : 0, g_offs.planar + (cu.isp ? 0 : 1));
      for (int k = 1; k <= 4 && idx >= k; ++k)
        e.encode_bin_ep(idx > k ? 1 : 0);
    } else {
      int srt[6];
      std::memcpy(srt, mpm, sizeof(srt));
      std::sort(srt, srt + 6);
      int m = cu.luma_mode;
      for (int i = 5; i >= 0; --i)
        if (m > srt[i]) --m;
      write_trunc_bin(m, N_MODES - NUM_MPM);
    }
  }
  void enc_intra_chroma_mode(const Cu& cu) {
    if (pr[P_CCLM] && cu.cclm_allowed) {
      int sym = -1;
      for (int i = 0; i < 3; ++i)
        if (cu.chroma_dir == CCLM_MODES[i]) sym = i;
      e.encode_bin(sym >= 0 ? 1 : 0, g_offs.cclm_flag);
      if (sym >= 0) {
        e.encode_bin(sym == 0 ? 0 : 1, g_offs.cclm_idx);
        if (sym > 0) e.encode_bin_ep(sym - 1);
        return;
      }
    }
    bool is_dm = cu.chroma_dir == DM_CHROMA;
    e.encode_bin(is_dm ? 0 : 1, g_offs.chroma_mode);
    if (!is_dm) {
      int cands[4] = {PLANAR, VER, HOR, DC};
      int lm = cu.dm_luma();
      for (int i = 0; i < 4; ++i)
        if (cands[i] == lm) { cands[i] = VDIA; break; }
      int id = 0;
      for (int i = 0; i < 4; ++i)
        if (cands[i] == cu.chroma_dir) { id = i; break; }
      e.encode_bins_ep(uint64_t(id), 2);
    }
  }

  // ---- LFNST (SyntaxCoder._code_lfnst_mts of an intra CU) ----------------
  static void isp_parts(int w, int h, int isp, int parts[4][4], int* n) {
    int split_dim = isp == 1 ? h : w, non_split = isp == 1 ? w : h;
    int factor = non_split < 16 ? 16 / non_split : 1;
    int part = std::max(split_dim >> 2, factor);
    *n = split_dim / part;
    for (int k = 0; k < *n; ++k) {
      if (isp == 1) {
        parts[k][0] = 0; parts[k][1] = k * part;
        parts[k][2] = w; parts[k][3] = part;
      } else {
        parts[k][0] = k * part; parts[k][1] = 0;
        parts[k][2] = part; parts[k][3] = h;
      }
    }
  }
  bool lfnst_allowed(const Cu& cu) const {
    if (!pr[P_LFNST]) return false;
    if (cu.isp) {
      int parts[4][4], n;
      isp_parts(cu.w, cu.h, cu.isp, parts, &n);
      if (parts[0][2] < 4 || parts[0][3] < 4) return false;
    }
    if (cu.mip && !(cu.w >= 16 && cu.h >= 16)) return false;
    if (cu.chroma_only && std::min(cu.w >> 1, cu.h >> 1) < 4) return false;
    if (cu.w > 64 || cu.h > 64) return false;
    return true;
  }
  void code_lfnst(const Cu& cu) {
    if (!pr[P_LFNST]) return;  // no explicit MTS in a covered slice
    // _residual_tool_stats (the MTS half is not needed)
    bool viol = false, lfnst_last = false;
    const Blk* tbs[6];
    int n = 0;
    if (cu.isp) {
      for (int k = 0; k < cu.n_isp; ++k) tbs[n++] = &cu.isp_blk[k];
    } else if (!cu.chroma_only) {
      tbs[n++] = &cu.y_;
    }
    if (!cu.luma_only) {
      tbs[n++] = &cu.cb;
      tbs[n++] = &cu.cr;
    }
    for (int i = 0; i < n; ++i) {
      const Blk& b = *tbs[i];
      if (!b.any()) continue;
      int last = b.scan_pos_last();
      if (b.w >= 4 && b.h >= 4) {
        int maxpos =
            ((b.w == 4 && b.h == 4) || (b.w == 8 && b.h == 8)) ? 7 : 15;
        if (last > maxpos) viol = true;
        if (last >= 1) lfnst_last = true;
      }
    }
    if (cu.isp) lfnst_last = true;
    if (lfnst_allowed(cu) && lfnst_last && !viol) {
      int cctx = (cu.luma_only || cu.chroma_only) ? 1 : 0;
      e.encode_bin(cu.lfnst_idx ? 1 : 0, g_offs.lfnst + cctx);
      if (cu.lfnst_idx) e.encode_bin(cu.lfnst_idx - 1, g_offs.lfnst + 2);
    }
  }

  // ---- ISP transform units (SyntaxCoder._code_isp_tus, encode) -----------
  void code_isp_tus(const Cu& cu) {
    int n = cu.n_isp;
    bool with_chroma = !cu.luma_only;
    bool cbfs[4];
    for (int k = 0; k < n; ++k) cbfs[k] = cu.isp_blk[k].any();
    bool dqp_done = false;
    for (int k = 0; k < n; ++k) {
      bool is_last = k == n - 1;
      bool cbf_cb = false, cbf_cr = false;
      if (is_last && with_chroma) {
        if (cu.joint) {
          cbf_cb = cu.joint & 2;
          cbf_cr = cu.joint & 1;
        } else {
          cbf_cb = cu.cb.any();
          cbf_cr = cu.cr.any();
        }
        e.encode_bin(cbf_cb ? 1 : 0, g_offs.cbf_cb);
        e.encode_bin(cbf_cr ? 1 : 0, g_offs.cbf_cr + (cbf_cb ? 1 : 0));
      }
      bool any_prev = false;
      for (int j = 0; j < k; ++j) any_prev |= cbfs[j];
      bool prev = k ? cbfs[k - 1] : false;
      if (is_last && !any_prev)
        cbfs[k] = true;
      else
        e.encode_bin(cbfs[k] ? 1 : 0, g_offs.cbf_y + 2 + (prev ? 1 : 0));
      if (!dqp_done && (cbfs[k] || cbf_cb || cbf_cr)) {
        maybe_code_dqp(cu, true);
        dqp_done = true;
      }
      int mask = (cbf_cb ? 2 : 0) + (cbf_cr ? 1 : 0);
      if (is_last && with_chroma && pr[P_JCCR] && mask)
        e.encode_bin(cu.joint ? 1 : 0, g_offs.jccr + mask - 1);
      // ISP luma TBs are coded without sign hiding
      if (cbfs[k]) residual(cu.isp_blk[k], true, false);
      if (is_last && with_chroma) chroma_residuals(cu, cbf_cb, cbf_cr);
    }
  }

  // ---- coding units ------------------------------------------------------
  void read_luma_cu(Cu& cu) {
    cu.luma_mode = tok();
    cu.mip = tok() != 0;
    cu.mip_t = tok() != 0;
    cu.ref_line = tok();
    cu.lfnst_idx = tok();
    cu.joint = tok();
    cu.isp = tok();
    if (cu.isp) {
      int parts[4][4];
      isp_parts(cu.w, cu.h, cu.isp, parts, &cu.n_isp);
      for (int k = 0; k < cu.n_isp; ++k)
        if (tok()) cu.isp_blk[k] = block(parts[k][2], parts[k][3]);
    } else if (tok()) {
      cu.y_ = block(cu.w, cu.h);
    }
    if (!cu.luma_only) {
      cu.chroma_dir = tok();
      int has_cb = tok(), has_cr = tok();
      if (has_cb) cu.cb = block(cu.w >> 1, cu.h >> 1);
      if (has_cr) cu.cr = block(cu.w >> 1, cu.h >> 1);
    }
  }
  void read_chroma_cu(Cu& cu) {
    cu.chroma_only = true;
    cu.luma_mode = tok();
    cu.chroma_dir = tok();
    cu.cclm_allowed = tok() != 0;
    cu.lfnst_idx = tok();
    cu.joint = tok();
    int has_cb = tok(), has_cr = tok();
    if (has_cb) cu.cb = block(cu.w >> 1, cu.h >> 1);
    if (has_cr) cu.cr = block(cu.w >> 1, cu.h >> 1);
  }

  // SyntaxCoder._enc_chroma_cu (a leaf of the dual tree's chroma tree)
  void enc_chroma_cu(const Cu& cu, const Part& part) {
    enc_intra_chroma_mode(cu);
    bool cbf_cb, cbf_cr;
    if (cu.joint) {
      cbf_cb = cu.joint & 2;
      cbf_cr = cu.joint & 1;
    } else {
      cbf_cb = cu.cb.any();
      cbf_cr = cu.cr.any();
    }
    e.encode_bin(cbf_cb ? 1 : 0, g_offs.cbf_cb);
    e.encode_bin(cbf_cr ? 1 : 0, g_offs.cbf_cr + (cbf_cb ? 1 : 0));
    int mask = (cbf_cb ? 2 : 0) + (cbf_cr ? 1 : 0);
    if (pr[P_JCCR] && mask)
      e.encode_bin(cu.joint ? 1 : 0, g_offs.jccr + mask - 1);
    chroma_residuals(cu, cbf_cb, cbf_cr);
    code_lfnst(cu);
    finish_cu(cu, part.qt_depth);
  }

  // SyntaxCoder._enc_cu of an intra CU
  void enc_cu(const Cu& cu, const Part& part) {
    enc_intra_luma_mode(cu);
    if (!cu.luma_only) enc_intra_chroma_mode(cu);
    if (cu.isp) {
      code_isp_tus(cu);
      code_lfnst(cu);
      finish_cu(cu, part.qt_depth);
      return;
    }
    bool sdh = pr[P_SDH] != 0;
    if (cu.luma_only) {
      bool cbf_y = cu.y_.any();
      e.encode_bin(cbf_y ? 1 : 0, g_offs.cbf_y);
      maybe_code_dqp(cu, cbf_y);
      if (cbf_y) residual(cu.y_, true, sdh);
      code_lfnst(cu);
      finish_cu(cu, part.qt_depth);
      return;
    }
    bool cbf_cb, cbf_cr;
    if (cu.joint) {
      cbf_cb = cu.joint & 2;
      cbf_cr = cu.joint & 1;
    } else {
      cbf_cb = cu.cb.any();
      cbf_cr = cu.cr.any();
    }
    bool cbf_y = cu.y_.any();
    e.encode_bin(cbf_cb ? 1 : 0, g_offs.cbf_cb);
    e.encode_bin(cbf_cr ? 1 : 0, g_offs.cbf_cr + (cbf_cb ? 1 : 0));
    e.encode_bin(cbf_y ? 1 : 0, g_offs.cbf_y);
    maybe_code_dqp(cu, cbf_y || cbf_cb || cbf_cr);
    int mask = (cbf_cb ? 2 : 0) + (cbf_cr ? 1 : 0);
    if (pr[P_JCCR] && mask)
      e.encode_bin(cu.joint ? 1 : 0, g_offs.jccr + mask - 1);
    if (cbf_y) residual(cu.y_, true, sdh);
    chroma_residuals(cu, cbf_cb, cbf_cr);
    code_lfnst(cu);
    finish_cu(cu, part.qt_depth);
  }

  // SyntaxCoder._enc_tree
  void enc_tree(int x, int y, int w, int h, const Part& part) {
    if (err || !room()) return;
    int split = tok();
    if (err) return;
    if (use_dqp && part.subdiv <= qg_subdiv && part.tree_type != TREE_C &&
        part.tree_type != CHROMA_TREE) {
      qg_start = true;
      dqp_coded = false;
    }
    int tidx = part.tree_type == CHROMA_TREE ? 2 : pr[P_TREE_IDX];
    write_split_mode(x, y, w, h, part, split, tidx);
    bool unit_root = part.tree_type == TREE_L && part.last_split == -1;
    if (unit_root) {
      luma64[2 * n_luma64] = split;
      luma64[2 * n_luma64 + 1] = 0;
      ++n_luma64;
    }
    if (split == NO_SPLIT) {
      Cu cu;
      cu.x = x; cu.y = y; cu.w = w; cu.h = h;
      if (part.tree_type == CHROMA_TREE) {
        read_chroma_cu(cu);
        if (!err) enc_chroma_cu(cu, part);
        return;
      }
      cu.luma_only = part.tree_type == TREE_L;
      read_luma_cu(cu);
      if (err) return;
      if (unit_root) luma64[2 * n_luma64 - 1] = cu.isp ? 1 : 0;
      qg_leaf_start(x, y);
      enc_cu(cu, part);
      if (use_dqp) {
        qg_cus.push_back(x); qg_cus.push_back(y);
        qg_cus.push_back(w); qg_cus.push_back(h);
      }
      return;
    }
    int child_mt =
        signal_mode_cons(w, h, split, part.mode_type) == LDT_INHERIT
            ? part.mode_type
            : MODE_INTRA;
    if (part.mode_type == MODE_ALL && child_mt == MODE_INTRA) {
      fail(ERR_SCIPU);
      return;
    }
    bool is_impl = split == implicit_split(x, y, w, h, part, tidx);
    int g[4][4];
    int n = split_geometry(split, x, y, w, h, g);
    for (int idx = 0; idx < n; ++idx) {
      if (g[idx][0] >= W || g[idx][1] >= H) continue;
      // PartInfo.child, then _enc_tree's mode / tree / subdiv overrides
      Part c = part;
      c.last_split = split;
      c.part_idx = idx;
      if (split == QT_SPLIT) {
        c.qt_depth++;
        c.mtt_depth = 0;
        c.bt_depth = 0;
        c.subdiv = part.subdiv + 2;
      } else {
        c.mtt_depth++;
        c.bt_depth += 1 + ((split == TT_H || split == TT_V) ? 1 : 0);
        if (is_impl) c.impl_bt_depth++;
        c.subdiv =
            part.subdiv + (((split == TT_H || split == TT_V) && idx != 1) ? 2
                                                                          : 1);
      }
      c.mode_type = child_mt;
      enc_tree(g[idx][0], g[idx][1], g[idx][2], g[idx][3], c);
      if (err) return;
    }
  }
};

}  // namespace

extern "C" {

// context-set offsets (Offs order) and native/entropy.cpp's
// vte_write_residual
void vtw_init(const int32_t* offs, void* residual_fn) {
  int* dst = reinterpret_cast<int*>(&g_offs);
  for (size_t i = 0; i < sizeof(Offs) / sizeof(int); ++i) dst[i] = offs[i];
  g_residual = reinterpret_cast<ResidualFn>(residual_fn);
}

// index of the first per-CTU entry of the parameters
int vtw_ctu_param_index() { return P_CTU_X; }

// Writes one CTU.  params: P layout; maps: M layout (int64 addresses);
// qg: Q layout, read and written back; engine: [low, range,
// buffered_byte, num_buffered_bytes, bits_left], read and written back;
// luma64: per 64-unit of a dual tree (split of the unit's luma root, ISP
// of an unsplit root), 2 ints each, written; out: the bytes the engine
// emits.  Returns the byte count, or a negative error code.
int vtw_write_ctu(const int32_t* params, const int32_t* tree, int n_tree,
                  const int32_t* coeff, int n_coeff, const int64_t* maps,
                  uint16_t* s0, uint16_t* s1, const uint8_t* r0,
                  const uint8_t* r1, int64_t* engine, int32_t* qg,
                  int32_t* luma64, uint8_t* out, int out_cap) {
  if (!g_residual) return ERR_RECORD;
  Writer w;
  w.pr = params;
  w.W = params[P_PIC_W];
  w.H = params[P_PIC_H];
  w.ctu = params[P_CTU];
  w.uw = params[P_UW];
  w.uh = params[P_UH];
  w.cw2 = params[P_CW2];
  w.ch2 = params[P_CH2];
  w.mf_uw = params[P_MF_UW];
  w.mf_uh = params[P_MF_UH];
  auto p8 = [&](int k) { return reinterpret_cast<uint8_t*>(maps[k]); };
  auto p32 = [&](int k) { return reinterpret_cast<int32_t*>(maps[k]); };
  w.coded_luma = p8(M_CODED_LUMA);
  w.intra_mode = p32(M_INTRA_MODE);
  w.is_intra = p8(M_IS_INTRA);
  w.is_mip = p8(M_IS_MIP);
  w.cu_w = p32(M_CU_W);
  w.cu_h = p32(M_CU_H);
  w.cu_x = p32(M_CU_X);
  w.cu_y = p32(M_CU_Y);
  w.qt_depth = p32(M_QT_DEPTH);
  w.qp_map = p32(M_QP_MAP);
  w.coded_chroma = p8(M_CODED_CHROMA);
  w.ccu_w = p32(M_CCU_W);
  w.ccu_h = p32(M_CCU_H);
  w.cqt_depth = p32(M_CQT_DEPTH);
  w.mf_valid = p8(M_MF_VALID);
  w.mf_skip = p8(M_MF_SKIP);
  w.mf_isaff = p8(M_MF_ISAFF);
  w.mf_aff_valid = p8(M_MF_AFF_VALID);
  w.e.load(engine);
  w.e.s0 = s0;
  w.e.s1 = s1;
  w.e.r0 = r0;
  w.e.r1 = r1;
  w.e.out = out;
  w.out_cap = out_cap;
  w.tree = tree;
  w.n_tree = n_tree;
  w.coeff = coeff;
  w.n_coeff = n_coeff;
  w.luma64 = luma64;
  w.use_dqp = params[P_USE_DQP] != 0;
  w.qg_subdiv = params[P_QG_SUBDIV];
  w.qp_bd_off = params[P_QP_BD_OFF];
  w.slice_qp = params[P_SLICE_QP];
  w.tree_qp = params[P_TREE_QP];
  w.cur_qp = qg[Q_CUR_QP];
  w.qg_start = qg[Q_START] != 0;
  w.dqp_coded = qg[Q_CODED] != 0;
  w.qg_pred_qp = qg[Q_PRED];
  w.qg_delta_at = qg[Q_DELTA_AT];
  w.qp_y = qg[Q_QP_Y];

  int cx = params[P_CTU_X], cy = params[P_CTU_Y], ctu = w.ctu;
  if (params[P_DUAL]) {
    // SyntaxCoder.encode_ctu's dual tree: the quantization group opens at
    // the CTU root, then per 64-unit the luma tree and the chroma tree
    if (w.use_dqp) {
      w.qg_start = true;
      w.dqp_coded = false;
    }
    int unit = std::min(64, ctu), qtd = ctu > 64 ? 1 : 0;
    for (int uy = cy; uy < cy + ctu && !w.err; uy += unit)
      for (int ux = cx; ux < cx + ctu && !w.err; ux += unit) {
        if (ux >= w.W || uy >= w.H) continue;
        Part pl;
        pl.qt_depth = qtd;
        pl.subdiv = 2 * qtd;
        pl.mode_type = MODE_INTRA;
        pl.tree_type = TREE_L;
        w.enc_tree(ux, uy, unit, unit, pl);
        Part pc = pl;
        pc.tree_type = CHROMA_TREE;
        w.enc_tree(ux, uy, unit, unit, pc);
      }
  } else {
    Part root;
    w.enc_tree(cx, cy, ctu, ctu, root);
  }
  if (!w.err && (w.ti != w.n_tree || w.ci != w.n_coeff)) w.err = ERR_RECORD;
  if (w.err) return w.err;
  if (w.use_dqp) w.finalize_qg();
  w.e.save(engine);
  qg[Q_CUR_QP] = w.cur_qp;
  qg[Q_START] = w.qg_start ? 1 : 0;
  qg[Q_CODED] = w.dqp_coded ? 1 : 0;
  qg[Q_PRED] = w.qg_pred_qp;
  qg[Q_DELTA_AT] = w.qg_delta_at;
  qg[Q_QP_Y] = w.qp_y;
  return w.e.n_out;
}

}  // extern "C"

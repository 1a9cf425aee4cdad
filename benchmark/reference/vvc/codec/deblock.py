"""Deblocking filter (H.266 8.8.3) — numpy spec model for the decode loop.

Behavioral reference: vvenc CommonLib/LoopFilter.cpp (tc/beta tables :79,
long-filter xFilteringPandQ :123, luma strong/weak xPelFilterLumaCorePel
:217, chroma xPelFilterChroma :284, decisions xEdgeFilterLuma :1373,
xEdgeFilterChroma :1523, BS derivation xGetBoundaryStrengthSingle :1022,
max filter length xSetMaxFilterLengthPQFromTransformSizes :805).

Round-1 scope: intra pictures with TU == CU (no ISP/SBT/subblock motion):
every CU edge has BS 2 on all components; per-edge QP is the constant slice
QP (encoder) or per-CU average (general path kept).  Vertical edges of the
whole picture are filtered first, then horizontal edges — matching the
normative picture-level ordering.
"""

from __future__ import annotations

import numpy as np

TC_TABLE = [0]*18 + [3, 4, 4, 4, 4, 5, 5, 5, 5, 7, 7, 8, 9, 10, 10, 11, 13,
                     14, 15, 17, 19, 21, 24, 25, 29, 33, 36, 41, 45, 51, 57,
                     64, 71, 80, 89, 100, 112, 125, 141, 157, 177, 198, 222,
                     250, 280, 314, 352, 395]
BETA_TABLE = [0]*16 + [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18] + \
    list(range(20, 65, 2)) + list(range(66, 89, 2))
DEFAULT_INTRA_TC_OFFSET = 2
MAX_QP = 63

DB_COEFFS = {7: [59, 50, 41, 32, 23, 14, 5],
             5: [58, 45, 32, 19, 6],
             3: [53, 32, 11]}
TC_COEFFS = {7: [6, 5, 4, 3, 2, 1, 1], 5: [6, 5, 4, 3, 2], 3: [6, 4, 2]}


def _clip3(lo, hi, v):
    return max(lo, min(hi, v))


def _calc_dp(get, i):
    return abs(get(i, -3) - 2 * get(i, -2) + get(i, -1))


def _calc_dq(get, i):
    return abs(get(i, 0) - 2 * get(i, 1) + get(i, 2))


def _use_strong(get, i, d, beta, tc, p_large=False, q_large=False,
                max_p=7, max_q=7):
    m3, m4 = get(i, -1), get(i, 0)
    shift_beta = 4 if (p_large or q_large) else 2
    if not (d < (beta >> shift_beta) and abs(m3 - m4) < ((tc * 5 + 1) >> 1)):
        return False
    sp3 = abs(get(i, -4) - m3)
    sq3 = abs(get(i, 3) - m4)
    if p_large or q_large:
        if p_large:
            mp4 = get(i, -max_p - 1)
            if max_p == 7:
                sp3 += abs(get(i, -5) - get(i, -6) - get(i, -7) + mp4)
            sp3 = (sp3 + abs(get(i, -4) - mp4) + 1) >> 1
        if q_large:
            m11 = get(i, max_q)
            if max_q == 7:
                sq3 += abs(get(i, 4) - get(i, 5) - get(i, 6) + m11)
            sq3 = (sq3 + abs(m11 - get(i, 3)) + 1) >> 1
        return sp3 + sq3 < (beta * 3 >> 5)
    return sp3 + sq3 < (beta >> 3)


class _EdgeAccess:
    """Sample accessor across an edge: get(line, k) = sample k on line.

    k < 0 = P side (k=-1 adjacent to edge), k >= 0 = Q side.
    line runs parallel to the edge."""

    def __init__(self, plane, x, y, vertical):
        self.p = plane
        self.x, self.y = x, y
        self.vertical = vertical

    def get(self, line, k):
        if self.vertical:
            return int(self.p[self.y + line, self.x + k])
        return int(self.p[self.y + k, self.x + line])

    def set(self, line, k, v):
        if self.vertical:
            self.p[self.y + line, self.x + k] = v
        else:
            self.p[self.y + k, self.x + line] = v


def _bilinear_long(ea, lines, n_p, n_q, tc):
    """Long-tap luma filter (vvenc xFilteringPandQ:123)."""
    dbp, dbq = DB_COEFFS[n_p], DB_COEFFS[n_q]
    tcp = TC_COEFFS[7] if n_p != 3 else TC_COEFFS[3]
    tcq = TC_COEFFS[7] if n_q != 3 else TC_COEFFS[3]
    for i in range(lines):
        g = lambda k: ea.get(i, k)
        if n_p == 7:
            ref_p = (g(-7) + g(-8) + 1) >> 1
        elif n_p == 5:
            ref_p = (g(-5) + g(-6) + 1) >> 1
        else:
            ref_p = (g(-3) + g(-4) + 1) >> 1
        if n_q == 7:
            ref_q = (g(6) + g(7) + 1) >> 1
        elif n_q == 5:
            ref_q = (g(4) + g(5) + 1) >> 1
        else:
            ref_q = (g(2) + g(3) + 1) >> 1
        if n_p == n_q:
            if n_p == 5:
                mid = (2 * (g(-1) + g(0) + g(-2) + g(1) + g(-3) + g(2))
                       + g(-4) + g(3) + g(-5) + g(4) + 8) >> 4
            else:
                mid = (2 * (g(-1) + g(0)) + g(-2) + g(1) + g(-3) + g(2)
                       + g(-4) + g(3) + g(-5) + g(4) + g(-6) + g(5)
                       + g(-7) + g(6) + 8) >> 4
        else:
            big_p = n_p > n_q
            gp = (lambda k: g(-1 - k)) if big_p else (lambda k: g(k))
            gq = (lambda k: g(k)) if big_p else (lambda k: g(-1 - k))
            np_, nq_ = max(n_p, n_q), min(n_p, n_q)
            if np_ == 7 and nq_ == 5:
                mid = (2 * (g(-1) + g(0) + g(-2) + g(1)) + g(-3) + g(2)
                       + g(-4) + g(3) + g(-5) + g(4) + g(-6) + g(5) + 8) >> 4
            elif np_ == 7 and nq_ == 3:
                mid = (2 * (gp(0) + gq(0)) + gq(0) + 2 * (gq(1) + gq(2))
                       + gp(1) + gq(1) + gp(2) + gp(3) + gp(4) + gp(5)
                       + gp(6) + 8) >> 4
            else:  # 5 and 3
                mid = (g(-1) + g(0) + g(-2) + g(1) + g(-3) + g(2)
                       + g(-4) + g(3) + 4) >> 3
        for pos in range(n_p):
            src = g(-1 - pos)
            cval = (tc * tcp[pos]) >> 1
            v = (mid * dbp[pos] + ref_p * (64 - dbp[pos]) + 32) >> 6
            ea.set(i, -1 - pos, _clip3(src - cval, src + cval, v))
        for pos in range(n_q):
            src = g(pos)
            cval = (tc * tcq[pos]) >> 1
            v = (mid * dbq[pos] + ref_q * (64 - dbq[pos]) + 32) >> 6
            ea.set(i, pos, _clip3(src - cval, src + cval, v))


def _luma_short(ea, lines, tc, strong, thr_cut, filt_p, filt_q, maxval):
    tc3 = (3, 2, 1)
    for i in range(lines):
        g = lambda k: ea.get(i, k)
        m0, m1, m2, m3 = g(-4), g(-3), g(-2), g(-1)
        m4, m5, m6, m7 = g(0), g(1), g(2), g(3)
        if strong:
            ea.set(i, -3, _clip3(m1 - tc3[2]*tc, m1 + tc3[2]*tc,
                                 (2*m0 + 3*m1 + m2 + m3 + m4 + 4) >> 3))
            ea.set(i, -2, _clip3(m2 - tc3[1]*tc, m2 + tc3[1]*tc,
                                 (m1 + m2 + m3 + m4 + 2) >> 2))
            ea.set(i, -1, _clip3(m3 - tc3[0]*tc, m3 + tc3[0]*tc,
                                 (m1 + 2*m2 + 2*m3 + 2*m4 + m5 + 4) >> 3))
            ea.set(i, 0, _clip3(m4 - tc3[0]*tc, m4 + tc3[0]*tc,
                                (m2 + 2*m3 + 2*m4 + 2*m5 + m6 + 4) >> 3))
            ea.set(i, 1, _clip3(m5 - tc3[1]*tc, m5 + tc3[1]*tc,
                                (m3 + m4 + m5 + m6 + 2) >> 2))
            ea.set(i, 2, _clip3(m6 - tc3[2]*tc, m6 + tc3[2]*tc,
                                (m3 + m4 + m5 + 3*m6 + 2*m7 + 4) >> 3))
        else:
            delta = (9 * (m4 - m3) - 3 * (m5 - m2) + 8) >> 4
            if abs(delta) < thr_cut:
                delta = _clip3(-tc, tc, delta)
                tc2 = tc >> 1
                ea.set(i, -1, _clip3(0, maxval, m3 + delta))
                if filt_p:
                    d1 = _clip3(-tc2, tc2, (((m1 + m3 + 1) >> 1) - m2 + delta) >> 1)
                    ea.set(i, -2, _clip3(0, maxval, m2 + d1))
                ea.set(i, 0, _clip3(0, maxval, m4 - delta))
                if filt_q:
                    d2 = _clip3(-tc2, tc2, (((m6 + m4 + 1) >> 1) - m5 - delta) >> 1)
                    ea.set(i, 1, _clip3(0, maxval, m5 + d2))


def _filter_luma_edge_seg(plane, x, y, vertical, qp, max_p, max_q, bit_depth,
                          tc_off_div2=0, beta_off_div2=0, at_ctu_hor=False,
                          bs=2):
    """Filter one 4-line luma edge segment at (x, y) (vvenc
    xEdgeFilterLuma:1373)."""
    ea = _EdgeAccess(plane, x, y, vertical)
    g = ea.get
    maxval = (1 << bit_depth) - 1
    p_large = max_p > 3 and not at_ctu_hor
    if at_ctu_hor:
        max_p = min(max_p, 3)
    q_large = max_q > 3
    idx_tc = _clip3(0, MAX_QP + DEFAULT_INTRA_TC_OFFSET,
                    qp + DEFAULT_INTRA_TC_OFFSET * (bs - 1) + 2 * tc_off_div2)
    idx_b = _clip3(0, MAX_QP, qp + 2 * beta_off_div2)
    tc = (TC_TABLE[idx_tc] + (1 << (9 - bit_depth))) >> (10 - bit_depth) \
        if bit_depth < 10 else TC_TABLE[idx_tc] << (bit_depth - 10)
    beta = BETA_TABLE[idx_b] << (bit_depth - 8)
    side_thr = (beta + (beta >> 1)) >> 3
    thr_cut = tc * 10
    dp0, dq0 = _calc_dp(g, 0), _calc_dq(g, 0)
    dp3, dq3 = _calc_dp(g, 3), _calc_dq(g, 3)
    d0, d3 = dp0 + dq0, dp3 + dq3
    if p_large or q_large:
        dp0l = ((dp0 + abs(g(0, -6) - 2*g(0, -5) + g(0, -4)) + 1) >> 1) if p_large else dp0
        dq0l = ((dq0 + abs(g(0, 3) - 2*g(0, 4) + g(0, 5)) + 1) >> 1) if q_large else dq0
        dp3l = ((dp3 + abs(g(3, -6) - 2*g(3, -5) + g(3, -4)) + 1) >> 1) if p_large else dp3
        dq3l = ((dq3 + abs(g(3, 3) - 2*g(3, 4) + g(3, 5)) + 1) >> 1) if q_large else dq3
        d0l, d3l = dp0l + dq0l, dp3l + dq3l
        if d0l + d3l < beta:
            sw = _use_strong(g, 0, 2*d0l, beta, tc, p_large, q_large, max_p, max_q) \
                and _use_strong(g, 3, 2*d3l, beta, tc, p_large, q_large, max_p, max_q)
            if sw:
                _bilinear_long(ea, 4, max_p if p_large else 3,
                               max_q if q_large else 3, tc)
                return
    d = d0 + d3
    if d < beta:
        filt_p = filt_q = False
        if max_p > 1 and max_q > 1:
            filt_p = (dp0 + dp3) < side_thr
            filt_q = (dq0 + dq3) < side_thr
        sw = False
        if max_p > 2 and max_q > 2:
            sw = _use_strong(g, 0, 2*d0, beta, tc) and \
                _use_strong(g, 3, 2*d3, beta, tc)
        _luma_short(ea, 4, tc, sw, thr_cut, filt_p, filt_q, maxval)


def _filter_chroma_edge_seg(plane, x, y, vertical, qp, large, bit_depth,
                            lines=2, at_ctu_hor=False,
                            tc_off_div2=0, beta_off_div2=0, bs=2):
    """Filter one chroma edge segment (vvenc xEdgeFilterChroma:1523),
    `lines` chroma lines."""
    ea = _EdgeAccess(plane, x, y, vertical)
    g = ea.get
    maxval = (1 << bit_depth) - 1
    idx_tc = _clip3(0, MAX_QP + DEFAULT_INTRA_TC_OFFSET,
                    qp + DEFAULT_INTRA_TC_OFFSET * (bs - 1) + 2 * tc_off_div2)
    tc = (TC_TABLE[idx_tc] + (1 << (9 - bit_depth))) >> (10 - bit_depth) \
        if bit_depth < 10 else TC_TABLE[idx_tc] << (bit_depth - 10)
    if tc == 0:
        return
    use_long = False
    sw = False
    if large:
        idx_b = _clip3(0, MAX_QP, qp + 2 * beta_off_div2)
        beta = BETA_TABLE[idx_b] << (bit_depth - 8)

        def dp(i):
            if at_ctu_hor:
                return abs(g(i, -2) - 2*g(i, -2) + g(i, -1))
            return abs(g(i, -3) - 2*g(i, -2) + g(i, -1))

        def dq(i):
            return abs(g(i, 0) - 2*g(i, 1) + g(i, 2))
        d0 = dp(0) + dq(0)
        d3 = dp(1) + dq(1)   # 4:2:0 subsampling: second line
        if d0 + d3 < beta:
            use_long = True
            sw = (_use_strong_chroma(g, 0, 2*d0, beta, tc, at_ctu_hor)
                  and _use_strong_chroma(g, 1, 2*d3, beta, tc, at_ctu_hor))
    for i in range(lines):
        _chroma_pel(ea, i, tc, use_long and sw, maxval, large, at_ctu_hor)


def _use_strong_chroma(g, i, d, beta, tc, at_ctu_hor):
    m3, m4 = g(i, -1), g(i, 0)
    if not (d < (beta >> 2) and abs(m3 - m4) < ((tc * 5 + 1) >> 1)):
        return False
    sp3 = abs(g(i, -2) - m3) if at_ctu_hor else abs(g(i, -4) - m3)
    sq3 = abs(g(i, 3) - m4)
    return sp3 + sq3 < (beta >> 3)


def _chroma_pel(ea, i, tc, sw, maxval, large, at_ctu_hor):
    g = lambda k: ea.get(i, k)
    m0, m1, m2, m3 = g(-4), g(-3), g(-2), g(-1)
    m4, m5, m6, m7 = g(0), g(1), g(2), g(3)
    if sw:
        if at_ctu_hor:
            ea.set(i, -1, _clip3(m3 - tc, m3 + tc, (3*m2 + 2*m3 + m4 + m5 + m6 + 4) >> 3))
            ea.set(i, 0, _clip3(m4 - tc, m4 + tc, (2*m2 + m3 + 2*m4 + m5 + m6 + m7 + 4) >> 3))
            ea.set(i, 1, _clip3(m5 - tc, m5 + tc, (m2 + m3 + m4 + 2*m5 + m6 + 2*m7 + 4) >> 3))
            ea.set(i, 2, _clip3(m6 - tc, m6 + tc, (m3 + m4 + m5 + 2*m6 + 3*m7 + 4) >> 3))
        else:
            ea.set(i, -3, _clip3(m1 - tc, m1 + tc, (3*m0 + 2*m1 + m2 + m3 + m4 + 4) >> 3))
            ea.set(i, -2, _clip3(m2 - tc, m2 + tc, (2*m0 + m1 + 2*m2 + m3 + m4 + m5 + 4) >> 3))
            ea.set(i, -1, _clip3(m3 - tc, m3 + tc, (m0 + m1 + m2 + 2*m3 + m4 + m5 + m6 + 4) >> 3))
            ea.set(i, 0, _clip3(m4 - tc, m4 + tc, (m1 + m2 + m3 + 2*m4 + m5 + m6 + m7 + 4) >> 3))
            ea.set(i, 1, _clip3(m5 - tc, m5 + tc, (m2 + m3 + m4 + 2*m5 + m6 + 2*m7 + 4) >> 3))
            ea.set(i, 2, _clip3(m6 - tc, m6 + tc, (m3 + m4 + m5 + 2*m6 + 3*m7 + 4) >> 3))
    else:
        delta = _clip3(-tc, tc, (4 * (m4 - m3) + m2 - m5 + 4) >> 3)
        ea.set(i, -1, _clip3(0, maxval, m3 + delta))
        ea.set(i, 0, _clip3(0, maxval, m4 - delta))


_MV_TH = 8  # half-pel in internal 1/16 units (vvenc nThreshold)


class _BsMaps:
    """Per-4x4-unit picture maps for boundary-strength derivation."""

    def __init__(self, cu_list, w, h, ref_pocs):
        uw, uh = w // 4, h // 4
        self.cu_w = np.zeros((uh, uw), np.int32)
        self.cu_h = np.zeros((uh, uw), np.int32)
        self.intra = np.ones((uh, uw), bool)
        self.cbf = np.zeros((3, uh, uw), bool)
        self.joint3 = np.zeros((uh, uw), bool)
        self.mv = np.zeros((2, uh, uw, 2), np.int32)
        self.refpoc = np.full((2, uh, uw), -(10 ** 9), np.int64)
        self.subblk = np.zeros((uh, uw), bool)   # affine / SbTMVP CU
        self.ciip = np.zeros((uh, uw), bool)
        self.bdpcm_y = np.zeros((uh, uw), bool)
        self.bdpcm_c = np.zeros((uh, uw), bool)
        # chroma-channel intra-ness (differs from luma under a local dual
        # tree: TREE_C chroma CUs are intra even over IBC/inter luma)
        self.cintra = np.ones((uh, uw), bool)
        rp = ref_pocs or [[], []]
        for cu in cu_list:
            ys = slice(cu.y >> 2, (cu.y + cu.h) >> 2)
            xs = slice(cu.x >> 2, (cu.x + cu.w) >> 2)
            joint = getattr(cu, "joint_cbcr", 0)
            if joint == 3:
                self.joint3[ys, xs] = True
            if getattr(cu, "chroma_only", False):
                # TREE_C chroma CU of a local dual tree: contributes only
                # the chroma cbf flags (always intra).  JCCR: the SIGNALLED
                # cbf mask drives the boundary strength.
                for ci, a in ((1, "coeff_cb"), (2, "coeff_cr")):
                    self.cbf[ci, ys, xs] = \
                        (getattr(cu, a, None) is not None or joint != 0)
                self.cintra[ys, xs] = True
                if getattr(cu, "bdpcm_c", 0):
                    self.bdpcm_c[ys, xs] = True
                continue
            isp = getattr(cu, "isp_mode", 0)
            sbt = getattr(cu, "sbt_idx", 0)
            if isp:
                # ISP: luma TU dims drive the max-filter-length derivation
                from .ctu_syntax import isp_partitions
                _, _, pw_, ph_ = isp_partitions(cu.w, cu.h, isp)[0]
                self.cu_w[ys, xs] = pw_
                self.cu_h[ys, xs] = ph_
            elif sbt:
                from .ctu_syntax import sbt_tu_rect
                tx_, ty_, tw_, th_ = sbt_tu_rect(cu)[:4]
                # per-position TU dims of the two SBT transform units
                self.cu_w[ys, xs] = cu.w if sbt in (2, 4) else cu.w - tw_
                self.cu_h[ys, xs] = cu.h if sbt in (1, 3) else cu.h - th_
                rys = slice((cu.y + ty_) >> 2, (cu.y + ty_ + th_) >> 2)
                rxs = slice((cu.x + tx_) >> 2, (cu.x + tx_ + tw_) >> 2)
                self.cu_w[rys, rxs] = tw_ if sbt in (1, 3) else cu.w
                self.cu_h[rys, rxs] = th_ if sbt in (2, 4) else cu.h
            elif getattr(cu, "mtb_tus", None) is not None:
                # implicit max-TB tiling: TU dims drive the filter lengths
                for (tx, ty, tw_, th_, *_rest) in cu.mtb_tus:
                    rys = slice((cu.y + ty) >> 2, (cu.y + ty + th_) >> 2)
                    rxs = slice((cu.x + tx) >> 2, (cu.x + tx + tw_) >> 2)
                    self.cu_w[rys, rxs] = tw_
                    self.cu_h[rys, rxs] = th_
            else:
                self.cu_w[ys, xs] = cu.w
                self.cu_h[ys, xs] = cu.h
            is_inter = getattr(cu, "is_inter", False)
            self.intra[ys, xs] = not is_inter
            if not getattr(cu, "luma_only", False):
                self.cintra[ys, xs] = not is_inter
            if getattr(cu, "bdpcm_y", 0):
                self.bdpcm_y[ys, xs] = True
            if getattr(cu, "bdpcm_c", 0):
                self.bdpcm_c[ys, xs] = True
            if sbt:
                # cbf flags live only on the residual TU region
                self.cbf[0, rys, rxs] = getattr(cu, "coeff_y", None) is not None
                for ci, a in ((1, "coeff_cb"), (2, "coeff_cr")):
                    self.cbf[ci, rys, rxs] = \
                        (getattr(cu, a, None) is not None or joint != 0)
            elif getattr(cu, "mtb_tus", None) is not None:
                for (tx, ty, tw_, th_, cy_, ccb, ccr, j_, _tb, _tr) in cu.mtb_tus:
                    rys = slice((cu.y + ty) >> 2, (cu.y + ty + th_) >> 2)
                    rxs = slice((cu.x + tx) >> 2, (cu.x + tx + tw_) >> 2)
                    self.cbf[0, rys, rxs] = cy_ is not None
                    self.cbf[1, rys, rxs] = (ccb is not None) or j_ != 0
                    self.cbf[2, rys, rxs] = (ccr is not None) or j_ != 0
                    if j_ == 3:
                        self.joint3[rys, rxs] = True
            else:
                self.cbf[0, ys, xs] = getattr(cu, "coeff_y", None) is not None
                if not getattr(cu, "luma_only", False):
                    # any JCCR mode sets BOTH chroma cbf flags for BS
                    # (vvenc LoopFilter.cpp:1111-1112)
                    for ci, a in ((1, "coeff_cb"), (2, "coeff_cr")):
                        self.cbf[ci, ys, xs] = \
                            (getattr(cu, a, None) is not None or joint != 0)
            if is_inter:
                if getattr(cu, "is_ibc", False):
                    # IBC: own-picture 'reference' sentinel + BV as motion
                    # (xGetBoundaryStrengthSingle piRefP0 = slice.pic)
                    self.refpoc[0, ys, xs] = 10 ** 8
                    self.mv[0, ys, xs, 0] = cu.mv[0][0]
                    self.mv[0, ys, xs, 1] = cu.mv[0][1]
                    continue
                if getattr(cu, "ciip", False):
                    self.ciip[ys, xs] = True
                sub_mi = getattr(cu, "sub_mi", None)
                if sub_mi is not None:
                    # affine/SbTMVP/GEO: per-4x4 sub-block motion; only
                    # affine-family CUs shorten the long filters
                    if getattr(cu, "affine", False):
                        self.subblk[ys, xs] = True
                    for uy in range(cu.y >> 2, (cu.y + cu.h) >> 2):
                        for ux in range(cu.x >> 2, (cu.x + cu.w) >> 2):
                            mi = sub_mi[uy - (cu.y >> 2)][ux - (cu.x >> 2)]
                            for li in range(2):
                                ri = mi.ref_idx[li]
                                if ri >= 0 and li < len(rp) \
                                        and ri < len(rp[li]):
                                    self.refpoc[li, uy, ux] = rp[li][ri]
                                    self.mv[li, uy, ux, 0] = mi.mv[li][0]
                                    self.mv[li, uy, ux, 1] = mi.mv[li][1]
                    continue
                for li in range(2):
                    ri = cu.ref_idx[li]
                    if ri >= 0 and li < len(rp) and ri < len(rp[li]):
                        self.refpoc[li, ys, xs] = rp[li][ri]
                        self.mv[li, ys, xs, 0] = cu.mv[li][0]
                        self.mv[li, ys, xs, 1] = cu.mv[li][1]

    def bs(self, py, px, qy, qx, is_b, tu_edge: bool = True,
           pu_edge: bool = True):
        """(bs_y, bs_cb, bs_cr) for the edge between units P and Q
        (vvenc xGetBoundaryStrengthSingle, LoopFilter.cpp:1022).
        tu_edge=False: internal sub-block edge — cbf rule does not apply.
        pu_edge=False: transform-only internal edge (SBT / max-TB split) —
        the motion comparison does not apply (edge-type gate,
        LoopFilter.cpp: BsGet(bs, MAX_NUM_COMP) != 3 early return)."""
        chroma_int = self.cintra[py, px] or self.cintra[qy, qx]
        bs_c_intra = 0 if (self.bdpcm_c[py, px] and
                           self.bdpcm_c[qy, qx]) else 2
        if self.intra[py, px] or self.intra[qy, qx]:
            # BDPCM on both sides -> BS 0 (LoopFilter.cpp:1082,1068)
            bs_y = 0 if (self.bdpcm_y[py, px] and self.bdpcm_y[qy, qx]) else 2
            return bs_y, bs_c_intra, bs_c_intra
        if self.ciip[py, px] or self.ciip[qy, qx]:
            if chroma_int:
                return 2, bs_c_intra, bs_c_intra
            return 2, 2, 2
        if chroma_int:
            bs_cb = bs_cr = bs_c_intra
        else:
            bs_cb = 1 if (self.cbf[1, py, px] or self.cbf[1, qy, qx]) else 0
            bs_cr = 1 if (self.cbf[2, py, px] or self.cbf[2, qy, qx]) else 0
        if tu_edge and (self.cbf[0, py, px] or self.cbf[0, qy, qx]):
            return 1, bs_cb, bs_cr
        if not pu_edge:
            return 0, bs_cb, bs_cr
        rp0, rp1 = self.refpoc[0, py, px], self.refpoc[1, py, px]
        rq0, rq1 = self.refpoc[0, qy, qx], self.refpoc[1, qy, qx]
        mp0, mp1 = self.mv[0, py, px], self.mv[1, py, px]
        mq0, mq1 = self.mv[0, qy, qx], self.mv[1, qy, qx]

        def far(a, b):
            return abs(int(a[0]) - int(b[0])) >= _MV_TH or \
                abs(int(a[1]) - int(b[1])) >= _MV_TH
        if is_b:
            if (rp0 == rq0 and rp1 == rq1) or (rp0 == rq1 and rp1 == rq0):
                if rp0 != rp1:  # different L0 & L1 pictures
                    if rp0 == rq0:
                        m_bs = 1 if (far(mq0, mp0) or far(mq1, mp1)) else 0
                    else:
                        m_bs = 1 if (far(mq1, mp0) or far(mq0, mp1)) else 0
                else:           # same picture in both lists
                    m_bs = 1 if ((far(mq0, mp0) or far(mq1, mp1)) and
                                 (far(mq1, mp0) or far(mq0, mp1))) else 0
            else:
                m_bs = 1
        else:
            m_bs = 1 if (rp0 != rq0 or far(mq0, mp0)) else 0
        return m_bs, bs_cb, bs_cr


class _BatchCollector:
    """Collects edge segments per direction and applies them through the
    vectorized batch kernel (ops/deblock_batch.py) in dependency waves —
    bit-exact vs the sequential per-segment filtering."""

    def __init__(self, rec, bit_depth):
        self.rec = rec
        self.bd = bit_depth
        self._reset()

    def _reset(self):
        self.luma_segs = []
        self.chroma_segs = {1: [], 2: []}

    def luma(self, plane, x, y, vertical, qp, max_p, max_q, bit_depth,
             tc_off_div2=0, beta_off_div2=0, at_ctu_hor=False, bs=2):
        self.luma_segs.append((x, y, qp, max_p, max_q, bs, at_ctu_hor))

    def chroma(self, plane, x, y, vertical, qp, large, bit_depth,
               lines=2, at_ctu_hor=False, tc_off_div2=0,
               beta_off_div2=0, bs=2):
        comp = 1 if plane is self.rec[1] else 2
        self.chroma_segs[comp].append((x, y, qp, large, lines,
                                       at_ctu_hor, bs))

    def flush(self, vertical: bool) -> None:
        from ..ops.deblock_batch import (filter_luma_edges,
                                         filter_chroma_edges, plan_waves)
        segs = self.luma_segs
        if segs:
            xs = [s[0] for s in segs]
            ys = [s[1] for s in segs]
            # effective (post-CTU-cap) extents drive the wave planning
            mp_eff = [min(s[3], 3) if s[6] else s[3] for s in segs]
            p_lg = [s[3] > 3 and not s[6] for s in segs]
            q_lg = [s[4] > 3 for s in segs]
            ts = xs if vertical else ys
            pars = ys if vertical else xs
            waves = plan_waves(ts, pars, mp_eff, [s[4] for s in segs],
                               p_lg, q_lg)
            for w in range(max(waves) + 1):
                idx = [i for i, wv in enumerate(waves) if wv == w]
                filter_luma_edges(self.rec[0], {
                    "x": [xs[i] for i in idx],
                    "y": [ys[i] for i in idx],
                    "qp": [segs[i][2] for i in idx],
                    "max_p": [segs[i][3] for i in idx],
                    "max_q": [segs[i][4] for i in idx],
                    "bs": [segs[i][5] for i in idx],
                    "at_ctu": [segs[i][6] for i in idx],
                    "vertical": vertical}, self.bd)
        for comp in (1, 2):
            cs = self.chroma_segs[comp]
            if cs:
                filter_chroma_edges(self.rec[comp], {
                    "x": [s[0] for s in cs],
                    "y": [s[1] for s in cs],
                    "qp": [s[2] for s in cs],
                    "large": [s[3] for s in cs],
                    "lines": [s[4] for s in cs],
                    "at_ctu": [s[5] for s in cs],
                    "bs": [s[6] for s in cs],
                    "vertical": vertical}, self.bd)
        self._reset()


def deblock_picture(rec, cu_list, qp_luma: int, qp_cb: int, qp_cr: int,
                    ctu_size: int, bit_depth: int = 10,
                    ref_pocs=None, is_b: bool = False,
                    qp_map=None, chroma_qp_fn=None, y_band=None,
                    batch=True) -> None:
    """In-place deblocking of one picture.

    y_band=(y0, y1): filter only edges of CUs whose top-left y falls in
    [y0, y1) — CTU-row banding for IFP-style pipelining.  Per-row banded
    calls in raster order compose to exactly the monolithic result: a
    row's edges only read/write rows r-1 and r, and the spec's
    all-vertical-then-all-horizontal order commutes across disjoint row
    bands (vvenc EncSlice CTU-task LoopFilter stages).  cu_list may be
    the partial list of CUs coded so far; the band's BS derivation only
    reads map rows r-1/r.

    rec: {0: Y, 1: Cb, 2: Cr} planes (modified in place).
    cu_list: iterable of CuData-likes (x, y, w, h luma coords, TU == CU;
    inter CUs carry mv/ref_idx/coeff_*).  qp_*: constant per-component QPs
    (slice-level; chroma already mapped, WITHOUT the bit-depth offset).
    qp_map: optional per-4x4-unit luma QP map (PictureState.qp_map); with
    chroma_qp_fn(qp_y, comp) enables the per-CU-QP edge derivation
    (vvenc LoopFilter.cpp:1041 luma avg, :1055-1060 per-side chroma map).
    ref_pocs: [l0 pocs, l1 pocs] resolving ref_idx for the BS motion check;
    is_b: slice is a B slice (selects the bi-directional BS rule).
    """
    h, w = rec[0].shape
    maps = _BsMaps(cu_list, w, h, ref_pocs)
    # batched edge filtering: collect each direction's segments, then
    # apply them via the vectorized kernel in dependency waves
    # (ops/deblock_batch.py); bit-exact vs the sequential path
    collector = _BatchCollector(rec, bit_depth) if batch else None
    flt_luma = collector.luma if batch else _filter_luma_edge_seg
    flt_chroma = collector.chroma if batch else _filter_chroma_edge_seg
    cu_w, cu_h = maps.cu_w, maps.cu_h
    # chroma-tree geometry: blocks that carry chroma (with a local dual
    # tree the TREE_C chroma CU spans several luma CUs)
    chroma_cus = [cu for cu in cu_list
                  if not getattr(cu, "luma_only", False)]
    cuw2, cuh2 = max(1, (w >> 1) >> 1), max(1, (h >> 1) >> 1)
    cblk_w = np.zeros((cuh2, cuw2), np.int32)
    cblk_h = np.zeros((cuh2, cuw2), np.int32)
    for cu in chroma_cus:
        ys2 = slice((cu.y >> 1) >> 1, ((cu.y + cu.h) >> 1) >> 1)
        xs2 = slice((cu.x >> 1) >> 1, ((cu.x + cu.w) >> 1) >> 1)
        sbt = getattr(cu, "sbt_idx", 0)
        if sbt:
            # SBT splits the chroma TUs as well
            from .ctu_syntax import sbt_tu_rect
            tx_, ty_, tw_, th_ = sbt_tu_rect(cu)[:4]
            cblk_w[ys2, xs2] = (cu.w >> 1) if sbt in (2, 4) \
                else (cu.w - tw_) >> 1
            cblk_h[ys2, xs2] = (cu.h >> 1) if sbt in (1, 3) \
                else (cu.h - th_) >> 1
            rys2 = slice(((cu.y + ty_) >> 1) >> 1,
                         ((cu.y + ty_ + th_) >> 1) >> 1)
            rxs2 = slice(((cu.x + tx_) >> 1) >> 1,
                         ((cu.x + tx_ + tw_) >> 1) >> 1)
            cblk_w[rys2, rxs2] = (tw_ >> 1) if sbt in (1, 3) else (cu.w >> 1)
            cblk_h[rys2, rxs2] = (th_ >> 1) if sbt in (2, 4) else (cu.h >> 1)
        elif getattr(cu, "mtb_tus", None) is not None:
            for (tx, ty, tw_, th_, *_rest) in cu.mtb_tus:
                rys2 = slice(((cu.y + ty) >> 1) >> 1,
                             ((cu.y + ty + th_) >> 1) >> 1)
                rxs2 = slice(((cu.x + tx) >> 1) >> 1,
                             ((cu.x + tx + tw_) >> 1) >> 1)
                cblk_w[rys2, rxs2] = tw_ >> 1
                cblk_h[rys2, rxs2] = th_ >> 1
        else:
            cblk_w[ys2, xs2] = cu.w >> 1
            cblk_h[ys2, xs2] = cu.h >> 1

    if qp_map is not None:
        def luma_edge_qp(pu_y, pu_x, qu_y, qu_x):
            return (int(qp_map[pu_y, pu_x]) + int(qp_map[qu_y, qu_x]) + 1) \
                >> 1

        # the per-side chroma QP mapping sees only a handful of distinct
        # (qp, comp, joint) inputs per picture — memoize it (20k calls
        # per 416x240 frame went through the full table lookup)
        _cqp_cache = {}

        def _cqp(qp_v, comp, joint):
            key = (qp_v, comp, joint)
            v = _cqp_cache.get(key)
            if v is None:
                v = _cqp_cache[key] = chroma_qp_fn(qp_v, comp, joint)
            return v

        def chroma_edge_qp(pu_y, pu_x, qu_y, qu_x, comp):
            # each side uses its own QpParam: joint-CbCr TUs (ICT mode |2|)
            # take the joint QP (vvenc LoopFilter.cpp:1055, Quant QpParam)
            qp_p = _cqp(int(qp_map[pu_y, pu_x]), comp,
                        bool(maps.joint3[pu_y, pu_x]))
            qp_q = _cqp(int(qp_map[qu_y, qu_x]), comp,
                        bool(maps.joint3[qu_y, qu_x]))
            return (qp_p + qp_q + 1) >> 1
    else:
        def luma_edge_qp(pu_y, pu_x, qu_y, qu_x):
            return qp_luma

        def chroma_edge_qp(pu_y, pu_x, qu_y, qu_x, comp):
            return qp_cb if comp == 1 else qp_cr

    def luma_maxlen(size_p, size_q, p_sub=False, q_sub=False):
        """Max filter lengths; sub-block CUs shorten the long filters
        (LoopFilter.cpp:906 cuP->affine -> 5;
        xSetMaxFilterLengthPQForCodingSubBlocks:961 q side min 5)."""
        if size_p <= 4 or size_q <= 4:
            return 1, 1
        mp = (5 if p_sub else 7) if size_p >= 32 else 3
        mq = 7 if size_q >= 32 else 3
        if q_sub:
            mq = min(mq, 5)
        return mp, mq

    def _sub_maxlen(off, size):
        """Internal sub-block edge lengths (LoopFilter.cpp:969-980,
        TU == CU: only the 8-proximity cases arise)."""
        return 2 if (off == 8 or off + 8 >= size) else 3

    # ---- vertical edges (whole picture), then horizontal -----------------
    for vertical in (True, False):
        for cu in cu_list:
            if y_band is not None and not (y_band[0] <= cu.y < y_band[1]):
                continue
            if getattr(cu, "chroma_only", False):
                continue
            # internal 8-grid edges only for affine-family CUs (refineBs;
            # GEO stores per-subblock motion but adds no internal edges)
            q_sub = bool(getattr(cu, "affine", False))
            isp = getattr(cu, "isp_mode", 0)
            # internal transform-edge x/y offsets (SBT halves / max-TB
            # tiling) — these coincide with 8-grid subblock edges in
            # affine/SbTMVP CUs and then carry BOTH edge flags
            tu_xs, tu_ys = set(), set()
            sbt_ = getattr(cu, "sbt_idx", 0)
            if sbt_:
                from .ctu_syntax import sbt_tu_rect
                tx0_, ty0_, tw0_, th0_ = sbt_tu_rect(cu)[:4]
                if sbt_ in (1, 3):
                    tu_xs.add(cu.x + (tx0_ + tw0_ if cu.sbt_pos == 0
                                      else tx0_))
                else:
                    tu_ys.add(cu.y + (ty0_ + th0_ if cu.sbt_pos == 0
                                      else ty0_))
            if getattr(cu, "mtb_tus", None) is not None:
                tu_xs.update(cu.x + o for o in range(64, cu.w, 64))
                tu_ys.update(cu.y + o for o in range(64, cu.h, 64))
            if vertical:
                x = cu.x
                if x != 0:
                    for yy in range(cu.y, cu.y + cu.h, 4):
                        bs_y, _, _ = maps.bs(yy >> 2, (x - 1) >> 2,
                                             yy >> 2, x >> 2, is_b)
                        if not bs_y:
                            continue
                        size_q = int(cu_w[yy >> 2, x >> 2])
                        size_p = int(cu_w[yy >> 2, (x - 1) >> 2])
                        mp, mq = luma_maxlen(
                            size_p, size_q,
                            bool(maps.subblk[yy >> 2, (x - 1) >> 2]), q_sub)
                        eqp = luma_edge_qp(yy >> 2, (x - 1) >> 2, yy >> 2,
                                           x >> 2)
                        flt_luma(rec[0], x, yy, True, eqp,
                                              mp, mq, bit_depth, bs=bs_y)
                if q_sub:
                    for off in range(8, cu.w, 8):
                        xi = cu.x + off
                        if xi in tu_xs:
                            continue   # handled as a combined TU+PU edge
                        ml = _sub_maxlen(off, cu.w)
                        for yy in range(cu.y, cu.y + cu.h, 4):
                            bs_y, _, _ = maps.bs(yy >> 2, (xi - 1) >> 2,
                                                 yy >> 2, xi >> 2, is_b,
                                                 tu_edge=False)
                            if not bs_y:
                                continue
                            eqp = luma_edge_qp(yy >> 2, (xi - 1) >> 2,
                                               yy >> 2, xi >> 2)
                            flt_luma(rec[0], xi, yy, True, eqp,
                                                  ml, ml, bit_depth, bs=bs_y)
                if isp == 2:
                    # vertical-split ISP: internal TU edges on the 4-grid
                    # (BS 2 luma-only, LoopFilter.cpp:1083 cuQ.ispMode)
                    pw_ = int(cu_w[cu.y >> 2, cu.x >> 2])
                    step = max(4, pw_)
                    mp, mq = luma_maxlen(pw_, pw_)
                    for off in range(step, cu.w, step):
                        xi = cu.x + off
                        for yy in range(cu.y, cu.y + cu.h, 4):
                            eqp = luma_edge_qp(yy >> 2, (xi - 1) >> 2,
                                               yy >> 2, xi >> 2)
                            flt_luma(rec[0], xi, yy, True, eqp,
                                                  mp, mq, bit_depth, bs=2)
                sbt = getattr(cu, "sbt_idx", 0)
                if sbt in (1, 3):
                    # vertical SBT split: one internal transform edge
                    from .ctu_syntax import sbt_tu_rect
                    tx_, _, tw_, _ = sbt_tu_rect(cu)[:4]
                    xi = cu.x + (tx_ + tw_ if cu.sbt_pos == 0 else tx_)
                    for yy in range(cu.y, cu.y + cu.h, 4):
                        bs_y, _, _ = maps.bs(yy >> 2, (xi - 1) >> 2,
                                             yy >> 2, xi >> 2, is_b,
                                             pu_edge=q_sub)
                        if not bs_y:
                            continue
                        mp, mq = luma_maxlen(int(cu_w[yy >> 2, (xi - 1) >> 2]),
                                             int(cu_w[yy >> 2, xi >> 2]),
                                             q_sub, q_sub)
                        eqp = luma_edge_qp(yy >> 2, (xi - 1) >> 2,
                                           yy >> 2, xi >> 2)
                        flt_luma(rec[0], xi, yy, True, eqp,
                                              mp, mq, bit_depth, bs=bs_y)
                if getattr(cu, "mtb_tus", None) is not None and cu.w > 64:
                    # internal max-TB transform edges on the 64-grid
                    for off in range(64, cu.w, 64):
                        xi = cu.x + off
                        for yy in range(cu.y, cu.y + cu.h, 4):
                            bs_y, _, _ = maps.bs(yy >> 2, (xi - 1) >> 2,
                                                 yy >> 2, xi >> 2, is_b,
                                                 pu_edge=q_sub)
                            if not bs_y:
                                continue
                            mp, mq = luma_maxlen(
                                int(cu_w[yy >> 2, (xi - 1) >> 2]),
                                int(cu_w[yy >> 2, xi >> 2]),
                                q_sub, q_sub)
                            eqp = luma_edge_qp(yy >> 2, (xi - 1) >> 2,
                                               yy >> 2, xi >> 2)
                            flt_luma(rec[0], xi, yy, True, eqp,
                                                  mp, mq, bit_depth,
                                                  bs=bs_y)
            else:
                y = cu.y
                if y != 0:
                    for xx in range(cu.x, cu.x + cu.w, 4):
                        bs_y, _, _ = maps.bs((y - 1) >> 2, xx >> 2,
                                             y >> 2, xx >> 2, is_b)
                        if not bs_y:
                            continue
                        size_q = int(cu_h[y >> 2, xx >> 2])
                        size_p = int(cu_h[(y - 1) >> 2, xx >> 2])
                        mp, mq = luma_maxlen(
                            size_p, size_q,
                            bool(maps.subblk[(y - 1) >> 2, xx >> 2]), q_sub)
                        eqp = luma_edge_qp((y - 1) >> 2, xx >> 2, y >> 2,
                                           xx >> 2)
                        flt_luma(rec[0], xx, y, False, eqp,
                                              mp, mq, bit_depth,
                                              at_ctu_hor=(y % ctu_size == 0),
                                              bs=bs_y)
                if q_sub:
                    for off in range(8, cu.h, 8):
                        yi = cu.y + off
                        if yi in tu_ys:
                            continue   # handled as a combined TU+PU edge
                        ml = _sub_maxlen(off, cu.h)
                        for xx in range(cu.x, cu.x + cu.w, 4):
                            bs_y, _, _ = maps.bs((yi - 1) >> 2, xx >> 2,
                                                 yi >> 2, xx >> 2, is_b,
                                                 tu_edge=False)
                            if not bs_y:
                                continue
                            eqp = luma_edge_qp((yi - 1) >> 2, xx >> 2,
                                               yi >> 2, xx >> 2)
                            flt_luma(rec[0], xx, yi, False, eqp,
                                                  ml, ml, bit_depth,
                                                  at_ctu_hor=False, bs=bs_y)
                if isp == 1:
                    # horizontal-split ISP: internal TU edges on the 4-grid
                    ph_ = int(cu_h[cu.y >> 2, cu.x >> 2])
                    step = max(4, ph_)
                    mp, mq = luma_maxlen(ph_, ph_)
                    for off in range(step, cu.h, step):
                        yi = cu.y + off
                        for xx in range(cu.x, cu.x + cu.w, 4):
                            eqp = luma_edge_qp((yi - 1) >> 2, xx >> 2,
                                               yi >> 2, xx >> 2)
                            flt_luma(rec[0], xx, yi, False, eqp,
                                                  mp, mq, bit_depth,
                                                  at_ctu_hor=False, bs=2)
                sbt = getattr(cu, "sbt_idx", 0)
                if sbt in (2, 4):
                    # horizontal SBT split: one internal transform edge
                    from .ctu_syntax import sbt_tu_rect
                    _, ty_, _, th_ = sbt_tu_rect(cu)[:4]
                    yi = cu.y + (ty_ + th_ if cu.sbt_pos == 0 else ty_)
                    for xx in range(cu.x, cu.x + cu.w, 4):
                        bs_y, _, _ = maps.bs((yi - 1) >> 2, xx >> 2,
                                             yi >> 2, xx >> 2, is_b,
                                             pu_edge=q_sub)
                        if not bs_y:
                            continue
                        mp, mq = luma_maxlen(int(cu_h[(yi - 1) >> 2, xx >> 2]),
                                             int(cu_h[yi >> 2, xx >> 2]),
                                             q_sub, q_sub)
                        eqp = luma_edge_qp((yi - 1) >> 2, xx >> 2,
                                           yi >> 2, xx >> 2)
                        flt_luma(rec[0], xx, yi, False, eqp,
                                              mp, mq, bit_depth,
                                              at_ctu_hor=False, bs=bs_y)
                if getattr(cu, "mtb_tus", None) is not None and cu.h > 64:
                    for off in range(64, cu.h, 64):
                        yi = cu.y + off
                        for xx in range(cu.x, cu.x + cu.w, 4):
                            bs_y, _, _ = maps.bs((yi - 1) >> 2, xx >> 2,
                                                 yi >> 2, xx >> 2, is_b,
                                                 pu_edge=q_sub)
                            if not bs_y:
                                continue
                            mp, mq = luma_maxlen(
                                int(cu_h[(yi - 1) >> 2, xx >> 2]),
                                int(cu_h[yi >> 2, xx >> 2]),
                                q_sub, q_sub)
                            eqp = luma_edge_qp((yi - 1) >> 2, xx >> 2,
                                               yi >> 2, xx >> 2)
                            flt_luma(rec[0], xx, yi, False,
                                                  eqp, mp, mq, bit_depth,
                                                  at_ctu_hor=False,
                                                  bs=bs_y)
        # chroma edges for this direction (8-chroma-sample grid only:
        # vvenc loopFilterCu DEBLOCK_SMALLEST_BLOCK gating).  Edge geometry
        # follows the CHROMA tree: with a local dual tree the chroma block
        # spans several luma CUs, so edges/sizes come from the CUs that
        # carry chroma (vvenc xSetMaxFilterLengthPQFromTransformSizes with
        # ch == CH_C, LoopFilter.cpp:916)
        for cu in chroma_cus:
            if y_band is not None and not (y_band[0] <= cu.y < y_band[1]):
                continue
            cx, cy = cu.x >> 1, cu.y >> 1
            cw, ch = cu.w >> 1, cu.h >> 1
            sbt = getattr(cu, "sbt_idx", 0)
            if sbt:
                # internal SBT chroma transform edge on the 8-chroma grid
                from .ctu_syntax import sbt_tu_rect
                tx_, ty_, tw_, th_ = sbt_tu_rect(cu)[:4]
                if vertical and sbt in (1, 3):
                    ex = (cu.x + (tx_ + tw_ if cu.sbt_pos == 0 else tx_)) >> 1
                    if not (ex & 7):
                        for yy in range(cy, cy + ch, 2):
                            _, bs_cb, bs_cr = maps.bs(
                                (yy << 1) >> 2, ((ex - 1) << 1) >> 2,
                                (yy << 1) >> 2, (ex << 1) >> 2, is_b,
                                pu_edge=False)
                            large = (tw_ >> 1) >= 8 and \
                                ((cu.w - tw_) >> 1) >= 8
                            for comp, bsc in ((1, bs_cb), (2, bs_cr)):
                                if bsc == 2 or (large and bsc == 1):
                                    qp_c = chroma_edge_qp(
                                        (yy << 1) >> 2, ((ex - 1) << 1) >> 2,
                                        (yy << 1) >> 2, (ex << 1) >> 2, comp)
                                    flt_chroma(
                                        rec[comp], ex, yy, True, qp_c,
                                        large, bit_depth, bs=bsc)
                elif not vertical and sbt in (2, 4):
                    ey = (cu.y + (ty_ + th_ if cu.sbt_pos == 0 else ty_)) >> 1
                    if not (ey & 7):
                        for xx in range(cx, cx + cw, 2):
                            _, bs_cb, bs_cr = maps.bs(
                                ((ey - 1) << 1) >> 2, (xx << 1) >> 2,
                                (ey << 1) >> 2, (xx << 1) >> 2, is_b,
                                pu_edge=False)
                            large = (th_ >> 1) >= 8 and \
                                ((cu.h - th_) >> 1) >= 8
                            for comp, bsc in ((1, bs_cb), (2, bs_cr)):
                                if bsc == 2 or (large and bsc == 1):
                                    qp_c = chroma_edge_qp(
                                        ((ey - 1) << 1) >> 2, (xx << 1) >> 2,
                                        (ey << 1) >> 2, (xx << 1) >> 2, comp)
                                    flt_chroma(
                                        rec[comp], xx, ey, False, qp_c,
                                        large, bit_depth,
                                        at_ctu_hor=False, bs=bsc)
            if getattr(cu, "mtb_tus", None) is not None:
                # internal max-TB chroma transform edges (32-chroma grid)
                if vertical and cu.w > 64:
                    for off in range(64, cu.w, 64):
                        ex = (cu.x + off) >> 1
                        for yy in range(cy, cy + ch, 2):
                            _, bs_cb, bs_cr = maps.bs(
                                (yy << 1) >> 2, ((ex - 1) << 1) >> 2,
                                (yy << 1) >> 2, (ex << 1) >> 2, is_b,
                                pu_edge=False)
                            for comp, bsc in ((1, bs_cb), (2, bs_cr)):
                                if bsc == 2 or bsc == 1:
                                    qp_c = chroma_edge_qp(
                                        (yy << 1) >> 2,
                                        ((ex - 1) << 1) >> 2,
                                        (yy << 1) >> 2, (ex << 1) >> 2,
                                        comp)
                                    flt_chroma(
                                        rec[comp], ex, yy, True, qp_c,
                                        True, bit_depth, bs=bsc)
                elif not vertical and cu.h > 64:
                    for off in range(64, cu.h, 64):
                        ey = (cu.y + off) >> 1
                        for xx in range(cx, cx + cw, 2):
                            _, bs_cb, bs_cr = maps.bs(
                                ((ey - 1) << 1) >> 2, (xx << 1) >> 2,
                                (ey << 1) >> 2, (xx << 1) >> 2, is_b,
                                pu_edge=False)
                            for comp, bsc in ((1, bs_cb), (2, bs_cr)):
                                if bsc == 2 or bsc == 1:
                                    qp_c = chroma_edge_qp(
                                        ((ey - 1) << 1) >> 2,
                                        (xx << 1) >> 2,
                                        (ey << 1) >> 2, (xx << 1) >> 2,
                                        comp)
                                    flt_chroma(
                                        rec[comp], xx, ey, False, qp_c,
                                        True, bit_depth,
                                        at_ctu_hor=False, bs=bsc)
            if vertical:
                if cx == 0 or (cx & 7):
                    continue
                for yy in range(cy, cy + ch, 2):
                    _, bs_cb, bs_cr = maps.bs((yy << 1) >> 2,
                                              ((cx - 1) << 1) >> 2,
                                              (yy << 1) >> 2, (cx << 1) >> 2,
                                              is_b)
                    size_q = int(cblk_w[yy >> 1, cx >> 1])
                    size_p = int(cblk_w[yy >> 1, (cx - 1) >> 1])
                    large = size_p >= 8 and size_q >= 8
                    for comp, bsc in ((1, bs_cb), (2, bs_cr)):
                        if bsc == 2 or (large and bsc == 1):
                            qp_c = chroma_edge_qp(
                                (yy << 1) >> 2, ((cx - 1) << 1) >> 2,
                                (yy << 1) >> 2, (cx << 1) >> 2, comp)
                            flt_chroma(rec[comp], cx, yy, True,
                                                    qp_c, large, bit_depth,
                                                    bs=bsc)
            else:
                if cy == 0 or (cy & 7):
                    continue
                at_ctu = ((cy << 1) % ctu_size) == 0
                for xx in range(cx, cx + cw, 2):
                    _, bs_cb, bs_cr = maps.bs(((cy - 1) << 1) >> 2,
                                              (xx << 1) >> 2,
                                              (cy << 1) >> 2, (xx << 1) >> 2,
                                              is_b)
                    size_q = int(cblk_h[cy >> 1, xx >> 1])
                    size_p = int(cblk_h[(cy - 1) >> 1, xx >> 1])
                    large = size_p >= 8 and size_q >= 8
                    for comp, bsc in ((1, bs_cb), (2, bs_cr)):
                        if bsc == 2 or (large and bsc == 1):
                            qp_c = chroma_edge_qp(
                                ((cy - 1) << 1) >> 2, (xx << 1) >> 2,
                                (cy << 1) >> 2, (xx << 1) >> 2, comp)
                            flt_chroma(rec[comp], xx, cy, False,
                                                    qp_c, large, bit_depth,
                                                    at_ctu_hor=at_ctu,
                                                    bs=bsc)
        if collector is not None:
            collector.flush(vertical)

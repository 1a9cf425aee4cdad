"""Dependent quantization: 4-state trellis (Viterbi) quantizer.

A copy of vvenc_tpu/ops/depquant.py, unchanged: host code, no device program.

Chooses quantization indices on the half-step grid of the dependent
scalar quantizers (states 0/1 reconstruct level*step, states 2/3
(2*level-1)*step/2), minimizing D + lambda*R over the real residual
syntax with per-path context modelling.

Behavioral reference: vvenc CommonLib/DepQuant.cpp — preQuantCoeff (:631,
candidate generation on the qIdx grid), checkRdCosts/xDecide (:698,:1266,
the 8-transition decision with A/B/Z candidates per state), update1State
(:905, per-path context/budget bookkeeping), updateStatesEOS + CommonCtx
(:473,:1002, subblock boundary handling incl. the sbb-skip lane),
RateEstimator::xSetLastCoeffOffset (:353, last-position + cbf rate
coupling) and the trellis backtrack (:1243-1264).

Differences from the reference implementation (identical decode
semantics, near-identical RD decisions): costs are float64 instead of
int64 fixed point, and per-path contexts are computed from full decided-
level maps per state instead of the packed tplAcc/sum1st/absVal
accumulators (no 255-saturation of template sums).
"""

from __future__ import annotations

import numpy as np

from ..bitstream.residual import (_Cctx, _last_ctx_id, GROUP_IDX,
                                  GO_RICE_PARS, MIN_IN_GROUP,
                                  CTX_BIN_SAMPLE_RATIO, STATE_TRANS)
from .transforms import (QUANT_SCALES, transform_shift, needs_sqrt2,
                         COEFF_MIN, COEFF_MAX)

_EP = 1 << 15
_SCALE_BITS = 15
_STATE_INF = 1.0e30   # unreachable state
_DEC_INF = 1.0e29     # undecided decision slot
_RICEMAX = 32

# scan position types (vvenc DepQuant.h:80)
_ISCSBB, _SOCSBB, _EOCSBB = 0, 1, 2

# golomb-rice EP-bin rates (vvenc g_goRiceBits, DepQuant.cpp:577)
_GOLOMB_BITS = np.zeros((4, _RICEMAX), dtype=np.int64)
for _p in range(4):
    for _v in range(_RICEMAX):
        _t = 5 << _p
        if _v < _t:
            _GOLOMB_BITS[_p, _v] = ((_v >> _p) + 1 + _p) << _SCALE_BITS
        else:
            _len = _p
            _s = _v - _t
            while _s >= (1 << _len):
                _s -= 1 << _len
                _len += 1
            _GOLOMB_BITS[_p, _v] = (5 + _len + 1 - _p + _len) << _SCALE_BITS

_TPL = ((1, 0), (2, 0), (1, 1), (0, 1), (0, 2))


class _State:
    """One trellis path head (vvenc DQIntern::StateMem column)."""
    __slots__ = ("rd", "levels", "sbb_flags", "rem_reg_bins", "num_sig",
                 "sbb_bits0", "sbb_bits1", "sig_bits", "cff_row",
                 "rice_par", "rice_zero")

    def __init__(self, h, w, n_sbb):
        self.rd = _STATE_INF
        self.levels = np.zeros((h, w), dtype=np.int32)
        self.sbb_flags = np.zeros(n_sbb, dtype=np.uint8)
        self.rem_reg_bins = 4
        self.num_sig = 0
        self.sbb_bits0 = 0
        self.sbb_bits1 = 0
        self.sig_bits = (0, 0)    # frac bits of sig flag at next position
        self.cff_row = None       # gtx frac-bit row [6] at next position
        self.rice_par = 0
        self.rice_zero = 0


def _tpl_sums(levels, x, y, w, h):
    """(raw_sum, sum_abs1, num) over the 5-position template."""
    s = s1 = num = 0
    for dx, dy in _TPL:
        nx, ny = x + dx, y + dy
        if nx < w and ny < h:
            t = int(levels[ny, nx])
            if t:
                s += t
                s1 += min(4 + (t & 1), t)
                num += 1
    return s, s1, num


def _level_bits(level, cff_row, rice_tab):
    if level < 4:
        return cff_row[level]
    val = (level - 4) >> 1
    return cff_row[level - (val << 1)] + \
        int(rice_tab[min(val, _RICEMAX - 1)])


def depquant_np(coeff: np.ndarray, qp: int, bit_depth: int, is_luma: bool,
                lmbda: float, ctx, cbf_ctx_id=None,
                thr_val: int = 8) -> np.ndarray:
    """Trellis-quantize one TU for dependent quantization.

    coeff: forward-transform output [h, w].  ctx: CtxModels (frac_bits
    lookups).  cbf_ctx_id: ctx of the cbf bin saved by zeroing the block.
    Returns signed levels [h, w] int32 (decode with state-machine dequant).
    """
    h, w = coeff.shape
    cctx = _Cctx(w, h, is_luma)
    n = cctx.n_coded
    sqrt2 = needs_sqrt2(w, h)
    tshift = transform_shift(w, h, bit_depth) + (-1 if sqrt2 else 0)
    qp_dq = qp + 1
    q_shift = 14 - 1 + qp_dq // 6 + tshift
    q_add = -((3 << q_shift) >> 1)
    q_scale = int(QUANT_SCALES[1 if sqrt2 else 0][qp_dq % 6])
    max_qidx = (1 << 15) - 4
    tshift_eff = (transform_shift(w, h, bit_depth)
                  - (0.5 if sqrt2 else 0.0))
    # D/lambda in SCALE_BITS fixed point, distortion deltas vs level 0:
    # err(qc) = u - qc*2^q_shift (u-domain);  err^2 - err(0)^2 =
    # 2^q_shift*(qc^2*2^q_shift - 2*qc*u);  coeff-domain /q_scale^2,
    # pixel-domain *2^(-2*tshift_eff), rate units *2^SCALE_BITS/lambda
    dist_fact = (2.0 ** (-2.0 * tshift_eff + _SCALE_BITS + q_shift)
                 / (float(q_scale) * q_scale * lmbda))
    # deltaDist(qc) = dist_fact * (qc^2 * 2^q_shift - 2*qc*u)

    flat = coeff.astype(np.int64).reshape(-1)
    abs_scan = np.abs(flat[cctx.blkpos])

    # ----- first test position (DQ threshold, DepQuant.cpp:58,1195) -----
    thres_last = thr_val << (q_shift - 1) if q_shift > 0 else \
        (thr_val >> 1) << q_shift
    default_th = thres_last // (q_scale << 2)
    first_pos = n - 1
    while first_pos >= 0 and abs_scan[first_pos] <= default_th:
        first_pos -= 1
    if first_pos < 0:
        return np.zeros((h, w), dtype=np.int32)

    fb = ctx.frac_bits
    ch = cctx.ch

    # ----- rate tables -----
    n_sig_ctx = 12 if ch == 0 else 8
    sig_tab = [[(fb(cctx.sig_sets[s](c), 0), fb(cctx.sig_sets[s](c), 1))
                for c in range(n_sig_ctx)] for s in range(3)]
    n_gtx_ctx = 21 if ch == 0 else 11
    gtx_tab = []
    for c in range(n_gtx_ctx):
        p0 = _EP + fb(cctx.par_set(c), 0)
        p1 = _EP + fb(cctx.par_set(c), 1)
        g1_0, g1_1 = fb(cctx.gt1_set(c), 0), fb(cctx.gt1_set(c), 1)
        g2_0, g2_1 = fb(cctx.gt2_set(c), 0), fb(cctx.gt2_set(c), 1)
        gtx_tab.append([0, g1_0 + _EP, g1_1 + p0 + g2_0, g1_1 + p1 + g2_0,
                        g1_1 + p0 + g2_1, g1_1 + p1 + g2_1])
    sbb_tab = [(fb(cctx.sig_group_set(c), 0), fb(cctx.sig_group_set(c), 1))
               for c in range(2)]
    cbf_delta = 0
    if cbf_ctx_id is not None:
        cbf_delta = fb(cbf_ctx_id, 1) - fb(cbf_ctx_id, 0)
    # last-position rate per coordinate (xSetLastCoeffOffset)
    last_bits = [None, None]
    for axis in range(2):
        size = min(32, h if axis else w)
        max_gi = GROUP_IDX[size - 1]
        bit_off = cbf_delta if axis else 0
        ctx_bits = [0] * (max_gi + 1)
        sum_fb = 0
        for gi in range(max_gi):
            cid = _last_ctx_id(cctx, gi, axis == 0)
            ctx_bits[gi] = sum_fb + fb(cid, 0) + \
                ((((gi - 2) >> 1) << _SCALE_BITS) if gi > 3 else 0) + bit_off
            sum_fb += fb(cid, 1)
        ctx_bits[max_gi] = sum_fb + \
            ((((max_gi - 2) >> 1) << _SCALE_BITS) if max_gi > 3 else 0) + \
            bit_off
        last_bits[axis] = [ctx_bits[GROUP_IDX[p]] for p in range(size)]

    # ----- scan geometry -----
    log2_cg = cctx.log2_cg
    cg_size = 1 << log2_cg
    cg_mask = cg_size - 1
    n_sbb = n >> log2_cg
    w_in_g = cctx.w_in_groups
    init_rrb = (n * CTX_BIN_SAMPLE_RATIO) >> 4

    def ctx_offsets_next(sp_next):
        dg = int(cctx.scan_x[sp_next]) + int(cctx.scan_y[sp_next])
        if ch == 0:
            sig_off = 8 if dg < 2 else (4 if dg < 5 else 0)
            gtx_off = 16 if dg < 1 else (11 if dg < 3 else
                                         (6 if dg < 10 else 1))
        else:
            sig_off = 4 if dg < 2 else 0
            gtx_off = 6 if dg < 1 else 1
        return sig_off, gtx_off

    states = [_State(h, w, n_sbb) for _ in range(4)]
    for _k, _st in enumerate(states):
        _st.cff_row = gtx_tab[0]
        _st.sig_bits = sig_tab[max(0, _k - 1)][0]
    skip = [None] * 4   # (rd, levels, sbb_flags, rem_reg_bins, sbb_bits0)

    lane0 = [None] * (first_pos + 1)   # (rd[4], lvl[4], prev[4])
    lane1 = {}                         # EOS copies, keyed by scanIdx

    for sp in range(first_pos, -1, -1):
        x = int(cctx.scan_x[sp])
        y = int(cctx.scan_y[sp])
        inside = sp & cg_mask
        spt = _ISCSBB
        if inside == cg_mask and sp > cg_size and sp < n - 1:
            spt = _SOCSBB
        elif inside == 0 and 0 < sp < n - cg_size:
            spt = _EOCSBB

        dec_rd = [_DEC_INF] * 4
        dec_lvl = [0] * 4
        dec_prev = [-2] * 4

        # lazily-set rice params per state (setRiceParam)
        def set_rice(st, ge4):
            if st.rem_reg_bins < 4 or ge4:
                raw = _tpl_sums(st.levels, x, y, w, h)[0]
                sub = 0 if st.rem_reg_bins < 4 else 20
                st.rice_par = GO_RICE_PARS[max(min(31, raw - sub), 0)]

        def check(st_id, pq_a, pq_b, idx_az, idx_b):
            st = states[st_id]
            rice_tab = _GOLOMB_BITS[st.rice_par]
            rd_a = st.rd + pq_a[1]
            rd_b = st.rd + pq_b[1]
            rd_z = st.rd
            if st.rem_reg_bins >= 4:
                cb = st.cff_row
                sb0, sb1 = st.sig_bits
                rd_a += _level_bits(pq_a[0], cb, rice_tab)
                rd_b += _level_bits(pq_b[0], cb, rice_tab)
                if spt == _ISCSBB:
                    rd_a += sb1
                    rd_b += sb1
                    rd_z += sb0
                elif spt == _SOCSBB:
                    rd_a += st.sbb_bits1 + sb1
                    rd_b += st.sbb_bits1 + sb1
                    rd_z += st.sbb_bits1 + sb0
                elif st.num_sig:
                    rd_a += sb1
                    rd_b += sb1
                    rd_z += sb0
                else:
                    rd_z = _STATE_INF
            else:
                zp = st.rice_zero
                rd_a += _EP + int(rice_tab[pq_a[0] - 1 if pq_a[0] <= zp
                                           else min(pq_a[0], _RICEMAX - 1)])
                rd_b += _EP + int(rice_tab[pq_b[0] - 1 if pq_b[0] <= zp
                                           else min(pq_b[0], _RICEMAX - 1)])
                rd_z += int(rice_tab[zp])
            if rd_a < rd_z and rd_a < dec_rd[idx_az]:
                dec_rd[idx_az] = rd_a
                dec_lvl[idx_az] = pq_a[0]
                dec_prev[idx_az] = st_id
            elif rd_z < dec_rd[idx_az]:
                dec_rd[idx_az] = rd_z
                dec_lvl[idx_az] = 0
                dec_prev[idx_az] = st_id
            if rd_b < dec_rd[idx_b]:
                dec_rd[idx_b] = rd_b
                dec_lvl[idx_b] = pq_b[0]
                dec_prev[idx_b] = st_id

        def check_odd1(st_id, dd1, idx_a, idx_z):
            # level-1-only candidate (qIdx < 0), vvenc checkRdCostsOdd1
            st = states[st_id]
            rd_a = st.rd + dd1
            rd_z = st.rd
            if st.rem_reg_bins >= 4:
                sb0, sb1 = st.sig_bits
                rd_a += st.cff_row[1]
                if spt == _ISCSBB:
                    rd_a += sb1
                    rd_z += sb0
                elif spt == _SOCSBB:
                    rd_a += st.sbb_bits1 + sb1
                    rd_z += st.sbb_bits1 + sb0
                elif st.num_sig:
                    rd_a += sb1
                    rd_z += sb0
                else:
                    rd_z = _STATE_INF
            else:
                rice_tab = _GOLOMB_BITS[st.rice_par]
                rd_a += _EP + int(rice_tab[0])
                rd_z += int(rice_tab[st.rice_zero])
            if rd_a < dec_rd[idx_a]:
                dec_rd[idx_a] = rd_a
                dec_lvl[idx_a] = 1
                dec_prev[idx_a] = st_id
            if rd_z < dec_rd[idx_z]:
                dec_rd[idx_z] = rd_z
                dec_lvl[idx_z] = 0
                dec_prev[idx_z] = st_id

        def check_start(pq, idx):
            # path begins here: this position is the last coefficient
            rd = pq[1] + last_off + _level_bits(pq[0], gtx_tab[0],
                                                _GOLOMB_BITS[0])
            if rd < dec_rd[idx]:
                dec_rd[idx] = rd
                dec_lvl[idx] = pq[0]
                dec_prev[idx] = -1

        last_off = int(last_bits[0][x]) + int(last_bits[1][y])

        u = int(abs_scan[sp]) * q_scale
        qidx = (u + q_add) >> q_shift

        def dd(qc):
            return dist_fact * (float(qc) * qc * (1 << q_shift)
                                - 2.0 * qc * u)

        if qidx < 0:
            dd_a = dd(1)        # odd qIdx candidate (states 2/3)
            dd_b = dd(2)        # even qIdx candidate (states 0/1)
            set_rice(states[0], False)
            check_odd1(0, dd_b, 2, 0)   # level 1 (odd) -> state 2
            set_rice(states[1], False)
            check_odd1(1, dd_b, 0, 2)
            set_rice(states[2], False)
            check_odd1(2, dd_a, 3, 1)
            set_rice(states[3], False)
            check_odd1(3, dd_a, 1, 3)
            check_start((1, dd_b), 2)
        else:
            qidx = max(1, min(max_qidx, qidx))
            pq = [None] * 4
            for k in range(4):
                qc = qidx + k
                pq[qc & 3] = ((qc + 1) >> 1, dd(qc))
            ge4_02 = pq[0][0] >= 4
            ge4_13 = pq[3][0] >= 4
            set_rice(states[0], ge4_02)
            set_rice(states[1], ge4_02)
            set_rice(states[2], ge4_13)
            set_rice(states[3], ge4_13)
            check(0, pq[0], pq[2], 0, 2)
            check(1, pq[0], pq[2], 2, 0)
            check(2, pq[3], pq[1], 1, 3)
            check(3, pq[3], pq[1], 3, 1)
            check_start(pq[0], 0)
            check_start(pq[2], 2)

        if spt == _EOCSBB:
            for s in range(4):
                if skip[s] is not None:
                    rd = skip[s][0] + skip[s][4]
                    if rd < dec_rd[s]:
                        dec_rd[s] = rd
                        dec_lvl[s] = 0
                        dec_prev[s] = 4 | s

        lane0[sp] = (list(dec_rd), list(dec_lvl), list(dec_prev))

        if sp == 0:
            break

        if spt == _SOCSBB:
            skip = [(st.rd, st.levels, st.sbb_flags, st.rem_reg_bins,
                     st.sbb_bits0) for st in states]

        # ----- state update -----
        prev = states
        sp_next = sp - 1
        sig_off, gtx_off = ctx_offsets_next(sp_next)
        nx = int(cctx.scan_x[sp_next])
        ny = int(cctx.scan_y[sp_next])
        is_eos = inside == 0
        new_states = []
        for t in range(4):
            st = _State.__new__(_State)
            st.rd = dec_rd[t]
            st.rice_par = 0
            st.rice_zero = 0
            st.sig_bits = (0, 0)
            st.cff_row = gtx_tab[0]
            pid = dec_prev[t]
            lvl = dec_lvl[t]
            if pid == -2:
                st.levels = prev[t].levels
                st.sbb_flags = prev[t].sbb_flags
                st.rem_reg_bins = prev[t].rem_reg_bins
                st.num_sig = prev[t].num_sig
                st.sbb_bits0 = prev[t].sbb_bits0
                st.sbb_bits1 = prev[t].sbb_bits1
                new_states.append(st)
                continue
            if pid >= 4:        # sbb skipped (EOS only)
                sk = skip[pid - 4]
                st.levels = sk[1].copy()
                st.sbb_flags = sk[2].copy()
                st.rem_reg_bins = sk[3]
                st.num_sig = 0
            elif pid >= 0:
                p = prev[pid]
                st.levels = p.levels.copy()
                st.sbb_flags = p.sbb_flags.copy()
                st.num_sig = p.num_sig + (1 if lvl else 0)
                st.rem_reg_bins = p.rem_reg_bins - 1
                if st.rem_reg_bins >= 4:
                    st.rem_reg_bins -= lvl if lvl < 2 else 3
            else:               # start (this position is the last coeff)
                st.levels = np.zeros((h, w), dtype=np.int32)
                st.sbb_flags = np.zeros(n_sbb, dtype=np.uint8)
                st.num_sig = 1
                st.rem_reg_bins = init_rrb - (lvl if lvl < 2 else 3)
            st.sbb_bits0 = prev[pid].sbb_bits0 if 0 <= pid < 4 else 0
            st.sbb_bits1 = prev[pid].sbb_bits1 if 0 <= pid < 4 else 0
            if lvl:
                st.levels[y, x] = lvl
            if is_eos:
                cur_sbb = int(cctx.cg_pos[sp >> log2_cg])
                st.sbb_flags[cur_sbb] = 1 if st.num_sig else 0
                st.num_sig = 0
                # sbb-flag bits for the next subblock
                nxt_sbb = int(cctx.cg_pos[sp_next >> log2_cg])
                sy, sx = divmod(nxt_sbb, w_in_g)
                right = st.sbb_flags[nxt_sbb + 1] \
                    if sx + 1 < w_in_g else 0
                below = st.sbb_flags[nxt_sbb + w_in_g] \
                    if sy + 1 < cctx.h_in_groups else 0
                sb = sbb_tab[1 if (right or below) else 0]
                st.sbb_bits0 = sb[0]
                st.sbb_bits1 = sb[1]
            if st.rem_reg_bins >= 4:
                _, s1, num = _tpl_sums(st.levels, nx, ny, w, h)
                st.sig_bits = sig_tab[max(0, t - 1)][
                    sig_off + min((s1 + 1) >> 1, 3)]
                st.cff_row = gtx_tab[gtx_off + min(s1 - num, 4)]
            else:
                raw = _tpl_sums(st.levels, nx, ny, w, h)[0]
                st.rice_par = GO_RICE_PARS[max(min(31, raw), 0)]
                st.rice_zero = (1 if t < 2 else 2) << st.rice_par
            new_states.append(st)
        states = new_states
        if is_eos:
            lane1[sp] = lane0[sp]

    # ----- best path + backtrack -----
    best_id = -1
    best_cost = 0.0
    for s in range(4):
        if lane0[0][0][s] < best_cost:
            best_cost = lane0[0][0][s]
            best_id = s
    out = np.zeros(w * h, dtype=np.int64)
    if best_id < 0:
        return out.reshape(h, w).astype(np.int32)
    sp = 0
    pid = best_id
    while pid >= 0:
        if pid >= 4:
            entry = lane1.get(sp)
            if entry is None:
                lvl, nxt = 0, pid       # stay in the skip lane
            else:
                lvl, nxt = entry[1][pid & 3], entry[2][pid & 3]
        else:
            lvl, nxt = lane0[sp][1][pid], lane0[sp][2][pid]
        if lvl:
            blk = int(cctx.blkpos[sp])
            out[blk] = -lvl if flat[blk] < 0 else lvl
        pid = nxt
        sp += 1
    return np.clip(out, COEFF_MIN, COEFF_MAX).reshape(h, w).astype(np.int32)

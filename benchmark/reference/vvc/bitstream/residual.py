"""Transform-coefficient residual coding (H.266 7.3.11.11 residual_coding).

Implements the regular (non-transform-skip) residual syntax: last significant
coefficient position, coded-subblock flags, the context-coded first pass
(sig / gt1 / parity / gt2 with the shared remRegBins budget), go-rice
remainders, bypass-coded tail, and sign bits.

Behavioral reference: vvenc EncoderLib/CABACWriter.cpp:2240-2653 and
CommonLib/ContextModelling.{h,cpp} (CoeffCodingContext).  Dependent
quantization and sign-data hiding are not yet wired (state machine table and
hideSign hooks are in place).

Scope (round 1): block sizes up to 32x32 (no 64-point zero-out), min size 1x1
coefficient groups not supported below 4 samples a side except the normative
small-block CG shapes.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from . import ctx_tables as ct

COEF_REMAIN_BIN_REDUCTION = 5
SBH_THRESHOLD = 4
MAX_LOG2_TR_DYNAMIC_RANGE = 15
CTX_BIN_SAMPLE_RATIO = 28  # MAX_TU_LEVEL_CTX_CODED_BIN_CONSTRAINT

MIN_IN_GROUP = [0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96]
GROUP_IDX = [0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7] + [8] * 8 + \
    [9] * 8 + [10] * 16 + [11] * 16
GO_RICE_PARS = [0] * 7 + [1] * 7 + [2] * 14 + [3] * 4
LAST_PREFIX_CTX = [0, 0, 0, 3, 6, 10, 15]

# coefficient-group log2 dims per (log2W, log2H) (vvenc g_log2SbbSize)
_LOG2_SBB = {}
for _lw in range(7):
    for _lh in range(7):
        if _lw == 0:
            _LOG2_SBB[(_lw, _lh)] = (0, min(_lh, 4))
        elif _lh == 0:
            _LOG2_SBB[(_lw, _lh)] = (min(_lw, 4), 0)
        elif _lw == 1 or _lh == 1:
            # H.266 7.4.12.11: 2-wide/2-tall blocks use 2x8 / 8x2 subblocks
            # once the block has more than 8 coefficients, else 2x2
            if _lw == 1:
                _LOG2_SBB[(_lw, _lh)] = (1, 1) if _lh in (1, 2) else (1, 3)
            else:
                _LOG2_SBB[(_lw, _lh)] = (1, 1) if _lw in (1, 2) else (3, 1)
        else:
            _LOG2_SBB[(_lw, _lh)] = (2, 2)


def _diag_scan(w: int, h: int):
    """Up-right diagonal scan positions (x, y), DC first."""
    out = []
    x = y = 0
    for _ in range(w * h):
        out.append((x, y))
        if x == w - 1 or y == 0:
            ny = y + x + 1
            x = 0
            if ny >= h:
                x = ny - (h - 1)
                ny = h - 1
            y = ny
        else:
            x += 1
            y -= 1
    return out


@lru_cache(maxsize=None)
def scan_info(log2w: int, log2h: int):
    """Grouped 4x4 diagonal scan over the coefficient-coding region.

    For 64-point dimensions, only the top-left min(32,w) x min(32,h)
    zero-out region is scanned (vvenc Rom.cpp:1239: widthInGroups clamped
    to JVET_C0024_ZERO_OUT_TH); positions use the full-block raster
    stride.  Returns (scan_x, scan_y, scan_blkpos, cg_scan_pos, log2_cg_w,
    log2_cg_h) as numpy arrays / ints; len(scan_x) == min(32,w)*min(32,h).
    """
    w, h = 1 << log2w, 1 << log2h
    zw, zh = min(32, w), min(32, h)
    lcw, lch = _LOG2_SBB[(log2w, log2h)]
    cgw, cgh = 1 << lcw, 1 << lch
    cg_scan = _diag_scan(zw >> lcw, zh >> lch)
    in_cg = _diag_scan(cgw, cgh)
    xs, ys = [], []
    for cgx, cgy in cg_scan:
        for px, py in in_cg:
            xs.append((cgx << lcw) + px)
            ys.append((cgy << lch) + py)
    scan_x = np.array(xs, dtype=np.int32)
    scan_y = np.array(ys, dtype=np.int32)
    blkpos = scan_y * w + scan_x
    cg_pos = np.array([cy * (zw >> lcw) + cx for cx, cy in cg_scan],
                      dtype=np.int32)
    return scan_x, scan_y, blkpos, cg_pos, lcw, lch


def _min4_parity(a):
    return min(4 + (a & 1), a)


class _Cctx:
    """Per-TU coefficient-coding state (CoeffCodingContext analog)."""

    def __init__(self, w: int, h: int, is_luma: bool):
        self.w, self.h = w, h
        self.log2w = w.bit_length() - 1
        self.log2h = h.bit_length() - 1
        self.ch = 0 if is_luma else 1
        (self.scan_x, self.scan_y, self.blkpos, self.cg_pos,
         self.lcw, self.lch) = scan_info(self.log2w, self.log2h)
        self.log2_cg = self.lcw + self.lch
        self.n_coded = len(self.scan_x)  # min(32,w)*min(32,h) (zero-out)
        self.w_in_groups = max(1, min(32, w) >> self.lcw)
        self.h_in_groups = max(1, min(32, h) >> self.lch)
        self.tmpl_diag = -1
        self.tmpl_sum1 = -1
        # context sets
        self.sig_sets = [ct.SIG_FLAG[self.ch], ct.SIG_FLAG[self.ch + 2],
                         ct.SIG_FLAG[self.ch + 4]]
        self.par_set = ct.PAR_FLAG[self.ch]
        self.gt2_set = ct.GTX_FLAG[self.ch]       # greater2
        self.gt1_set = ct.GTX_FLAG[self.ch + 2]   # greater1
        self.last_x_set = ct.LAST_X[self.ch]
        self.last_y_set = ct.LAST_Y[self.ch]
        self.sig_group_set = ct.SIG_COEFF_GROUP[self.ch]
        if self.ch == 0:
            self.last_off_x = LAST_PREFIX_CTX[self.log2w]
            self.last_off_y = LAST_PREFIX_CTX[self.log2h]
            self.last_shift_x = (self.log2w + 1) >> 2
            self.last_shift_y = (self.log2h + 1) >> 2
        else:
            self.last_off_x = self.last_off_y = 0
            self.last_shift_x = min(max(0, w >> 3), 2)
            self.last_shift_y = min(max(0, h >> 3), 2)
        self.max_last_x = GROUP_IDX[min(32, w) - 1]
        self.max_last_y = GROUP_IDX[min(32, h) - 1]

    def sig_ctx_id(self, scan_pos: int, coeff_cap, state: int) -> int:
        """sig_coeff_flag context (vvenc sigCtxIdAbs:115).  coeff_cap is a
        [h, w] array holding min(4+(a&1), a) per already-processed position
        (first-pass capped values) and 0 elsewhere."""
        x = int(self.scan_x[scan_pos])
        y = int(self.scan_y[scan_pos])
        diag = x + y
        s = 0
        npos = 0
        w, h = self.w, self.h
        for dx, dy in ((1, 0), (2, 0), (1, 1), (0, 1), (0, 2)):
            nx, ny = x + dx, y + dy
            if nx < w and ny < h:
                v = int(coeff_cap[ny, nx])
                s += v
                npos += 1 if v else 0
        ctx_ofs = min((s + 1) >> 1, 3) + (4 if diag < 2 else 0)
        if self.ch == 0:
            ctx_ofs += 4 if diag < 5 else 0
        self.tmpl_diag = diag
        self.tmpl_sum1 = s - npos
        return self.sig_sets[max(0, state - 1)](ctx_ofs)

    def ctx_offset_abs(self) -> int:
        if self.tmpl_diag == -1:
            return 0
        off = min(self.tmpl_sum1, 4) + 1
        d = self.tmpl_diag
        if self.ch == 0:
            off += 15 if d == 0 else (10 if d < 3 else (5 if d < 10 else 0))
        else:
            off += 5 if d == 0 else 0
        return off

    def template_abs_sum(self, scan_pos: int, abs_coeff, base_level: int) -> int:
        x = int(self.scan_x[scan_pos])
        y = int(self.scan_y[scan_pos])
        s = 0
        w, h = self.w, self.h
        for dx, dy in ((1, 0), (2, 0), (1, 1), (0, 1), (0, 2)):
            nx, ny = x + dx, y + dy
            if nx < w and ny < h:
                s += int(abs_coeff[ny, nx])
        return max(min(s - 5 * base_level, 31), 0)

    def sig_group_ctx(self, cg_idx_in_scan: int, sig_groups) -> int:
        cg_pos = int(self.cg_pos[cg_idx_in_scan])
        cgy, cgx = divmod(cg_pos, self.w_in_groups)
        right = sig_groups.get(cg_pos + 1, 0) if cgx + 1 < self.w_in_groups else 0
        lower = sig_groups.get(cg_pos + self.w_in_groups, 0) \
            if cgy + 1 < self.h_in_groups else 0
        return self.sig_group_set(right | lower)


def _last_ctx_id(cctx, ctx_last, is_x):
    off = cctx.last_off_x if is_x else cctx.last_off_y
    shift = cctx.last_shift_x if is_x else cctx.last_shift_y
    cset = cctx.last_x_set if is_x else cctx.last_y_set
    return cset(off + (ctx_last >> shift))


def encode_residual(enc, coeff: np.ndarray, is_luma: bool,
                    dep_quant: bool = False, sign_hiding: bool = False) -> None:
    """Encode one TU's coefficients (must contain at least one nonzero).

    enc: CabacEncoder (or BitEstimator-compatible).  coeff: int array [h, w].

    sign_hiding: drop the lowest-scan-position sign of each qualifying CG
    (span >= SBH_THRESHOLD); the caller must have parity-adjusted the
    levels (transforms.sdh_adjust) so the decoder's inference matches.
    """
    assert not (dep_quant and sign_hiding)
    tname = type(enc).__name__
    if tname == "BitEstimator":
        from .. import native
        if native.available():
            enc.frac_bits += native.est_residual(coeff, is_luma, dep_quant,
                                                 enc.ctx, sign_hiding)
            return
    elif tname == "CabacEncoder":
        from .. import native
        if native.available():
            native.write_residual(coeff, is_luma, dep_quant, sign_hiding,
                                  enc)
            return
    h, w = coeff.shape
    cctx = _Cctx(w, h, is_luma)
    flat = coeff.reshape(-1)
    n = cctx.n_coded
    # last significant scan position
    nz_scan = np.nonzero(flat[cctx.blkpos] != 0)[0]
    assert len(nz_scan) > 0, "residual coding called for empty TU"
    scan_pos_last = int(nz_scan[-1])
    # sig group flags
    num_cgs = (scan_pos_last >> cctx.log2_cg) + 1
    sig_groups = {}
    cg_has = {}
    for cg in range(num_cgs):
        s0 = cg << cctx.log2_cg
        s1 = min(s0 + (1 << cctx.log2_cg), n)
        has = bool(np.any(flat[cctx.blkpos[s0:s1]] != 0))
        cg_has[cg] = has
    # last position coding
    blk_last = int(cctx.blkpos[scan_pos_last])
    pos_y, pos_x = divmod(blk_last, w)
    gx, gy = GROUP_IDX[pos_x], GROUP_IDX[pos_y]
    for i in range(gx):
        enc.encode_bin(1, _last_ctx_id(cctx, i, True))
    if gx < cctx.max_last_x:
        enc.encode_bin(0, _last_ctx_id(cctx, gx, True))
    for i in range(gy):
        enc.encode_bin(1, _last_ctx_id(cctx, i, False))
    if gy < cctx.max_last_y:
        enc.encode_bin(0, _last_ctx_id(cctx, gy, False))
    if gx > 3:
        v = pos_x - MIN_IN_GROUP[gx]
        for i in range(((gx - 2) >> 1) - 1, -1, -1):
            enc.encode_bin_ep((v >> i) & 1)
    if gy > 3:
        v = pos_y - MIN_IN_GROUP[gy]
        for i in range(((gy - 2) >> 1) - 1, -1, -1):
            enc.encode_bin_ep((v >> i) & 1)

    # subblock coding
    state = 0
    rem_reg_bins = (n * CTX_BIN_SAMPLE_RATIO) >> 4
    coeff_cap = np.zeros((h, w), dtype=np.int32)
    abs_coeff = np.abs(coeff)
    last_cg = scan_pos_last >> cctx.log2_cg
    for cg in range(last_cg, -1, -1):
        is_last_cg = cg == last_cg
        is_not_first = cg != 0
        min_sub = cg << cctx.log2_cg
        max_sub = min_sub + (1 << cctx.log2_cg) - 1
        if not is_last_cg and is_not_first:
            ctx = cctx.sig_group_ctx(cg, sig_groups)
            if cg_has[cg]:
                enc.encode_bin(1, ctx)
            else:
                enc.encode_bin(0, ctx)
                continue
        if cg_has[cg]:
            sig_groups[int(cctx.cg_pos[cg])] = 1
        first_sig = scan_pos_last if is_last_cg else max_sub
        infer_sig_pos = first_sig if first_sig == scan_pos_last else \
            (min_sub if is_not_first else -1)
        num_nonzero = 0
        sign_pattern = []
        sign_pos = []
        next_pos = first_sig
        while next_pos >= min_sub and rem_reg_bins >= 4:
            blk = int(cctx.blkpos[next_pos])
            c = int(flat[blk])
            a = abs(c)
            sig = 1 if c else 0
            if num_nonzero or next_pos != infer_sig_pos:
                sig_ctx = cctx.sig_ctx_id(next_pos, coeff_cap, state)
                enc.encode_bin(sig, sig_ctx)
                rem_reg_bins -= 1
            elif next_pos != scan_pos_last:
                cctx.sig_ctx_id(next_pos, coeff_cap, state)
            if sig:
                ctx_off = cctx.ctx_offset_abs()
                num_nonzero += 1
                rem = a - 1
                sign_pattern.append(1 if c < 0 else 0)
                sign_pos.append(next_pos)
                gt1 = 1 if rem else 0
                enc.encode_bin(gt1, cctx.gt1_set(ctx_off))
                rem_reg_bins -= 1
                if gt1:
                    rem -= 1
                    enc.encode_bin(rem & 1, cctx.par_set(ctx_off))
                    rem >>= 1
                    rem_reg_bins -= 1
                    gt2 = 1 if rem else 0
                    enc.encode_bin(gt2, cctx.gt2_set(ctx_off))
                    rem_reg_bins -= 1
                y, x = divmod(blk, w)
                coeff_cap[y, x] = _min4_parity(a)
            if dep_quant:
                state = _next_state(state, a)
            next_pos -= 1
        first_pos_mode2 = next_pos
        # second pass: go-rice remainders for levels >= 4
        for sp in range(first_sig, first_pos_mode2, -1):
            blk = int(cctx.blkpos[sp])
            a = int(abs_coeff.reshape(-1)[blk])
            if a >= 4:
                sum_all = cctx.template_abs_sum(sp, abs_coeff, 4)
                rice = GO_RICE_PARS[sum_all]
                enc.encode_remabs_ep((a - 4) >> 1, rice,
                                     COEF_REMAIN_BIN_REDUCTION,
                                     MAX_LOG2_TR_DYNAMIC_RANGE)
        # bypass pass: positions never context-coded
        for sp in range(first_pos_mode2, min_sub - 1, -1):
            blk = int(cctx.blkpos[sp])
            c = int(flat[blk])
            a = abs(c)
            sum_all = cctx.template_abs_sum(sp, abs_coeff, 0)
            rice = GO_RICE_PARS[sum_all]
            pos0 = (1 if state < 2 else 2) << rice
            rem = pos0 if a == 0 else (a - 1 if a <= pos0 else a)
            enc.encode_remabs_ep(rem, rice, COEF_REMAIN_BIN_REDUCTION,
                                 MAX_LOG2_TR_DYNAMIC_RANGE)
            if dep_quant:
                state = _next_state(state, a)
            if a:
                num_nonzero += 1
                sign_pattern.append(1 if c < 0 else 0)
                sign_pos.append(sp)
        # signs (SDH: the lowest-position sign is inferred from the CG
        # abs-sum parity when the nonzero span reaches SBH_THRESHOLD)
        n_signs = len(sign_pattern)
        if sign_hiding and n_signs and \
                sign_pos[0] - sign_pos[-1] >= SBH_THRESHOLD:
            n_signs -= 1
        bits = 0
        for s in sign_pattern[:n_signs]:
            bits = (bits << 1) | s
        enc.encode_bins_ep(bits, n_signs)


# dependent-quantization state transition table [state][parity] packed the
# same way as vvenc DepQuant.cpp:627: [[0,2],[2,0],[1,3],[3,1]]
STATE_TRANS = 32040


def _next_state(state: int, level: int) -> int:
    return (STATE_TRANS >> ((state << 2) + ((level & 1) << 1))) & 3


def decode_residual(dec, w: int, h: int, is_luma: bool,
                    dep_quant: bool = False, sign_hiding: bool = False) -> np.ndarray:
    """Decode one TU's coefficients -> int32 array [h, w]."""
    assert not (dep_quant and sign_hiding)
    cctx = _Cctx(w, h, is_luma)
    n = w * h  # full-block buffers; scans/budget use cctx.n_coded
    # last position
    gx = 0
    while gx < cctx.max_last_x and dec.decode_bin(_last_ctx_id(cctx, gx, True)):
        gx += 1
    gy = 0
    while gy < cctx.max_last_y and dec.decode_bin(_last_ctx_id(cctx, gy, False)):
        gy += 1
    pos_x = MIN_IN_GROUP[gx]
    if gx > 3:
        v = 0
        for _ in range(((gx - 2) >> 1)):
            v = (v << 1) | dec.decode_bin_ep()
        pos_x += v
    pos_y = MIN_IN_GROUP[gy]
    if gy > 3:
        v = 0
        for _ in range(((gy - 2) >> 1)):
            v = (v << 1) | dec.decode_bin_ep()
        pos_y += v
    blk_last = pos_y * w + pos_x
    scan_pos_last = int(np.nonzero(cctx.blkpos == blk_last)[0][0])

    coeff = np.zeros((h, w), dtype=np.int32)
    coeff_cap = np.zeros((h, w), dtype=np.int32)
    flat_abs = np.zeros(n, dtype=np.int64)
    abs2d = flat_abs.reshape(h, w)
    signs = {}

    state = 0
    rem_reg_bins = (cctx.n_coded * CTX_BIN_SAMPLE_RATIO) >> 4
    sig_groups = {}
    last_cg = scan_pos_last >> cctx.log2_cg
    for cg in range(last_cg, -1, -1):
        is_last_cg = cg == last_cg
        is_not_first = cg != 0
        min_sub = cg << cctx.log2_cg
        max_sub = min_sub + (1 << cctx.log2_cg) - 1
        if not is_last_cg and is_not_first:
            ctx = cctx.sig_group_ctx(cg, sig_groups)
            if not dec.decode_bin(ctx):
                continue
        sig_groups[int(cctx.cg_pos[cg])] = 1
        first_sig = scan_pos_last if is_last_cg else max_sub
        infer_sig_pos = first_sig if first_sig == scan_pos_last else \
            (min_sub if is_not_first else -1)
        num_nonzero = 0
        first_pass_level = {}
        next_pos = first_sig
        gt2_flags = {}
        while next_pos >= min_sub and rem_reg_bins >= 4:
            sig = 1
            if num_nonzero or next_pos != infer_sig_pos:
                sig_ctx = cctx.sig_ctx_id(next_pos, coeff_cap, state)
                sig = dec.decode_bin(sig_ctx)
                rem_reg_bins -= 1
            elif next_pos != scan_pos_last:
                cctx.sig_ctx_id(next_pos, coeff_cap, state)
            level = 0
            if sig:
                ctx_off = cctx.ctx_offset_abs()
                num_nonzero += 1
                level = 1
                gt1 = dec.decode_bin(cctx.gt1_set(ctx_off))
                rem_reg_bins -= 1
                gt2 = 0
                if gt1:
                    par = dec.decode_bin(cctx.par_set(ctx_off))
                    rem_reg_bins -= 1
                    gt2 = dec.decode_bin(cctx.gt2_set(ctx_off))
                    rem_reg_bins -= 1
                    level = 2 + par + 2 * gt2
                blk = int(cctx.blkpos[next_pos])
                y, x = divmod(blk, w)
                first_pass_level[next_pos] = level
                gt2_flags[next_pos] = gt2
                coeff_cap[y, x] = level  # == min(4+(a&1), a) after 1st pass
                abs2d[y, x] = level
            if dep_quant:
                state = _next_state(state, level)
            next_pos -= 1
        first_pos_mode2 = next_pos
        # second pass: remainders for positions with gt2 == 1
        for sp in range(first_sig, first_pos_mode2, -1):
            if gt2_flags.get(sp, 0):
                sum_all = cctx.template_abs_sum(sp, abs2d, 4)
                rice = GO_RICE_PARS[sum_all]
                rem = dec.decode_remabs_ep(rice, COEF_REMAIN_BIN_REDUCTION,
                                           MAX_LOG2_TR_DYNAMIC_RANGE)
                blk = int(cctx.blkpos[sp])
                y, x = divmod(blk, w)
                abs2d[y, x] = first_pass_level[sp] + 2 * rem
        # bypass pass
        bypass_nz = []
        for sp in range(first_pos_mode2, min_sub - 1, -1):
            sum_all = cctx.template_abs_sum(sp, abs2d, 0)
            rice = GO_RICE_PARS[sum_all]
            pos0 = (1 if state < 2 else 2) << rice
            rem = dec.decode_remabs_ep(rice, COEF_REMAIN_BIN_REDUCTION,
                                       MAX_LOG2_TR_DYNAMIC_RANGE)
            a = 0 if rem == pos0 else (rem + 1 if rem < pos0 else rem)
            blk = int(cctx.blkpos[sp])
            y, x = divmod(blk, w)
            abs2d[y, x] = a
            if dep_quant:
                state = _next_state(state, a)
            if a:
                num_nonzero += 1
                bypass_nz.append(sp)
        # signs: first-pass nonzeros in scan-descending order, then bypass
        sign_positions = sorted(first_pass_level.keys(), reverse=True) + bypass_nz
        num_signs = len(sign_positions)
        if num_signs and sign_hiding:
            # sign-data hiding (SBH_THRESHOLD 4): the lowest-scan-pos sign
            # is inferred from the CG abs-sum parity (odd -> negative)
            first_nz, last_nz = sign_positions[-1], sign_positions[0]
            if last_nz - first_nz >= 4:
                num_signs -= 1
                cg_abs = sum(int(abs2d.reshape(-1)[int(cctx.blkpos[sp])])
                             for sp in sign_positions)
                signs[first_nz] = cg_abs & 1
        for sp in sign_positions[:num_signs]:
            s = dec.decode_bin_ep()
            signs[sp] = s
    for sp, s in signs.items():
        blk = int(cctx.blkpos[sp])
        y, x = divmod(blk, w)
        coeff[y, x] = -int(abs2d[y, x]) if s else int(abs2d[y, x])
    # positions with no sign read but nonzero abs cannot occur (no SDH)
    ys, xs = np.nonzero((abs2d != 0) & (coeff == 0))
    for y, x in zip(ys, xs):
        coeff[y, x] = int(abs2d[y, x])
    return coeff


# ---------------------------------------------------------------------------
# transform-skip residual coding (TSRC, H.266 7.3.11.11)
# ---------------------------------------------------------------------------
# Behavioral reference: vvenc CABACWriter::residual_codingTS:2656,
# residual_coding_subblockTS:2686, ContextModelling.h sigCtxIdAbsTS:271,
# signCtxIdAbsTS:323, lrg1CtxIdAbsTS:294, deriveModCoeff:378,
# decDeriveModCoeff:404, initSubblock TsSigCoeffGroup ctx:132.

def _ts_sets(is_luma: bool):
    return (ct.CTX_SETS["TsSigCoeffGroup"], ct.CTX_SETS["TsSigFlag"],
            ct.CTX_SETS["TsResidualSign"], ct.CTX_SETS["TsLrg1Flag"],
            ct.CTX_SETS["TsParFlag"], ct.CTX_SETS["TsGtxFlag"])


def _dec_derive_mod(right: int, below: int, mod: int) -> int:
    if mod == 0:
        return 0
    pred1 = max(abs(right), abs(below))
    if mod == 1 and pred1 > 0:
        return pred1
    return mod - (1 if mod <= pred1 else 0)


def _enc_derive_mod(right: int, below: int, a: int) -> int:
    if a == 0:
        return 0
    pred1 = max(abs(right), abs(below))
    if a == pred1:
        return 1
    return a + 1 if a < pred1 else a


def decode_residual_ts(dec, w: int, h: int, is_luma: bool,
                       bdpcm: int = 0) -> np.ndarray:
    """Decode one transform-skip TU (forward scan, neighbor-predicted
    levels, context-coded signs)."""
    cctx = _Cctx(w, h, is_luma)
    grp_set, sig_set, sign_set, lrg1_set, par_set, gtx_set = _ts_sets(is_luma)
    coeff = np.zeros((h, w), dtype=np.int64)
    rem_reg_bins = (cctx.n_coded * 7) >> 2
    n_cgs = ((cctx.n_coded - 1) >> cctx.log2_cg) + 1
    sig_cg = {}

    def neigh(pos):
        x, y = int(cctx.scan_x[pos]), int(cctx.scan_y[pos])
        r = int(coeff[y, x - 1]) if x > 0 else 0
        b = int(coeff[y - 1, x]) if y > 0 else 0
        return x, y, r, b

    for cg in range(n_cgs):
        cg_pos = int(cctx.cg_pos[cg])
        cgy, cgx = divmod(cg_pos, cctx.w_in_groups)
        sig_left = sig_cg.get(cg_pos - 1, 0) if cgx > 0 else 0
        sig_above = sig_cg.get(cg_pos - cctx.w_in_groups, 0) if cgy > 0 else 0
        if cg == n_cgs - 1 and not any(
                sig_cg.get(int(cctx.cg_pos[k]), 0) for k in range(cg)):
            sig = 1   # inferred: at least one significant group
        else:
            sig = dec.decode_bin(grp_set(sig_left + sig_above))
        sig_cg[cg_pos] = sig
        if not sig:
            continue
        first_pos = cg << cctx.log2_cg
        max_pos = first_pos + (1 << cctx.log2_cg) - 1
        num_nz = 0
        sig_flags = {}
        gt1_flags = {}
        par_flags = {}
        last_p1 = -1
        last_p2 = -1
        pos = first_pos
        while pos <= max_pos and rem_reg_bins >= 4:
            x, y, r, b = neigh(pos)
            if num_nz or pos != max_pos:
                nsig = (1 if (x > 0 and coeff[y, x - 1]) else 0) + \
                       (1 if (y > 0 and coeff[y - 1, x]) else 0)
                sigf = dec.decode_bin(sig_set(nsig))
                rem_reg_bins -= 1
            else:
                sigf = 1
            sig_flags[pos] = sigf
            if sigf:
                if (r == 0 and b == 0) or (r * b < 0):
                    sctx = 0
                elif r >= 0 and b >= 0:
                    sctx = 1
                else:
                    sctx = 2
                if bdpcm:
                    sctx += 3
                sign = dec.decode_bin(sign_set(sctx))
                rem_reg_bins -= 1
                num_nz += 1
                if bdpcm:
                    npos = 3
                else:
                    npos = (1 if (x > 0 and coeff[y, x - 1]) else 0) + \
                           (1 if (y > 0 and coeff[y - 1, x]) else 0)
                gt1 = dec.decode_bin(lrg1_set(npos))
                rem_reg_bins -= 1
                par = 0
                if gt1:
                    par = dec.decode_bin(par_set(0))
                    rem_reg_bins -= 1
                gt1_flags[pos] = gt1
                par_flags[pos] = par
                mod = 1 + gt1 + (par if gt1 else 0)
                # provisional value (refined by later passes)
                coeff[y, x] = -mod if sign else mod
                signs_pos = sign
                sig_flags[pos] = (1, sign)
            else:
                sig_flags[pos] = (0, 0)
            last_p1 = pos
            pos += 1
        # pass 2: gt3/gt5/gt7/gt9 flags
        gtx_counts = {}
        pos = first_pos
        while pos <= max_pos and rem_reg_bins >= 4:
            if pos <= last_p1 and sig_flags.get(pos, (0, 0))[0] and \
                    gt1_flags.get(pos, 0):
                cnt = 0
                for i in range(4):
                    cutoff = 2 + 2 * i
                    # flag coded iff the level reached the cutoff so far
                    if i == 0 or cnt == i:
                        gtx = dec.decode_bin(gtx_set(cutoff >> 1))
                        rem_reg_bins -= 1
                        if gtx:
                            cnt += 1
                        else:
                            break
                gtx_counts[pos] = cnt
                x, y = int(cctx.scan_x[pos]), int(cctx.scan_y[pos])
                sgn = coeff[y, x] < 0
                mod = 2 + par_flags[pos] + 2 * cnt
                coeff[y, x] = -mod if sgn else mod
            last_p2 = pos
            pos += 1
        # pass 3: remainders / bypass values
        for pos in range(first_pos, max_pos + 1):
            x, y = int(cctx.scan_x[pos]), int(cctx.scan_y[pos])
            if pos <= last_p2:
                cutoff = 10
            elif pos <= last_p1:
                cutoff = 2
            else:
                cutoff = 0
            if cutoff == 0:
                # fully bypass-coded position: value + EP sign
                rem = dec.decode_remabs_ep(1, COEF_REMAIN_BIN_REDUCTION,
                                           MAX_LOG2_TR_DYNAMIC_RANGE)
                if rem:
                    sign = dec.decode_bin_ep()
                    coeff[y, x] = -rem if sign else rem
                continue
            if not sig_flags.get(pos, (0, 0))[0]:
                continue
            sgn = coeff[y, x] < 0
            mod = abs(int(coeff[y, x]))
            reached = (cutoff == 2 and gt1_flags.get(pos, 0)) or \
                      (cutoff == 10 and gtx_counts.get(pos, 0) == 4)
            if reached:
                rem = dec.decode_remabs_ep(1, COEF_REMAIN_BIN_REDUCTION,
                                           MAX_LOG2_TR_DYNAMIC_RANGE)
                mod += 2 * rem
                coeff[y, x] = -mod if sgn else mod
        # map modified levels back to absolute levels (neighbor prediction)
        if not bdpcm:
            for pos in range(first_pos, max_pos + 1):
                x, y, r, b = neigh(pos)
                if pos > last_p1:
                    continue  # bypass positions carry plain levels
                mod = abs(int(coeff[y, x]))
                if mod:
                    v = _dec_derive_mod(r, b, mod)
                    coeff[y, x] = -v if coeff[y, x] < 0 else v
    return coeff.astype(np.int32)


def encode_residual_ts(enc, coeff: np.ndarray, is_luma: bool,
                       bdpcm: int = 0) -> None:
    """Encode one transform-skip TU (inverse of decode_residual_ts)."""
    h, w = coeff.shape
    cctx = _Cctx(w, h, is_luma)
    grp_set, sig_set, sign_set, lrg1_set, par_set, gtx_set = _ts_sets(is_luma)
    c = coeff.astype(np.int64)
    rem_reg_bins = (cctx.n_coded * 7) >> 2
    n_cgs = ((cctx.n_coded - 1) >> cctx.log2_cg) + 1
    sig_cg = {}

    def neigh(pos):
        x, y = int(cctx.scan_x[pos]), int(cctx.scan_y[pos])
        r = int(c[y, x - 1]) if x > 0 else 0
        b = int(c[y - 1, x]) if y > 0 else 0
        return x, y, r, b

    cg_sig = []
    for cg in range(n_cgs):
        first = cg << cctx.log2_cg
        cg_sig.append(any(
            c[int(cctx.scan_y[p]), int(cctx.scan_x[p])]
            for p in range(first, first + (1 << cctx.log2_cg))))
    for cg in range(n_cgs):
        cg_pos = int(cctx.cg_pos[cg])
        cgy, cgx = divmod(cg_pos, cctx.w_in_groups)
        sig_left = sig_cg.get(cg_pos - 1, 0) if cgx > 0 else 0
        sig_above = sig_cg.get(cg_pos - cctx.w_in_groups, 0) if cgy > 0 else 0
        inferred = cg == n_cgs - 1 and not any(
            sig_cg.get(int(cctx.cg_pos[k]), 0) for k in range(cg))
        sig = 1 if cg_sig[cg] else 0
        if not inferred:
            enc.encode_bin(sig, grp_set(sig_left + sig_above))
        sig_cg[cg_pos] = sig
        if not sig:
            continue
        first_pos = cg << cctx.log2_cg
        max_pos = first_pos + (1 << cctx.log2_cg) - 1
        num_nz = 0
        mods = {}
        gt1s = {}
        pars = {}
        last_p1 = -1
        last_p2 = -1
        pos = first_pos
        while pos <= max_pos and rem_reg_bins >= 4:
            x, y, r, b = neigh(pos)
            v = int(c[y, x])
            sigf = 1 if v else 0
            if num_nz or pos != max_pos:
                nsig = (1 if (x > 0 and c[y, x - 1]) else 0) + \
                       (1 if (y > 0 and c[y - 1, x]) else 0)
                enc.encode_bin(sigf, sig_set(nsig))
                rem_reg_bins -= 1
            if sigf:
                sign = 1 if v < 0 else 0
                if (r == 0 and b == 0) or (r * b < 0):
                    sctx = 0
                elif r >= 0 and b >= 0:
                    sctx = 1
                else:
                    sctx = 2
                if bdpcm:
                    sctx += 3
                enc.encode_bin(sign, sign_set(sctx))
                rem_reg_bins -= 1
                num_nz += 1
                mod = abs(v) if bdpcm else _enc_derive_mod(r, b, abs(v))
                mods[pos] = mod
                gt1 = 1 if mod > 1 else 0
                npos = 3 if bdpcm else \
                    (1 if (x > 0 and c[y, x - 1]) else 0) + \
                    (1 if (y > 0 and c[y - 1, x]) else 0)
                enc.encode_bin(gt1, lrg1_set(npos))
                rem_reg_bins -= 1
                if gt1:
                    par = (mod - 2) & 1
                    enc.encode_bin(par, par_set(0))
                    rem_reg_bins -= 1
                    pars[pos] = par
                gt1s[pos] = gt1
            last_p1 = pos
            pos += 1
        pos = first_pos
        while pos <= max_pos and rem_reg_bins >= 4:
            x, y, r, b = neigh(pos)
            mod = mods.get(pos, 0) if pos <= last_p1 else 0
            cutoff = 2
            for i in range(4):
                if mod >= cutoff:
                    gtx = 1 if mod >= cutoff + 2 else 0
                    enc.encode_bin(gtx, gtx_set(cutoff >> 1))
                    rem_reg_bins -= 1
                cutoff += 2
            last_p2 = pos
            pos += 1
        for pos in range(first_pos, max_pos + 1):
            x, y, r, b = neigh(pos)
            if pos <= last_p2:
                cutoff = 10
            elif pos <= last_p1:
                cutoff = 2
            else:
                cutoff = 0
            v = int(c[y, x])
            mod = abs(v) if (bdpcm or cutoff == 0) \
                else _enc_derive_mod(r, b, abs(v))
            if mod >= cutoff:
                rem = (mod - cutoff) >> 1 if pos <= last_p1 else mod
                enc.encode_remabs_ep(rem, 1, COEF_REMAIN_BIN_REDUCTION,
                                     MAX_LOG2_TR_DYNAMIC_RANGE)
                if mod and pos > last_p1:
                    enc.encode_bin_ep(1 if v < 0 else 0)

"""Rate-distortion optimized quantization (RDOQ).

A copy of vvenc_tpu/ops/rdoq.py, unchanged: host code, no device program.

Per-coefficient level decision minimizing D + lambda*R over the real
residual-coding syntax: candidate levels {round, round-1} costed with
context-exact fractional-bit rates (sig / gt1 / parity / gt2 / go-rice
remainder, incl. the remRegBins bypass regime), coefficient-group zeroing
decisions against the coded-subblock flag, and a final last-position sweep
that can retire trailing level-1 coefficients against the cbf bit.

Behavioral reference: vvenc CommonLib/QuantRDOQ.cpp:506 (xRateDistOptQuant),
:108 (xGetCodedLevel), :182 (xGetICRate), :319 (xGetErrScaleCoeff).
Context derivations are shared with the entropy coder (bitstream/residual).

Distortion bookkeeping: with levelDouble = |c|*quantScale, a level error
err = levelDouble - (level << qbits) corresponds to a coefficient-domain
error err/quantScale, and pixel-domain SSE err^2 * 2^(-2*tshift_eff) /
quantScale^2 where tshift_eff carries the -0.5 sqrt(2) adjustment
(QuantRDOQ.cpp:323).  Rates are SCALE_BITS fixed point, weighted by
lambda / 2^SCALE_BITS so costs are directly comparable with the
encoder's SSE + lambda*bits RD metric.
"""

from __future__ import annotations

import numpy as np

from ..bitstream.residual import (_Cctx, _last_ctx_id, _min4_parity,
                                  GROUP_IDX, GO_RICE_PARS,
                                  COEF_REMAIN_BIN_REDUCTION,
                                  CTX_BIN_SAMPLE_RATIO)
from .transforms import (QUANT_SCALES, transform_shift, needs_sqrt2,
                         COEFF_MIN, COEFF_MAX)

_EP = 1 << 15  # one EP bin in SCALE_BITS fixed point
_MAX_LEVEL = (1 << 15) - 1


def _golomb_bins(symbol: int, rice: int) -> int:
    """EP-bin count of the abs-remainder binarization (xGetICRate tail)."""
    threshold = COEF_REMAIN_BIN_REDUCTION
    if symbol < (threshold << rice):
        return (symbol >> rice) + 1 + rice
    length = rice
    symbol -= threshold << rice
    while symbol >= (1 << length):
        symbol -= 1 << length
        length += 1
    return threshold + length + 1 - rice + length


def _ic_rate(level, fb_par, fb_gt1, fb_gt2, rem_reg_bins, go_rice_zero,
             rice):
    """Rate (SCALE_BITS fixed point) of coding abs level, incl. sign."""
    if rem_reg_bins < 4:
        symbol = go_rice_zero if level == 0 else \
            (level - 1 if level <= go_rice_zero else level)
        return _EP + _golomb_bins(symbol, rice) * _EP
    if level == 0:
        return 0
    rate = _EP  # sign bit
    if level >= 4:
        rate += _golomb_bins((level - 4) >> 1, rice) * _EP
        rate += fb_gt1[1] + fb_par[(level - 2) & 1] + fb_gt2[1]
    elif level == 1:
        rate += fb_gt1[0]
    elif level == 2:
        rate += fb_gt1[1] + fb_par[0] + fb_gt2[0]
    else:  # 3
        rate += fb_gt1[1] + fb_par[1] + fb_gt2[0]
    return rate


def _coded_level(level_double, max_abs, fb_sig, fb_par, fb_gt1, fb_gt2,
                 rem_reg_bins, go_rice_zero, rice, qbits, err_scale,
                 is_last, lam):
    """Best level for one coefficient (xGetCodedLevel).

    Returns (level, cost_coeff, cost_sig); cost_coeff includes cost_sig."""
    cost0 = float(level_double) ** 2 * err_scale
    best_sig = 0.0
    if not is_last and max_abs < 3:
        best_sig = lam * fb_sig[0]
        best_cost = cost0 + best_sig
        best_level = 0
        if max_abs == 0:
            return 0, best_cost, best_sig
    else:
        best_cost = float("inf")
        best_level = 0
    sig1 = 0.0 if is_last else lam * fb_sig[1]
    lo = max_abs - 1 if max_abs > 1 else 1
    for level in range(max_abs, lo - 1, -1):
        err = float(level_double - (level << qbits))
        cost = err * err * err_scale + lam * _ic_rate(
            level, fb_par, fb_gt1, fb_gt2, rem_reg_bins, go_rice_zero,
            rice) + sig1
        if cost < best_cost:
            best_cost = cost
            best_level = level
            best_sig = sig1
    return best_level, best_cost, best_sig


def rdoq_np(coeff: np.ndarray, qp: int, bit_depth: int, is_luma: bool,
            lmbda: float, ctx, cbf_ctx_id=None) -> np.ndarray:
    """RDOQ dispatcher: native C++ kernel when available (bit-exact port,
    tests/test_native.py), else the Python reference below."""
    from .. import native
    if native.available():
        return native.rdoq(coeff, qp, bit_depth, is_luma, lmbda, ctx,
                           cbf_ctx_id)
    return _rdoq_py(coeff, qp, bit_depth, is_luma, lmbda, ctx, cbf_ctx_id)


def _rdoq_py(coeff: np.ndarray, qp: int, bit_depth: int, is_luma: bool,
             lmbda: float, ctx, cbf_ctx_id=None) -> np.ndarray:
    """RD-optimized quantization of one TU.

    coeff: forward-transform output [h, w] (int).  ctx: CtxModels carrying
    the live CABAC probability state (frac_bits lookups only, no update).
    cbf_ctx_id: context of the cbf / root-cbf bin that would be saved by
    zeroing the whole block (couples the last-position sweep to the CU
    syntax); None skips that saving.
    Returns signed quantized levels [h, w] int32.
    """
    h, w = coeff.shape
    cctx = _Cctx(w, h, is_luma)
    n = cctx.n_coded  # zero-out region only (64-pt high halves never coded)
    sqrt2 = needs_sqrt2(w, h)
    tshift = transform_shift(w, h, bit_depth)
    qbits = 14 + qp // 6 + tshift + (-1 if sqrt2 else 0)
    scale = int(QUANT_SCALES[1 if sqrt2 else 0][qp % 6])
    tshift_eff = tshift - (0.5 if sqrt2 else 0.0)
    err_scale = (2.0 ** (-2.0 * tshift_eff)) / (scale * scale)
    lam = lmbda / _EP

    flat = coeff.astype(np.int64).reshape(-1)
    # vectorized per-position quantities in scan order
    level_double = np.abs(flat[cctx.blkpos]) * scale
    max_abs = np.minimum((level_double + (1 << (qbits - 1))) >> qbits,
                         _MAX_LEVEL).astype(np.int64)
    cost_uncoded = (level_double.astype(np.float64) ** 2) * err_scale
    block_uncoded_cost = float(cost_uncoded.sum())

    nz = np.nonzero(max_abs)[0]
    if len(nz) == 0:
        return np.zeros((h, w), dtype=np.int32)
    last_scan_pos = int(nz[-1])
    cg_size = 1 << cctx.log2_cg
    cg_m1 = cg_size - 1
    n_cg = n >> cctx.log2_cg
    cg_last = last_scan_pos >> cctx.log2_cg

    dst_abs = np.zeros((h, w), dtype=np.int64)   # decided abs levels
    dst_cap = np.zeros((h, w), dtype=np.int32)   # first-pass capped levels
    cost_coeff = np.zeros(n, dtype=np.float64)
    cost_sig = np.zeros(n, dtype=np.float64)
    cost_cg_sig = np.zeros(n_cg, dtype=np.float64)
    sig_groups = {}

    base_cost = 0.0
    # positions in CGs entirely above the last coefficient: uncoded cost only
    for sp in range((cg_last + 1) * cg_size, n):
        base_cost += cost_uncoded[sp]
        cost_coeff[sp] = cost_uncoded[sp]

    rem_reg_bins = (n * CTX_BIN_SAMPLE_RATIO) >> 4
    go_rice = 0
    fb = ctx.frac_bits

    for cg in range(cg_last, -1, -1):
        rem_reg_bins_cg = rem_reg_bins
        min_sub = cg << cctx.log2_cg
        cg_sig = False
        st_sig_cost = 0.0
        st_sig_cost_0 = 0.0
        st_coded_dist = 0.0   # coded cost (incl. level rate) minus sig cost
        st_uncoded_dist = 0.0
        st_nnz_before_pos0 = 0
        for pos_in_cg in range(cg_m1, -1, -1):
            sp = min_sub + pos_in_cg
            blk = int(cctx.blkpos[sp])
            yy, xx = divmod(blk, w)
            if sp > last_scan_pos:
                base_cost += cost_uncoded[sp]
                cost_coeff[sp] = cost_uncoded[sp]
                continue
            is_last = sp == last_scan_pos
            if not is_last:
                sig_ctx = cctx.sig_ctx_id(sp, dst_cap, 0)
                fb_sig = (fb(sig_ctx, 0), fb(sig_ctx, 1))
            else:
                fb_sig = (0, 0)
            ctx_off = cctx.ctx_offset_abs()
            fb_par = (fb(cctx.par_set(ctx_off), 0),
                      fb(cctx.par_set(ctx_off), 1))
            fb_gt1 = (fb(cctx.gt1_set(ctx_off), 0),
                      fb(cctx.gt1_set(ctx_off), 1))
            fb_gt2 = (fb(cctx.gt2_set(ctx_off), 0),
                      fb(cctx.gt2_set(ctx_off), 1))
            go_rice_zero = 0
            if rem_reg_bins < 4:
                sum_abs = cctx.template_abs_sum(sp, dst_abs, 0)
                go_rice = GO_RICE_PARS[sum_abs]
                go_rice_zero = 1 << go_rice  # state 0 (no dep quant)
            level, c_coeff, c_sig = _coded_level(
                int(level_double[sp]), int(max_abs[sp]), fb_sig, fb_par,
                fb_gt1, fb_gt2, rem_reg_bins, go_rice_zero, go_rice, qbits,
                err_scale, is_last, lam)
            cost_coeff[sp] = c_coeff
            cost_sig[sp] = c_sig
            dst_abs[yy, xx] = level
            dst_cap[yy, xx] = _min4_parity(level)
            base_cost += c_coeff
            # rice parameter / context-bin budget carried to the next position
            if (sp & cg_m1) == 0 and sp > 0:
                go_rice = 0
            elif rem_reg_bins >= 4:
                sum_all = cctx.template_abs_sum(sp, dst_abs, 4)
                go_rice = GO_RICE_PARS[sum_all]
                rem_reg_bins -= (level if level < 2 else 3) + \
                    (0 if is_last else 1)
            st_sig_cost += c_sig
            if pos_in_cg == 0:
                st_sig_cost_0 = c_sig
            if level:
                cg_sig = True
                st_coded_dist += c_coeff - c_sig
                st_uncoded_dist += cost_uncoded[sp]
                if pos_in_cg != 0:
                    st_nnz_before_pos0 += 1
        # coefficient-group significance decision
        if cg == 0:
            sig_groups[int(cctx.cg_pos[0])] = 1
            continue
        if not cg_sig:
            gctx = cctx.sig_group_ctx(cg, sig_groups)
            r0 = lam * fb(gctx, 0)
            base_cost += r0 - st_sig_cost
            cost_cg_sig[cg] = r0
            continue
        sig_groups[int(cctx.cg_pos[cg])] = 1
        if cg >= cg_last:
            continue  # last CG handled with the last-position sweep
        if st_nnz_before_pos0 == 0:
            # sig at subblock pos0 is inferred when it is the only nonzero
            base_cost -= st_sig_cost_0
            st_sig_cost -= st_sig_cost_0
        gctx = cctx.sig_group_ctx(cg, sig_groups)
        cost_zero_cg = base_cost + lam * fb(gctx, 0)
        base_cost += lam * fb(gctx, 1)
        cost_cg_sig[cg] = lam * fb(gctx, 1)
        cost_zero_cg += st_uncoded_dist - st_coded_dist - st_sig_cost
        if cost_zero_cg < base_cost:
            del sig_groups[int(cctx.cg_pos[cg])]
            base_cost = cost_zero_cg
            rem_reg_bins = rem_reg_bins_cg
            cost_cg_sig[cg] = lam * fb(gctx, 0)
            for pos_in_cg in range(cg_m1, -1, -1):
                sp = min_sub + pos_in_cg
                blk = int(cctx.blkpos[sp])
                yy, xx = divmod(blk, w)
                if dst_abs[yy, xx]:
                    dst_abs[yy, xx] = 0
                    dst_cap[yy, xx] = 0
                    cost_coeff[sp] = cost_uncoded[sp]
                    cost_sig[sp] = 0.0

    # ----- last-position sweep (QuantRDOQ.cpp:822) -----
    if cbf_ctx_id is not None:
        best_cost = block_uncoded_cost + lam * fb(cbf_ctx_id, 0)
        base_cost += lam * fb(cbf_ctx_id, 1)
    else:
        best_cost = block_uncoded_cost
    best_last_p1 = 0
    # cumulative last-position prefix rates per group index
    dimx, dimy = min(32, w), min(32, h)
    last_bits_x = [0] * (GROUP_IDX[dimx - 1] + 1)
    last_bits_y = [0] * (GROUP_IDX[dimy - 1] + 1)
    bits = 0
    for ctx_id in range(GROUP_IDX[dimx - 1]):
        cid = _last_ctx_id(cctx, ctx_id, True)
        last_bits_x[ctx_id] = bits + fb(cid, 0)
        bits += fb(cid, 1)
    last_bits_x[GROUP_IDX[dimx - 1]] = bits
    bits = 0
    for ctx_id in range(GROUP_IDX[dimy - 1]):
        cid = _last_ctx_id(cctx, ctx_id, False)
        last_bits_y[ctx_id] = bits + fb(cid, 0)
        bits += fb(cid, 1)
    last_bits_y[GROUP_IDX[dimy - 1]] = bits

    found_last = False
    for cg in range(cg_last, -1, -1):
        base_cost -= cost_cg_sig[cg]
        if int(cctx.cg_pos[cg]) not in sig_groups:
            continue
        for pos_in_cg in range(cg_m1, -1, -1):
            sp = (cg << cctx.log2_cg) + pos_in_cg
            if sp > last_scan_pos:
                continue
            blk = int(cctx.blkpos[sp])
            yy, xx = divmod(blk, w)
            if dst_abs[yy, xx]:
                gx, gy = GROUP_IDX[xx], GROUP_IDX[yy]
                cost_last = lam * (last_bits_x[gx] + last_bits_y[gy])
                if gx > 3:
                    cost_last += lam * _EP * ((gx - 2) >> 1)
                if gy > 3:
                    cost_last += lam * _EP * ((gy - 2) >> 1)
                total = base_cost + cost_last - cost_sig[sp]
                if total < best_cost:
                    best_last_p1 = sp + 1
                    best_cost = total
                if dst_abs[yy, xx] > 1:
                    found_last = True
                    break
                base_cost += cost_uncoded[sp] - cost_coeff[sp]
            else:
                base_cost -= cost_sig[sp]
        if found_last:
            break

    out = np.zeros((h, w), dtype=np.int32)
    for sp in range(best_last_p1):
        blk = int(cctx.blkpos[sp])
        yy, xx = divmod(blk, w)
        lv = int(dst_abs[yy, xx])
        if lv:
            out[yy, xx] = -lv if flat[blk] < 0 else lv
    return np.clip(out, COEFF_MIN, COEFF_MAX)

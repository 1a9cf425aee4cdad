"""Decoder-side motion vector refinement (DMVR), H.266 8.5.3.

Per 16x16 sub-PU: 10-bit bilinear predictions over a +-2 pad, 25-point
integer SAD search (every other row, center biased by 25%), parametric
sub-pel error surface, and final 8-tap MC constrained to the originally
fetched reference window (replicated padding).

Behavioral reference: vvenc CommonLib/InterPrediction.cpp
(DMVR::xProcessDMVR:1246, xCopyAndPad:1088, xFinalPaddedMCForDMVR:1189,
xSubPelErrorSrfc:1167, div_for_maxq7:1132), InterpolationFilter.cpp
bilinear N2 filters (:395-421, m_bilinearFilterPrec4:144), RdCost
xGetSAD / xGetSADX5 (subShift 1).
"""

from __future__ import annotations

import numpy as np

from .interp import mc_block_np, NTAPS_LUMA, NTAPS_CHROMA

DMVR_ITER = 2          # DMVR_NUM_ITERATION
DMVR_SUBCU = 16


def clip_mv(mv, x, y, pic_w, pic_h, ctu_size):
    """vvenc clipMv (Mv.cpp:68), 1/16-pel units."""
    off = 8
    hor_max = (pic_w + off - x - 1) << 4
    hor_min = (-ctu_size - off - x + 1) << 4
    ver_max = (pic_h + off - y - 1) << 4
    ver_min = (-ctu_size - off - y + 1) << 4
    return (min(hor_max, max(hor_min, mv[0])),
            min(ver_max, max(ver_min, mv[1])))


def _bilinear_pred(ref: np.ndarray, x: int, y: int, w: int, h: int,
                   mv_x: int, mv_y: int, bit_depth: int) -> np.ndarray:
    """10-bit bilinear prediction (filterN2_2D / bilinearFilterPrec4)."""
    int_x, frac_x = x + (mv_x >> 4), mv_x & 15
    int_y, frac_y = y + (mv_y >> 4), mv_y & 15
    ph, pw = ref.shape
    xs = np.clip(np.arange(int_x, int_x + w + 1), 0, pw - 1)
    ys = np.clip(np.arange(int_y, int_y + h + 1), 0, ph - 1)
    win = ref[np.ix_(ys, xs)].astype(np.int64)
    sh1 = 4 - (10 - bit_depth)      # IF_FILTER_PREC_BILINEAR - (10 - bd)
    if frac_x == 0 and frac_y == 0:
        out = win[:h, :w]
        if bit_depth < 10:
            out = out << (10 - bit_depth)
        return out.astype(np.int32)
    cx0, cx1 = 16 - frac_x, frac_x
    cy0, cy1 = 16 - frac_y, frac_y
    if frac_y == 0:
        v = (win[:h, :w] * cx0 + win[:h, 1:w + 1] * cx1
             + (1 << (sh1 - 1))) >> sh1
        return v.astype(np.int32)
    if frac_x == 0:
        v = (win[:h, :w] * cy0 + win[1:h + 1, :w] * cy1
             + (1 << (sh1 - 1))) >> sh1
        return v.astype(np.int32)
    tmp = (win[:, :w] * cx0 + win[:, 1:w + 1] * cx1
           + (1 << (sh1 - 1))) >> sh1          # (h+1, w) first stage
    v = (tmp[:h] * cy0 + tmp[1:h + 1] * cy1 + 8) >> 4  # second stage
    return v.astype(np.int32)


def _sad_rows(a: np.ndarray, b: np.ndarray) -> int:
    """SAD over even rows only (subShift 1, the <<1 and >>1 cancel)."""
    return int(np.abs(a[::2].astype(np.int64) - b[::2]).sum())


def _div_q7(n: int, d: int) -> int:
    sign = n < 0
    if sign:
        n = -n
    q = 0
    d8 = d << 3
    if n >= d8:
        n -= d8
        q += 1
    q <<= 1
    d4 = d8 >> 1
    if n >= d4:
        n -= d4
        q += 1
    q <<= 1
    if n >= (d4 >> 1):
        q += 1
    return -q if sign else q


def _subpel(sads: np.ndarray, cy: int, cx: int) -> tuple:
    """Parametric error-surface delta (xSubPelErrorSrfc), 1/16 units."""
    out = [0, 0]
    buf = [int(sads[cy, cx]), int(sads[cy, cx - 1]), int(sads[cy - 1, cx]),
           int(sads[cy, cx + 1]), int(sads[cy + 1, cx])]
    for hv in range(2):
        num = (buf[hv + 1] - buf[hv + 3]) << 4
        den = buf[hv + 1] + buf[hv + 3] - (buf[0] << 1)
        if den != 0:
            if buf[hv + 1] != buf[0] and buf[hv + 3] != buf[0]:
                out[hv] = _div_q7(num, den)
            else:
                out[hv] = -8 if buf[hv + 1] == buf[0] else 8
    return out[0], out[1]


def dmvr_refine(ref0, ref1, x, y, w, h, mv0, mv1, bit_depth, pic_w, pic_h,
                ctu_size):
    """Refine a bi CU's merge MVs per 16x16 sub-PU.

    Returns (deltas, bdof_sub): deltas[(sy, sx)] = (dx, dy) in 1/16 units
    (applied +delta to L0, -delta to L1), bdof_sub[(sy, sx)] = whether the
    per-subblock SAD allows BDOF on top."""
    c0 = clip_mv(mv0, x, y, pic_w, pic_h, ctu_size)
    c1 = clip_mv(mv1, x, y, pic_w, pic_h, ctu_size)
    pad = DMVR_ITER
    bl0 = _bilinear_pred(ref0, x - pad, y - pad, w + 2 * pad, h + 2 * pad,
                         c0[0], c0[1], bit_depth)
    bl1 = _bilinear_pred(ref1, x - pad, y - pad, w + 2 * pad, h + 2 * pad,
                         c1[0], c1[1], bit_depth)
    dy_ = min(h, DMVR_SUBCU)
    dx_ = min(w, DMVR_SUBCU)
    deltas = {}
    bdof_sub = {}
    from .. import native
    if native.available():
        # native 25-point search core (the SAD loops were the RD loop's
        # 2nd-hottest host op); python loop below is the golden model
        rows = native.dmvr_refine_core(bl0, bl1, w, h, pad)
        n = 0
        for ys in range(0, h, dy_):
            for xs in range(0, w, dx_):
                deltas[(ys, xs)] = (int(rows[n][0]), int(rows[n][1]))
                bdof_sub[(ys, xs)] = bool(rows[n][2])
                n += 1
        return deltas, bdof_sub
    for ys in range(0, h, dy_):
        for xs in range(0, w, dx_):
            a0 = bl0[pad + ys:pad + ys + dy_, pad + xs:pad + xs + dx_]
            a1 = bl1[pad + ys:pad + ys + dy_, pad + xs:pad + xs + dx_]
            # reference SAD returns sum<<subShift; its >>1 cancels that,
            # so the working value is the even-row sum itself
            min_cost = _sad_rows(a0, a1)
            min_cost -= min_cost >> 2
            if min_cost < dx_ * dy_:
                deltas[(ys, xs)] = (0, 0)
                bdof_sub[(ys, xs)] = False
                continue
            sads = np.full((5, 5), np.iinfo(np.int64).max, np.int64)
            sads[2, 2] = min_cost
            best = (min_cost, 0, 0)
            for ver in range(-2, 3):
                for hor in range(-2, 3):
                    if hor == 0 and ver == 0:
                        pass  # center kept (biased)
                    else:
                        b0 = bl0[pad + ys + ver:pad + ys + ver + dy_,
                                 pad + xs + hor:pad + xs + hor + dx_]
                        b1 = bl1[pad + ys - ver:pad + ys - ver + dy_,
                                 pad + xs - hor:pad + xs - hor + dx_]
                        sads[ver + 2, hor + 2] = _sad_rows(b0, b1)
                    cost = int(sads[ver + 2, hor + 2])
                    if cost < best[0]:
                        best = (cost, hor, ver)
            min_cost, dh, dv = best
            total = [dh << 4, dv << 4]
            if abs(total[0]) != 32 and abs(total[1]) != 32:
                sx_, sy2 = _subpel(sads, dv + 2, dh + 2)
                total[0] += sx_
                total[1] += sy2
            deltas[(ys, xs)] = (total[0], total[1])
            bdof_sub[(ys, xs)] = min_cost >= 2 * dx_ * dy_
    return deltas, bdof_sub


def padded_window_mc(ref: np.ndarray, x: int, y: int, w: int, h: int,
                     merge_mv, refined_mv, comp_scale: int, bit_depth: int,
                     pic_w: int, pic_h: int, ctu_size: int,
                     intermediate: bool = True, alt_hpel: bool = False):
    """Final MC for one component of a DMVR sub-PU when the refined MV's
    integer part moved: reads only the originally prefetched window,
    padded by replication (xCopyAndPad + xFinalPaddedMCForDMVR).

    x, y, w, h, ref in COMPONENT coordinates; MVs in luma 1/16 units
    (the per-component shift is 4 + comp_scale)."""
    from .. import native as _native
    if _native.available():
        ph_, pw_ = ref.shape
        return _native.dmvr_padded_mc(ref, x, y, w, h, merge_mv,
                                      refined_mv, comp_scale, bit_depth,
                                      pic_w, pic_h, ctu_size,
                                      intermediate, alt_hpel)
    is_luma = comp_scale == 0
    filt = NTAPS_LUMA if is_luma else NTAPS_CHROMA
    sh = 4 + comp_scale
    pad = DMVR_ITER >> comp_scale
    # prefetch at the clipped merge MV (luma-coordinate clip)
    cmv = clip_mv(merge_mv, x << comp_scale, y << comp_scale,
                  pic_w, pic_h, ctu_size)
    ext = (filt >> 1) - 1
    x0 = x + (cmv[0] >> sh) - ext
    y0 = y + (cmv[1] >> sh) - ext
    ww = w + filt - 1
    wh = h + filt - 1
    ph, pw = ref.shape
    xs = np.clip(np.arange(x0, x0 + ww), 0, pw - 1)
    ys = np.clip(np.arange(y0, y0 + wh), 0, ph - 1)
    win = ref[np.ix_(ys, xs)]
    padded = np.pad(win, pad, mode="edge")
    # refined MV clip + integer delta vs the UNCLIPPED merge MV
    rmv = clip_mv(refined_mv, x << comp_scale, y << comp_scale,
                  pic_w, pic_h, ctu_size)
    d_ix = (refined_mv[0] >> sh) - (merge_mv[0] >> sh)
    d_iy = (refined_mv[1] >> sh) - (merge_mv[1] >> sh)
    # MC on the padded plane: padded[pad + ext + d_iy, pad + ext + d_ix]
    # is the integer start of the refined block; express via virtual
    # coordinates for mc_block_np: choose block pos (bx, by) and an mv
    # whose integer part lands there with the refined fractional part
    # mc_block_np uses frac = mv & (2^sh - 1): pass the fraction alone and
    # locate the integer start via the block position on the padded plane
    fx = rmv[0] & ((1 << sh) - 1)
    fy = rmv[1] & ((1 << sh) - 1)
    bx = pad + ext + d_ix
    by = pad + ext + d_iy
    return mc_block_np(padded, bx, by, w, h, fx, fy, bit_depth,
                       is_luma=is_luma, intermediate=intermediate,
                       alt_hpel=alt_hpel)

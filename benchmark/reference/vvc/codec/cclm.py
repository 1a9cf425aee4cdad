"""CCLM (cross-component linear model) chroma intra prediction.

H.266 8.4.5.2.13/14; behavioral reference: vvenc
IntraPrediction::loadLMLumaRecPels (IntraPrediction.cpp:1165),
xGetLMParameters (:1408), predIntraChromaLM (:385).  4:2:0, non-vertical-
collocated chroma (sps.verCollocatedChroma == 0) scope.
"""

from __future__ import annotations

import numpy as np

LM_CHROMA_IDX = 81
MDLM_L_IDX = 82
MDLM_T_IDX = 83
CCLM_MODES = (LM_CHROMA_IDX, MDLM_L_IDX, MDLM_T_IDX)

_DIV_SIG_TABLE = [0, 7, 6, 5, 5, 4, 4, 3, 3, 2, 2, 1, 1, 1, 1, 0]


def _ds_interior(luma, x0, y0, cw, ch, left_avail):
    """6-tap 4:2:0 downsample of the co-located luma block -> [ch, cw]."""
    ys = np.arange(y0, y0 + 2 * ch, 2)
    xs = np.arange(x0, x0 + 2 * cw, 2)
    lm1 = xs - 1
    if not left_avail:
        lm1 = lm1.copy()
        lm1[0] = xs[0]
    r0 = luma[np.ix_(ys, xs)].astype(np.int32)
    r1 = luma[np.ix_(ys + 1, xs)].astype(np.int32)
    s = (4 + 2 * r0 + luma[np.ix_(ys, xs + 1)] + luma[np.ix_(ys, lm1)]
         + 2 * r1 + luma[np.ix_(ys + 1, xs + 1)] + luma[np.ix_(ys + 1, lm1)])
    return (s >> 3).astype(np.int32)


def _ds_above(luma, x0, y0, n, left_avail, first_ctu_row):
    """Downsampled above-template luma row of length n (chroma units)."""
    xs = np.arange(x0, x0 + 2 * n, 2)
    lm1 = xs - 1
    if not left_avail:
        lm1 = lm1.copy()
        lm1[0] = xs[0]
    if first_ctu_row:
        ly = y0 - 1
        s = (2 + 2 * luma[ly, xs].astype(np.int32) + luma[ly, lm1]
             + luma[ly, xs + 1])
        return (s >> 2).astype(np.int32)
    ly = y0 - 2
    s = (4 + 2 * luma[ly, xs].astype(np.int32) + luma[ly, xs + 1]
         + luma[ly, lm1] + 2 * luma[ly + 1, xs].astype(np.int32)
         + luma[ly + 1, xs + 1] + luma[ly + 1, lm1])
    return (s >> 3).astype(np.int32)


def _ds_left(luma, x0, y0, n):
    """Downsampled left-template luma column of length n (chroma units)."""
    ys = np.arange(y0, y0 + 2 * n, 2)
    lx = x0 - 2
    s = (4 + 2 * luma[ys, lx].astype(np.int32) + luma[ys, lx + 1]
         + luma[ys, lx - 1] + 2 * luma[ys + 1, lx].astype(np.int32)
         + luma[ys + 1, lx + 1] + luma[ys + 1, lx - 1])
    return (s >> 3).astype(np.int32)


def _count_avail(coded, ux, uy, n, dx, dy, uw, uh):
    """Contiguous available 2x2-chroma units from (ux, uy) stepping."""
    cnt = 0
    for k in range(n):
        x, y = ux + k * dx, uy + k * dy
        if x < 0 or y < 0 or x >= uw or y >= uh or not coded[y, x]:
            break
        cnt += 1
    return cnt


def cclm_predict(ps, cu, comp: int, bit_depth: int, ctu_size: int
                 ) -> np.ndarray:
    """CCLM prediction for one chroma component -> [ch, cw] int32."""
    return cclm_predict_many(ps, cu, bit_depth, ctu_size,
                             (cu.chroma_dir,), (comp,))[(cu.chroma_dir,
                                                         comp)]


def cclm_predict_many(ps, cu, bit_depth: int, ctu_size: int,
                      modes, comps=(1, 2)) -> dict:
    """CCLM predictions for several (mode, comp) pairs at once.

    The expensive shared work — availability walk, 6-tap interior luma
    downsample, and the above/left template downsamples — is computed once
    for the CU and reused across all modes and components (the encoder's
    chroma RD tries LM + both MDLM modes for Cb and Cr, i.e. six calls'
    worth of identical luma processing).  Bit-exact per pair vs the
    single-mode model; vvenc batches nothing here, but its C++ loop is
    cheap while this host path was the profile's second-hottest entry.
    Returns {(mode, comp): pred[ch, cw] int32}.
    """
    from .. import native
    if native.available() and ps.rec[0].dtype == np.int32 \
            and ps.rec[0].flags.c_contiguous:
        return native.cclm_predict_many(ps, cu, bit_depth, ctu_size,
                                        modes, comps)
    cx, cy = cu.x >> 1, cu.y >> 1
    cw, ch = cu.w >> 1, cu.h >> 1
    x0, y0 = cu.x, cu.y          # luma position
    luma = ps.rec[0]
    coded = ps.avail_chroma()
    uh, uw = coded.shape

    # availability in 2x2-chroma units (vvenc isAbove/Left/AR/BL-Available)
    above_units = cw >> 1
    left_units = ch >> 1
    above_avail = cy > 0 and _count_avail(
        coded, cx >> 1, (cy - 1) >> 1, above_units, 1, 0, uw, uh) \
        == above_units
    left_avail = cx > 0 and _count_avail(
        coded, (cx - 1) >> 1, cy >> 1, left_units, 0, 1, uw, uh) \
        == left_units
    # for MDLM: above-right / below-left extensions
    ar_units = bl_units = 0
    if above_avail:
        ar_units = _count_avail(coded, (cx + cw) >> 1, (cy - 1) >> 1,
                                above_units, 1, 0, uw, uh)
    if left_avail:
        bl_units = _count_avail(coded, (cx - 1) >> 1, (cy + ch) >> 1,
                                left_units, 0, 1, uw, uh)

    first_ctu_row = (y0 & (ctu_size - 1)) == 0
    ds = _ds_interior(luma, x0, y0, cw, ch, left_avail)

    # template geometry per mode (xGetLMParameters); downsample each
    # boundary once at the maximum requested length and slice per mode
    geo = {}
    top_max = left_max = 0
    for mode in modes:
        use_above, use_left = above_avail, left_avail
        if mode == MDLM_T_IDX:
            use_left = False
            top_n = 2 * ((cw >> 1) + min(ar_units, ch >> 1)) \
                if above_avail else 0
            left_n = 0
        elif mode == MDLM_L_IDX:
            use_above = False
            left_n = 2 * ((ch >> 1) + min(bl_units, cw >> 1)) \
                if left_avail else 0
            top_n = 0
        else:
            top_n = cw if above_avail else 0
            left_n = ch if left_avail else 0
        geo[mode] = (use_above, use_left, top_n, left_n)
        if use_above:
            top_max = max(top_max, top_n)
        if use_left:
            left_max = max(left_max, left_n)
    ds_above = _ds_above(luma, x0, y0, top_max, left_avail,
                         first_ctu_row) if top_max else None
    ds_left = _ds_left(luma, x0, y0, left_max) if left_max else None

    maxval = (1 << bit_depth) - 1
    out = {}
    for mode in modes:
        use_above, use_left, top_n, left_n = geo[mode]
        above_is4 = 0 if use_left else 1
        left_is4 = 0 if use_above else 1
        # selected template positions are component-independent
        pos_t, pos_l = [], []
        if use_above:
            cnt_t = min(top_n, (1 + above_is4) << 1)
            start = top_n >> (2 + above_is4)
            step = max(1, top_n >> (1 + above_is4))
            pos_t = [start + k * step for k in range(cnt_t)]
        if use_left:
            cnt_l = min(left_n, (1 + left_is4) << 1)
            start = left_n >> (2 + left_is4)
            step = max(1, left_n >> (1 + left_is4))
            pos_l = [start + k * step for k in range(cnt_l)]
        sel_luma_base = ([int(ds_above[p]) for p in pos_t]
                         + [int(ds_left[p]) for p in pos_l])
        for comp in comps:
            chroma = ps.rec[comp]
            sel_luma = sel_luma_base + [0] * (4 - len(sel_luma_base))
            sel_chroma = ([int(chroma[cy - 1, cx + p]) for p in pos_t]
                          + [int(chroma[cy + p, cx - 1]) for p in pos_l])
            sel_chroma += [0] * (4 - len(sel_chroma))
            cnt = len(pos_t) + len(pos_l)

            if cnt == 2:
                sel_luma[3], sel_chroma[3] = sel_luma[0], sel_chroma[0]
                sel_luma[2], sel_chroma[2] = sel_luma[1], sel_chroma[1]
                sel_luma[0], sel_chroma[0] = sel_luma[1], sel_chroma[1]
                sel_luma[1], sel_chroma[1] = sel_luma[3], sel_chroma[3]

            if use_above or use_left:
                mn = [0, 2]
                mx = [1, 3]
                if sel_luma[mn[0]] > sel_luma[mn[1]]:
                    mn[0], mn[1] = mn[1], mn[0]
                if sel_luma[mx[0]] > sel_luma[mx[1]]:
                    mx[0], mx[1] = mx[1], mx[0]
                if sel_luma[mn[0]] > sel_luma[mx[1]]:
                    mn, mx = mx, mn
                if sel_luma[mn[1]] > sel_luma[mx[0]]:
                    mn[1], mx[0] = mx[0], mn[1]
                min_l = (sel_luma[mn[0]] + sel_luma[mn[1]] + 1) >> 1
                min_c = (sel_chroma[mn[0]] + sel_chroma[mn[1]] + 1) >> 1
                max_l = (sel_luma[mx[0]] + sel_luma[mx[1]] + 1) >> 1
                max_c = (sel_chroma[mx[0]] + sel_chroma[mx[1]] + 1) >> 1
                diff = max_l - min_l
                if diff > 0:
                    diff_c = max_c - min_c
                    x = diff.bit_length() - 1
                    norm_diff = ((diff << 4) >> x) & 15
                    v = _DIV_SIG_TABLE[norm_diff] | 8
                    x += int(norm_diff != 0)
                    y = 0 if diff_c == 0 else abs(diff_c).bit_length()
                    add = (1 << y) >> 1
                    a = (diff_c * v + add) >> y
                    shift = 3 + x - y
                    if shift < 1:
                        shift = 1
                        a = 0 if a == 0 else (-15 if a < 0 else 15)
                    b = min_c - ((a * min_l) >> shift)
                else:
                    a, b, shift = 0, min_c, 0
            else:
                a, b, shift = 0, 1 << (bit_depth - 1), 0

            pred = ((a * ds) >> shift) + b
            out[(mode, comp)] = np.clip(pred, 0, maxval).astype(np.int32)
    return out

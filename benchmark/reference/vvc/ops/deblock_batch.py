"""Batched deblocking-edge kernel (vvenc SIMD LoopFilterX86 analog).

The spec model (codec/deblock.py) filters one 4-line edge segment at a
time.  This module applies a whole picture-direction's segments as a
few vectorized batches:

  gather:  every segment's 4x16 sample patch (8 samples each side of
           the edge, clamped at picture borders — the clamped lanes are
           provably unused: long reaches require >=32 blocks, which
           keeps the footprint inside the picture)
  decide:  tc/beta thresholds, large/strong/weak masks per segment
  filter:  long bilinear (grouped by the 9 (n_p, n_q) tap combos),
           strong, and weak variants under masks
  scatter: only lanes each branch actually wrote

Exactness vs the sequential model: edge segments of one direction are
almost always independent (writes reach max_q-1 forward / max_p back,
used reads 3..6 samples), but sub-block CUs with coincident transform
edges (maxlen >= 5 at 8-sample spacing) and 4-grid ISP edges create
read-after-write chains.  `plan_waves` sorts segments by their
perpendicular coordinate and assigns the minimal wave index such that
no segment conflicts (write/read, write/write) with an earlier segment
in the same or a later wave; waves are applied in order, reproducing
the raster-sequential semantics bit-exactly.  The conformance suite
(tests/test_deblock_batch.py) pins equality on the true-preset golden
streams.

The kernel is numpy-vectorized for the host decode loop; the identical
masked formulation maps 1:1 onto jax.numpy (static shapes per wave,
where/clip masks, scatter via .at[].set) for an on-device variant.
"""

from __future__ import annotations

import numpy as np

from ..codec.deblock import (TC_TABLE, BETA_TABLE, DEFAULT_INTRA_TC_OFFSET,
                             MAX_QP, DB_COEFFS, TC_COEFFS)

_TC = np.asarray(TC_TABLE, np.int32)
_BETA = np.asarray(BETA_TABLE, np.int32)


# ---------------------------------------------------------------------------
# segment record: (x, y, vertical, qp, max_p, max_q, bs, at_ctu_hor)
# luma; chroma records: (x, y, vertical, qp, large, lines, at_ctu_hor, bs)
# ---------------------------------------------------------------------------

def _reach(max_s, s_large):
    """Used read reach (samples) beyond the edge on one side."""
    if s_large:
        return max(6, max_s + 1)
    return 4 if max_s > 2 else 3


def plan_waves(ts, pars, max_ps, max_qs, p_larges, q_larges):
    """Assign wave indices so same-wave segments are independent.

    ts: perpendicular edge coordinates, pars: parallel 4-line band start.
    Returns a list of wave indices; applying waves in ascending order
    reproduces the raster-sequential filter exactly (conflicts are
    judged on conservative static read/write extents)."""
    n = len(ts)
    order = sorted(range(n), key=lambda i: (ts[i], pars[i]))
    waves = [0] * n
    by_par = {}
    for i in order:
        t, par = ts[i], pars[i]
        w = 0
        p_reach = _reach(max_ps[i], p_larges[i])
        s_w_lo = t - max_ps[i]
        s_r_lo = t - p_reach
        for j in by_par.get(par, []):
            dt = t - ts[j]
            if dt <= 0 or dt >= 32:
                continue
            o_w_hi = ts[j] + max_qs[j] - 1
            o_r_hi = ts[j] + _reach(max_qs[j], q_larges[j]) - 1
            if o_w_hi >= s_r_lo or o_w_hi >= s_w_lo or o_r_hi >= s_w_lo:
                w = max(w, waves[j] + 1)
        waves[i] = w
        by_par.setdefault(par, []).append(i)
    return waves


def _gather(plane, xs, ys, vertical, xp=np):
    """(N,4,16) patches: lane j = sample k=j-8 across the edge; the
    second axis runs along the edge (4 lines)."""
    h, w = plane.shape
    ks = xp.arange(-8, 8)
    lines = xp.arange(4)
    if vertical:
        yy = xp.broadcast_to(ys[:, None, None] + lines[None, :, None],
                             (len(ys), 4, 16))
        xx = xp.broadcast_to(xs[:, None, None] + ks[None, None, :],
                             (len(xs), 4, 16))
    else:
        yy = xp.broadcast_to(ys[:, None, None] + ks[None, None, :],
                             (len(ys), 4, 16))
        xx = xp.broadcast_to(xs[:, None, None] + lines[None, :, None],
                             (len(xs), 4, 16))
    yy = xp.clip(yy, 0, h - 1)
    xx = xp.clip(xx, 0, w - 1)
    return plane[yy, xx].astype(xp.int32), yy, xx


def _scatter(plane, patch, written, yy, xx):
    plane[yy[written], xx[written]] = patch[written]


def _tc_beta(qp, bs, bit_depth, tc_off_div2=0, beta_off_div2=0, xp=np):
    idx_tc = xp.clip(qp + DEFAULT_INTRA_TC_OFFSET * (bs - 1)
                     + 2 * tc_off_div2, 0,
                     MAX_QP + DEFAULT_INTRA_TC_OFFSET)
    idx_b = xp.clip(qp + 2 * beta_off_div2, 0, MAX_QP)
    if bit_depth < 10:
        tc = (_TC[idx_tc] + (1 << (9 - bit_depth))) >> (10 - bit_depth)
    else:
        tc = _TC[idx_tc] << (bit_depth - 10)
    beta = _BETA[idx_b] << (bit_depth - 8)
    return tc.astype(xp.int32), beta.astype(xp.int32)


def _use_strong_v(P, line, d2, beta, tc, p_large, q_large, max_p, max_q,
                  xp=np):
    """Vectorized _use_strong for one line; P: (N,4,16), base lane 8."""
    g = lambda k: P[:, line, 8 + k]

    def gv(kv):      # variable lane per segment
        return xp.take_along_axis(P[:, line], (8 + kv)[:, None],
                                  axis=1)[:, 0]
    m3, m4 = g(-1), g(0)
    shift_beta = xp.where(p_large | q_large, 4, 2)
    cond = (d2 < (beta >> shift_beta)) & \
        (xp.abs(m3 - m4) < ((tc * 5 + 1) >> 1))
    sp3 = xp.abs(g(-4) - m3)
    sq3 = xp.abs(g(3) - m4)
    # large-side refinement
    mp4 = gv(-max_p - 1)
    sp3_l = sp3 + xp.where(max_p == 7,
                           xp.abs(g(-5) - g(-6) - g(-7) + mp4), 0)
    sp3_l = (sp3_l + xp.abs(g(-4) - mp4) + 1) >> 1
    sp3 = xp.where(p_large, sp3_l, sp3)
    m11 = gv(max_q)
    sq3_l = sq3 + xp.where(max_q == 7,
                           xp.abs(g(4) - g(5) - g(6) + m11), 0)
    sq3_l = (sq3_l + xp.abs(m11 - g(3)) + 1) >> 1
    sq3 = xp.where(q_large, sq3_l, sq3)
    thr = xp.where(p_large | q_large, (beta * 3) >> 5, beta >> 3)
    return cond & (sp3 + sq3 < thr)


def _bilinear_long_v(P, out, written, sel, n_p, n_q, tc, xp=np):
    """Vectorized long filter for the subset `sel` with fixed taps."""
    if not np.any(sel):
        return
    idx = np.nonzero(sel)[0]
    Q = P[idx]                      # (M,4,16)
    t = tc[idx][:, None]            # (M,1) per line broadcast later
    g = lambda k: Q[:, :, 8 + k]    # (M,4)
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
        else:  # 5 / 3
            mid = (g(-1) + g(0) + g(-2) + g(1) + g(-3) + g(2)
                   + g(-4) + g(3) + 4) >> 3
    dbp, dbq = DB_COEFFS[n_p], DB_COEFFS[n_q]
    tcp = TC_COEFFS[7] if n_p != 3 else TC_COEFFS[3]
    tcq = TC_COEFFS[7] if n_q != 3 else TC_COEFFS[3]
    for pos in range(n_p):
        src = g(-1 - pos)
        cval = (t * tcp[pos]) >> 1
        v = (mid * dbp[pos] + ref_p * (64 - dbp[pos]) + 32) >> 6
        out[idx, :, 8 - 1 - pos] = np.clip(v, src - cval, src + cval)
        written[idx, :, 8 - 1 - pos] = True
    for pos in range(n_q):
        src = g(pos)
        cval = (t * tcq[pos]) >> 1
        v = (mid * dbq[pos] + ref_q * (64 - dbq[pos]) + 32) >> 6
        out[idx, :, 8 + pos] = np.clip(v, src - cval, src + cval)
        written[idx, :, 8 + pos] = True


def filter_luma_edges(plane, segs, bit_depth, xp=np):
    """Apply a batch of INDEPENDENT luma 4-line edge segments.

    segs: dict of arrays x, y, qp, max_p, max_q, bs, at_ctu (bool),
    plus scalar 'vertical'.  Mirrors codec/deblock._filter_luma_edge_seg
    exactly."""
    if len(segs["x"]) == 0:
        return
    xs = np.asarray(segs["x"], np.int32)
    ys = np.asarray(segs["y"], np.int32)
    qp = np.asarray(segs["qp"], np.int32)
    max_p = np.asarray(segs["max_p"], np.int32)
    max_q = np.asarray(segs["max_q"], np.int32)
    bs = np.asarray(segs["bs"], np.int32)
    at_ctu = np.asarray(segs["at_ctu"], bool)
    vertical = segs["vertical"]
    maxval = (1 << bit_depth) - 1

    P, yy, xx = _gather(plane, xs, ys, vertical, xp)
    p_large = (max_p > 3) & ~at_ctu
    max_p = np.where(at_ctu, np.minimum(max_p, 3), max_p)
    q_large = max_q > 3
    tc, beta = _tc_beta(qp, bs, bit_depth, xp=xp)
    side_thr = (beta + (beta >> 1)) >> 3
    thr_cut = tc * 10

    g = lambda i, k: P[:, i, 8 + k]

    def dp(i):
        return xp.abs(g(i, -3) - 2 * g(i, -2) + g(i, -1))

    def dq(i):
        return xp.abs(g(i, 0) - 2 * g(i, 1) + g(i, 2))
    dp0, dq0, dp3, dq3 = dp(0), dq(0), dp(3), dq(3)

    out = P.copy()
    written = np.zeros(P.shape, bool)

    # ---- long (large-block) path -----------------------------------------
    any_large = p_large | q_large
    dp0l = xp.where(p_large,
                    (dp0 + xp.abs(g(0, -6) - 2 * g(0, -5) + g(0, -4)) + 1)
                    >> 1, dp0)
    dq0l = xp.where(q_large,
                    (dq0 + xp.abs(g(0, 3) - 2 * g(0, 4) + g(0, 5)) + 1)
                    >> 1, dq0)
    dp3l = xp.where(p_large,
                    (dp3 + xp.abs(g(3, -6) - 2 * g(3, -5) + g(3, -4)) + 1)
                    >> 1, dp3)
    dq3l = xp.where(q_large,
                    (dq3 + xp.abs(g(3, 3) - 2 * g(3, 4) + g(3, 5)) + 1)
                    >> 1, dq3)
    d0l, d3l = dp0l + dq0l, dp3l + dq3l
    long_try = any_large & (d0l + d3l < beta)
    sw_long = long_try & \
        _use_strong_v(P, 0, 2 * d0l, beta, tc, p_large, q_large,
                      max_p, max_q, xp) & \
        _use_strong_v(P, 3, 2 * d3l, beta, tc, p_large, q_large,
                      max_p, max_q, xp)
    n_p_eff = np.where(p_large, max_p, 3)
    n_q_eff = np.where(q_large, max_q, 3)
    for np_ in (3, 5, 7):
        for nq_ in (3, 5, 7):
            sel = sw_long & (n_p_eff == np_) & (n_q_eff == nq_)
            _bilinear_long_v(P, out, written, np.asarray(sel), np_, nq_,
                             tc, xp)

    # ---- normal path -------------------------------------------------------
    d = dp0 + dq0 + dp3 + dq3
    normal = (~sw_long) & (d < beta)
    filt_p = normal & (max_p > 1) & (max_q > 1) & (dp0 + dp3 < side_thr)
    filt_q = normal & (max_p > 1) & (max_q > 1) & (dq0 + dq3 < side_thr)
    sw = normal & (max_p > 2) & (max_q > 2) & \
        _use_strong_v(P, 0, 2 * (dp0 + dq0), beta, tc,
                      np.zeros_like(p_large), np.zeros_like(q_large),
                      max_p, max_q, xp) & \
        _use_strong_v(P, 3, 2 * (dp3 + dq3), beta, tc,
                      np.zeros_like(p_large), np.zeros_like(q_large),
                      max_p, max_q, xp)
    weak = normal & ~sw
    tc_ = tc[:, None]
    # strong 4-line (vectorize over lines)
    m = [P[:, :, 8 + k] for k in range(-4, 4)]  # m[0]=k-4 .. m[7]=k+3
    m0, m1, m2, m3, m4, m5, m6, m7 = m
    sw_l = sw[:, None] & np.ones((1, 4), bool)
    for k, tcm, expr in (
            (-3, 1, (2 * m0 + 3 * m1 + m2 + m3 + m4 + 4) >> 3),
            (-2, 2, (m1 + m2 + m3 + m4 + 2) >> 2),
            (-1, 3, (m1 + 2 * m2 + 2 * m3 + 2 * m4 + m5 + 4) >> 3),
            (0, 3, (m2 + 2 * m3 + 2 * m4 + 2 * m5 + m6 + 4) >> 3),
            (1, 2, (m3 + m4 + m5 + m6 + 2) >> 2),
            (2, 1, (m3 + m4 + m5 + 3 * m6 + 2 * m7 + 4) >> 3)):
        src = P[:, :, 8 + k]
        lim = tc_ * tcm
        v = np.clip(expr, src - lim, src + lim)
        out[:, :, 8 + k] = np.where(sw_l, v, out[:, :, 8 + k])
        written[:, :, 8 + k] |= sw_l
    # weak per line
    delta = (9 * (m4 - m3) - 3 * (m5 - m2) + 8) >> 4
    w_act = weak[:, None] & (np.abs(delta) < thr_cut[:, None])
    dlt = np.clip(delta, -tc_, tc_)
    tc2 = tc_ >> 1
    v_m1 = np.clip(m3 + dlt, 0, maxval)
    out[:, :, 8 - 1] = np.where(w_act, v_m1, out[:, :, 8 - 1])
    written[:, :, 8 - 1] |= w_act
    v_0 = np.clip(m4 - dlt, 0, maxval)
    out[:, :, 8 + 0] = np.where(w_act, v_0, out[:, :, 8 + 0])
    written[:, :, 8 + 0] |= w_act
    d1 = np.clip((((m1 + m3 + 1) >> 1) - m2 + dlt) >> 1, -tc2, tc2)
    wp = w_act & filt_p[:, None]
    out[:, :, 8 - 2] = np.where(wp, np.clip(m2 + d1, 0, maxval),
                                out[:, :, 8 - 2])
    written[:, :, 8 - 2] |= wp
    d2 = np.clip((((m6 + m4 + 1) >> 1) - m5 - dlt) >> 1, -tc2, tc2)
    wq = w_act & filt_q[:, None]
    out[:, :, 8 + 1] = np.where(wq, np.clip(m5 + d2, 0, maxval),
                                out[:, :, 8 + 1])
    written[:, :, 8 + 1] |= wq

    _scatter(plane, out, written, yy, xx)


def filter_chroma_edges(plane, segs, bit_depth, xp=np):
    """Apply a batch of independent chroma edge segments (mirrors
    codec/deblock._filter_chroma_edge_seg).  All chroma segments of one
    direction are mutually independent (writes reach 3, used reads start
    4 away at the 8-chroma-sample grid)."""
    if len(segs["x"]) == 0:
        return
    xs = np.asarray(segs["x"], np.int32)
    ys = np.asarray(segs["y"], np.int32)
    qp = np.asarray(segs["qp"], np.int32)
    large = np.asarray(segs["large"], bool)
    lines = np.asarray(segs["lines"], np.int32)   # 1 or 2
    at_ctu = np.asarray(segs["at_ctu"], bool)
    bs = np.asarray(segs["bs"], np.int32)
    vertical = segs["vertical"]
    maxval = (1 << bit_depth) - 1

    P, yy, xx = _gather(plane, xs, ys, vertical, xp)
    tc, beta = _tc_beta(qp, bs, bit_depth, xp=xp)
    act = tc != 0

    g = lambda i, k: P[:, i, 8 + k]

    def dp(i):
        base = xp.where(at_ctu,
                        xp.abs(g(i, -2) - 2 * g(i, -2) + g(i, -1)),
                        xp.abs(g(i, -3) - 2 * g(i, -2) + g(i, -1)))
        return base

    def dq(i):
        return xp.abs(g(i, 0) - 2 * g(i, 1) + g(i, 2))

    d0 = dp(0) + dq(0)
    d3 = dp(1) + dq(1)
    use_long = act & large & (d0 + d3 < beta)

    def strong_line(i, d2):
        m3, m4 = g(i, -1), g(i, 0)
        cond = (d2 < (beta >> 2)) & \
            (xp.abs(m3 - m4) < ((tc * 5 + 1) >> 1))
        sp3 = xp.where(at_ctu, xp.abs(g(i, -2) - m3),
                       xp.abs(g(i, -4) - m3))
        sq3 = xp.abs(g(i, 3) - m4)
        return cond & (sp3 + sq3 < (beta >> 3))
    sw = use_long & strong_line(0, 2 * d0) & strong_line(1, 2 * d3)

    out = P.copy()
    written = np.zeros(P.shape, bool)
    tc_ = tc[:, None]
    line_act = (np.arange(4)[None, :] < lines[:, None]) & act[:, None]
    m = [P[:, :, 8 + k] for k in range(-4, 4)]
    m0, m1, m2, m3, m4, m5, m6, m7 = m
    sw_l = sw[:, None] & line_act
    ac_l = at_ctu[:, None]
    # strong (long) chroma taps, at-CTU variant selected per segment
    taps = {
        -3: ((3 * m0 + 2 * m1 + m2 + m3 + m4 + 4) >> 3, None),
        -2: ((2 * m0 + m1 + 2 * m2 + m3 + m4 + m5 + 4) >> 3, None),
        -1: ((m0 + m1 + m2 + 2 * m3 + m4 + m5 + m6 + 4) >> 3,
             (3 * m2 + 2 * m3 + m4 + m5 + m6 + 4) >> 3),
        0: ((m1 + m2 + m3 + 2 * m4 + m5 + m6 + m7 + 4) >> 3,
            (2 * m2 + m3 + 2 * m4 + m5 + m6 + m7 + 4) >> 3),
        1: ((m2 + m3 + m4 + 2 * m5 + m6 + 2 * m7 + 4) >> 3,
            (m2 + m3 + m4 + 2 * m5 + m6 + 2 * m7 + 4) >> 3),
        2: ((m3 + m4 + m5 + 2 * m6 + 3 * m7 + 4) >> 3,
            (m3 + m4 + m5 + 2 * m6 + 3 * m7 + 4) >> 3),
    }
    for k, (v_n, v_c) in taps.items():
        src = P[:, :, 8 + k]
        if v_c is None:           # k in (-3,-2): normal variant only
            mask = sw_l & ~ac_l
            v = v_n
        else:
            mask = sw_l
            v = np.where(ac_l, v_c, v_n)
        v = np.clip(v, src - tc_, src + tc_)
        out[:, :, 8 + k] = np.where(mask, v, out[:, :, 8 + k])
        written[:, :, 8 + k] |= mask
    # weak chroma
    wk = (~sw)[:, None] & line_act
    dlt = np.clip((4 * (m4 - m3) + m2 - m5 + 4) >> 3, -tc_, tc_)
    v1 = np.clip(m3 + dlt, 0, maxval)
    out[:, :, 8 - 1] = np.where(wk, v1, out[:, :, 8 - 1])
    written[:, :, 8 - 1] |= wk
    v2 = np.clip(m4 - dlt, 0, maxval)
    out[:, :, 8 + 0] = np.where(wk, v2, out[:, :, 8 + 0])
    written[:, :, 8 + 0] |= wk

    _scatter(plane, out, written, yy, xx)

"""Vectorized multi-mode intra prediction (bit-exact vs ops/intra.py).

The round-1 encoder predicted one mode at a time through the scalar spec
model (ops/intra.py), which made the 67-mode SATD preselection the single
hottest loop of the whole encoder (~63%% of e2e time).  This module
evaluates ANY SET of angular/planar/DC modes of one block in one shot:

  * all per-mode control flow (wide-angle mapping, MDIS filter choice,
    negative-angle reference projection, 4-tap phase tables, PDPC weights)
    is folded into static gather/FMA tables per (w, h, ref-line, plane) —
    the same inversion vvenc's SIMD kernels apply per-row
    (IntraPredX86.h), taken one level further: vectorized over MODES.
  * the arithmetic mirrors ops/intra.py exactly (same shifts, rounds,
    clips, PDPC forms), so candidate ranking — and therefore the encoded
    bitstream — is bit-identical to the scalar path.

The table layout is shared with the device prediction kernel (K1,
csrc/intra_pred_all.cu, via ops/tables.py): host uses numpy gathers,
the device reads the identical tables as uploaded tensors.

Behavioral reference: vvenc CommonLib/IntraPrediction.cpp
(initPredIntraParams:409, xPredIntraAng:518) and the per-ISA kernels
(CommonLib/x86/IntraPredX86.h).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from . import intra as I


class _ShapeTables:
    """Static per-(w, h, is_luma, m) tables for the 65 angular modes.

    Arrays are indexed by signalled mode (2..66 stored at rows 0..64).
    Orientation: each mode is computed in its 'main' orientation
    (th x tw = (h, w) for vertical modes, (w, h) for horizontal) and
    transposed afterwards, exactly like the scalar model.
    """

    __slots__ = ("w", "h", "m", "is_luma", "B0", "LR", "LPAD",
                 "rm_src", "rm_idx", "row_start", "filt", "shift", "round",
                 "clip_mid", "is_ver",
                 "pdpc_on", "pdpc_ang0", "pdpc_wl", "pdpc_side_idx",
                 "pdpc_side_src")


def _params(w, h, mode, is_luma, m):
    return I.intra_params(w, h, mode, is_luma, m)


@lru_cache(maxsize=None)
def _shape_tables(w: int, h: int, is_luma: bool, m: int) -> _ShapeTables:
    NM = I.NUM_LUMA_MODE - 2          # 65 angular modes (2..66)
    t = _ShapeTables()
    t.w, t.h, t.m, t.is_luma = w, h, m, is_luma
    # padded source layout: [top, ftop, left, fleft], each padded to LPAD
    top_len = 2 * w + m + 3
    left_len = 2 * h + m + 3
    t.LPAD = max(top_len, left_len)
    B0 = max(w, h) + m                # common rm base offset
    t.B0 = B0
    t.LR = B0 + 2 * max(w, h) + m + 12
    TW = max(w, h)                    # padded tw per-mode rows
    TH = max(w, h)

    t.rm_src = np.zeros((NM, t.LR), dtype=np.int8)
    t.rm_idx = np.zeros((NM, t.LR), dtype=np.int32)
    t.row_start = np.zeros((NM, TH), dtype=np.int32)
    t.filt = np.zeros((NM, TH, 4), dtype=np.int32)
    t.shift = np.zeros(NM, dtype=np.int32)
    t.round = np.zeros(NM, dtype=np.int32)
    t.clip_mid = np.zeros(NM, dtype=bool)
    t.is_ver = np.zeros(NM, dtype=bool)
    t.pdpc_on = np.zeros(NM, dtype=bool)
    t.pdpc_ang0 = np.zeros(NM, dtype=bool)
    t.pdpc_wl = np.zeros((NM, TW), dtype=np.int32)
    t.pdpc_side_idx = np.zeros((NM, TH, TW), dtype=np.int32)
    t.pdpc_side_src = np.zeros(NM, dtype=np.int8)

    TOP, FTOP, LEFT, FLEFT = 0, 1, 2, 3
    for mi, mode in enumerate(range(2, I.NUM_LUMA_MODE)):
        p = _params(w, h, mode, is_luma, m)
        ver = p.is_ver
        t.is_ver[mi] = ver
        tw, th = (w, h) if ver else (h, w)
        main = (FTOP if p.ref_filter else TOP) if ver else \
               (FLEFT if p.ref_filter else LEFT)
        side = (FLEFT if p.ref_filter else LEFT) if ver else \
               (FTOP if p.ref_filter else TOP)
        main_real_len = top_len if ver else left_len
        side_real_len = left_len if ver else top_len
        # --- rm construction (mirrors I._build_ref_main_side) ------------
        if p.angle < 0:
            sside = h if ver else w
            main_len = tw + 2 + m
            # rm[B0 - m + k] == refMain[k - m] in scalar terms; scalar base
            # = side + m, our base = B0 (>= side + m); align so that
            # rm[B0 + k] == refMain(base + k)
            for k in range(main_len):
                j = B0 - m + k
                t.rm_src[mi, j] = main
                t.rm_idx[mi, j] = k
            for k in range(-sside, 0):
                idx = min((-k * p.abs_inv_angle + 256) >> 9, sside)
                j = B0 - m + k
                t.rm_src[mi, j] = side
                t.rm_idx[mi, j] = idx
            filled_lo, filled_hi = B0 - m - sside, B0 - m + main_len
        else:
            ref_len = 2 * tw
            log2_ratio = (w.bit_length() - 1) - (h.bit_length() - 1)
            s = max(0, log2_ratio if ver else -log2_ratio)
            max_index = (m << s) + 2
            need = m + ((th * max(p.angle, 0)) >> 5) + tw + 8
            ln = max(ref_len + m + max_index + 8, need)
            n = min(main_real_len, ref_len + m + 1)
            for k in range(min(ln, t.LR - B0 + m)):
                j = B0 - m + k
                if j >= t.LR:
                    break
                t.rm_src[mi, j] = main
                t.rm_idx[mi, j] = min(k, n - 1)
            filled_lo, filled_hi = B0 - m, min(B0 - m + ln, t.LR)
        # fill the rest of the row with a safe gather (value unused)
        for j in range(0, filled_lo):
            t.rm_src[mi, j] = main
            t.rm_idx[mi, j] = 0
        for j in range(filled_hi, t.LR):
            t.rm_src[mi, j] = main
            t.rm_idx[mi, j] = 0
        # --- per-row tap tables ------------------------------------------
        integer_slope = I.is_integer_slope(abs(p.angle))
        delta_pos = p.angle * (1 + m)
        if integer_slope:
            t.shift[mi], t.round[mi] = 6, 32
        elif is_luma:
            t.shift[mi], t.round[mi] = 6, 32
            t.clip_mid[mi] = not p.interp   # cubic taps can overshoot
        else:
            t.shift[mi], t.round[mi] = 5, 16
        for y in range(th):
            delta_int = delta_pos >> 5
            frac = delta_pos & 31
            t.row_start[mi, y] = B0 + delta_int
            if integer_slope:
                t.filt[mi, y] = (0, 64, 0, 0)
            elif is_luma:
                t.filt[mi, y] = (I.smoothing_filter(frac) if p.interp
                                 else I.CHROMA_FILTER[frac])
            else:
                t.filt[mi, y] = (0, 32 - frac, frac, 0)
            delta_pos += p.angle
        # --- PDPC ----------------------------------------------------------
        if p.apply_pdpc:
            t.pdpc_on[mi] = True
            t.pdpc_side_src[mi] = side
            if p.angle == 0:
                t.pdpc_ang0[mi] = True
                scale = (((tw * th).bit_length() - 1) - 2) >> 2
                for x in range(min(3 << scale, tw)):
                    t.pdpc_wl[mi, x] = 32 >> ((2 * x) >> scale)
                for y in range(th):
                    # lval = ref_side[1 + y]; ref_side = side_src[m:]
                    t.pdpc_side_idx[mi, y, :] = min(m + 1 + y,
                                                    side_real_len - 1)
            else:
                scale = p.angular_scale
                for x in range(min(3 << scale, tw)):
                    inv_sum = 256 + (x + 1) * p.abs_inv_angle
                    t.pdpc_wl[mi, x] = 32 >> ((2 * x) >> scale)
                    for y in range(th):
                        t.pdpc_side_idx[mi, y, x] = min(
                            m + y + (inv_sum >> 9) + 1, side_real_len - 1)
    return t


def _pack_srcs(top: np.ndarray, left: np.ndarray, LPAD: int):
    """[4, LPAD] array: top, filtered-top, left, filtered-left."""
    ftop, fleft = I.filter_reference(top, left)
    srcs = np.zeros((4, LPAD), dtype=np.int32)
    srcs[0, :len(top)] = top
    srcs[1, :len(ftop)] = ftop
    srcs[2, :len(left)] = left
    srcs[3, :len(fleft)] = fleft
    return srcs


def predict_intra_modes(top: np.ndarray, left: np.ndarray, modes,
                        w: int, h: int, bit_depth: int = 10,
                        is_luma: bool = True, ref_idx: int = 0
                        ) -> np.ndarray:
    """Predictions [len(modes), h, w] — bit-exact vs I.predict_intra.

    modes may contain PLANAR/DC and any angular modes (2..66); PLANAR is
    rejected when ref_idx > 0 (spec).  No ISP/cu_dims support here (the
    ISP path stays on the scalar model).
    """
    from .. import native
    if native.available():
        return native.predict_modes(top, left, list(modes), w, h,
                                    bit_depth, is_luma, ref_idx)
    top = np.asarray(top, dtype=np.int32)
    left = np.asarray(left, dtype=np.int32)
    modes = np.asarray(modes, dtype=np.int32)
    maxval = (1 << bit_depth) - 1
    out = np.zeros((len(modes), h, w), dtype=np.int32)

    ang_pos = np.nonzero(modes >= 2)[0]
    # planar / DC through the scalar closed forms (cheap, exact)
    for i in np.nonzero(modes < 2)[0]:
        out[i] = I.predict_intra(top, left, int(modes[i]), w, h, bit_depth,
                                 is_luma, ref_idx=ref_idx)
    if len(ang_pos) == 0:
        return out

    t = _shape_tables(w, h, is_luma, ref_idx)
    srcs = _pack_srcs(top, left, t.LPAD)
    mi = modes[ang_pos] - 2                                   # table rows
    rm = srcs[t.rm_src[mi], t.rm_idx[mi]]                     # [n, LR]
    n = len(mi)

    ver_m = t.is_ver[mi]
    for group, (tw, th) in ((True, (w, h)), (False, (h, w))):
        gsel = np.nonzero(ver_m == group)[0]
        if len(gsel) == 0:
            continue
        g = mi[gsel]
        ng = len(gsel)
        grm = rm[gsel]                                        # [ng, LR]
        rs = t.row_start[g][:, :th]                           # [ng, th]
        filt = t.filt[g][:, :th]                              # [ng, th, 4]
        # single flat gather of all 4 taps: [ng, th, tw, 4]
        idx = (rs[:, :, None, None]
               + np.arange(tw, dtype=np.int32)[None, None, :, None]
               + np.arange(4, dtype=np.int32)[None, None, None, :]
               + (np.arange(ng, dtype=np.intp) * grm.shape[1]
                  )[:, None, None, None])
        gall = grm.reshape(-1)[idx]
        acc = (filt[:, :, None, :] * gall).sum(axis=-1, dtype=np.int32)
        pred = (acc + t.round[g][:, None, None]) >> t.shift[g][:, None, None]
        cm = t.clip_mid[g]
        if cm.any():
            pred[cm] = np.clip(pred[cm], 0, maxval)
        # PDPC
        pd = t.pdpc_on[g]
        if pd.any():
            ssrc = srcs[t.pdpc_side_src[g]]                   # [ng, LPAD]
            sidx = (t.pdpc_side_idx[g][:, :th, :tw]
                    + (np.arange(ng, dtype=np.intp)
                       * ssrc.shape[1])[:, None, None])
            lval = ssrc.reshape(-1)[sidx]
            wl = t.pdpc_wl[g][:, None, :tw]
            a0 = t.pdpc_ang0[g]
            reg = pd & ~a0
            if reg.any():
                pred[reg] = pred[reg] + (
                    (wl[reg] * (lval[reg] - pred[reg]) + 32) >> 6)
            if a0.any():
                tl = grm[a0, t.B0][:, None, None]
                upd = pred[a0] + ((wl[a0] * (lval[a0] - tl) + 32) >> 6)
                upd = np.clip(upd, 0, maxval)
                msk = wl[a0] != 0
                pa = pred[a0]
                pa = np.where(np.broadcast_to(msk, pa.shape), upd, pa)
                pred[a0] = pa
        pred = np.clip(pred, 0, maxval)
        if not group:
            pred = pred.transpose(0, 2, 1)
        out[ang_pos[gsel]] = pred
    return out


def satd_modes(src: np.ndarray, preds: np.ndarray) -> np.ndarray:
    """Batched vvenc-convention SATD: src [h, w] vs preds [M, h, w].

    Bit-exact vs R.satd_np per mode (same 8x8/4x4 tiling + normalization).
    """
    from .. import native
    if native.available():
        return native.satd_modes(src, preds)
    from .rdcost import _hadamard
    M, h, w = preds.shape
    d = src.astype(np.int64)[None] - preds.astype(np.int64)
    ts = 8 if (h % 8 == 0 and w % 8 == 0) else 4
    hm = _hadamard(ts).astype(np.int64)
    tt = d.reshape(M, h // ts, ts, w // ts, ts).transpose(0, 1, 3, 2, 4)
    tt = hm @ tt @ hm
    s = np.abs(tt).sum(axis=(-2, -1))
    if ts == 8:
        s = (s + 2) >> 2
    else:
        dc = np.abs(tt[..., 0, 0])
        s = ((s - dc + (dc >> 2)) + 1) >> 1
    return s.sum(axis=(1, 2))

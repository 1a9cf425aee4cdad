"""Bi-directional optical flow (BDOF), H.266 8.5.6.4-8.5.6.5.

Per 4x4 subblock of a bi-predicted CU with opposite-direction equal-POC
references: gradients of the two 14-bit intermediate predictions over an
extended (w+2)x(h+2) grid, per-subblock flow (vx, vy) from 6x6 windows,
and the corrected average.

Behavioral reference: vvenc CommonLib/InterPrediction.cpp
(gradFilterCore:114, calcBDOFSumsCore:157, xFpBiDirOptFlowCore:607,
addBDOFAvgCore:63, integer-sample ring in xPredInterBlk:868-905,
xApplyBDOF:911).
"""

from __future__ import annotations

import numpy as np

from .interp import mc_block_np, IF_INTERNAL_PREC, IF_INTERNAL_OFFS

BDOF_LIMIT = 15  # (1 << 4) - 1


def _ext_pred(ref_plane: np.ndarray, x: int, y: int, w: int, h: int,
              mv_x: int, mv_y: int, bit_depth: int,
              alt_hpel: bool = False) -> np.ndarray:
    """(h+2, w+2) extended 14-bit intermediate: inner block via 8-tap MC,
    1-sample ring from nearest-integer reference samples."""
    ext = np.zeros((h + 2, w + 2), dtype=np.int64)
    ext[1:h + 1, 1:w + 1] = mc_block_np(ref_plane, x, y, w, h, mv_x, mv_y,
                                        bit_depth, True, intermediate=True,
                                        alt_hpel=alt_hpel)
    int_x, frac_x = x + (mv_x >> 4), mv_x & 15
    int_y, frac_y = y + (mv_y >> 4), mv_y & 15
    xoff = 1 if frac_x < 8 else 0
    yoff = 1 if frac_y < 8 else 0
    ph, pw = ref_plane.shape
    shift = max(2, IF_INTERNAL_PREC - bit_depth)
    xs = np.clip(np.arange(int_x - xoff, int_x - xoff + w + 2), 0, pw - 1)
    ys = np.clip(np.arange(int_y - yoff, int_y - yoff + h + 2), 0, ph - 1)
    ring = (ref_plane[np.ix_(ys, xs)].astype(np.int64) << shift) \
        - IF_INTERNAL_OFFS
    ext[0, :] = ring[0, :]
    ext[h + 1, :] = ring[h + 1, :]
    ext[1:h + 1, 0] = ring[1:h + 1, 0]
    ext[1:h + 1, w + 1] = ring[1:h + 1, w + 1]
    return ext


def _gradients(ext: np.ndarray, w: int, h: int):
    """Core gradients over the inner w x h, replicated to (h+2, w+2)
    (gradFilterCore with PAD)."""
    gx = np.zeros_like(ext)
    gy = np.zeros_like(ext)
    c = ext
    gx[1:h + 1, 1:w + 1] = (c[1:h + 1, 2:w + 2] >> 6) - (c[1:h + 1, 0:w] >> 6)
    gy[1:h + 1, 1:w + 1] = (c[2:h + 2, 1:w + 1] >> 6) - (c[0:h, 1:w + 1] >> 6)
    for g in (gx, gy):
        g[1:h + 1, 0] = g[1:h + 1, 1]
        g[1:h + 1, w + 1] = g[1:h + 1, w]
        g[0, :] = g[1, :]
        g[h + 1, :] = g[h, :]
    return gx, gy


def bdof_block(ref0: np.ndarray, ref1: np.ndarray, x: int, y: int,
               w: int, h: int, mv0, mv1, bit_depth: int,
               alt_hpel: bool = False) -> np.ndarray:
    """BDOF-corrected bi-prediction of one block (w, h <= 16)."""
    return bdof_block_src((ref0, x, y, mv0), (ref1, x, y, mv1), w, h,
                          bit_depth, alt_hpel)


def bdof_block_src(src0, src1, w: int, h: int, bit_depth: int,
                   alt_hpel: bool = False) -> np.ndarray:
    """BDOF with per-list source specs (plane, x, y, mv) — the plane may
    be a DMVR padded window with block-local coordinates."""
    e0 = _ext_pred(src0[0], src0[1], src0[2], w, h, src0[3][0], src0[3][1],
                   bit_depth, alt_hpel)
    e1 = _ext_pred(src1[0], src1[1], src1[2], w, h, src1[3][0], src1[3][1],
                   bit_depth, alt_hpel)
    gx0, gy0 = _gradients(e0, w, h)
    gx1, gy1 = _gradients(e1, w, h)
    # replace the pred ring by replication of the inner block
    for e in (e0, e1):
        e[1:h + 1, 0] = e[1:h + 1, 1]
        e[1:h + 1, w + 1] = e[1:h + 1, w]
        e[0, :] = e[1, :]
        e[h + 1, :] = e[h, :]

    shift_num = IF_INTERNAL_PREC + 1 - bit_depth
    offset = (1 << (shift_num - 1)) + 2 * IF_INTERNAL_OFFS
    maxval = (1 << bit_depth) - 1
    out = np.zeros((h, w), dtype=np.int64)
    for yu in range(h >> 2):
        for xu in range(w >> 2):
            y0, x0 = yu * 4, xu * 4   # ext coords of the 6x6 window start
            sl = (slice(y0, y0 + 6), slice(x0, x0 + 6))
            tgx = (gx0[sl] + gx1[sl]) >> 1
            tgy = (gy0[sl] + gy1[sl]) >> 1
            tdi = (e1[sl] >> 4) - (e0[sl] >> 4)
            s_gx = int(np.abs(tgx).sum())
            s_gy = int(np.abs(tgy).sum())
            s_dix = int((np.sign(tgx) * tdi).sum())
            s_diy = int((np.sign(tgy) * tdi).sum())
            s_gygx = int((np.sign(tgy) * tgx).sum())
            vx = 0 if s_gx == 0 else \
                (4 * s_dix) >> (s_gx.bit_length() - 1)
            vx = max(-BDOF_LIMIT, min(BDOF_LIMIT, vx))
            tmp = (s_gygx * vx) >> 1
            vy = 0 if s_gy == 0 else \
                (4 * s_diy - tmp) >> (s_gy.bit_length() - 1)
            vy = max(-BDOF_LIMIT, min(BDOF_LIMIT, vy))
            isl = (slice(y0 + 1, y0 + 5), slice(x0 + 1, x0 + 5))
            b = vx * (gx0[isl] - gx1[isl]) + vy * (gy0[isl] - gy1[isl])
            v = (e0[isl] + e1[isl] + b + offset) >> shift_num
            out[yu * 4:yu * 4 + 4, xu * 4:xu * 4 + 4] = \
                np.clip(v, 0, maxval)
    return out.astype(np.int32)

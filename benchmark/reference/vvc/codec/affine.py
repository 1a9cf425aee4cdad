"""Affine motion model: 4/6-parameter prediction, SbTMVP, PROF.

Behavioral reference: vvenc CommonLib/UnitTools.cpp (xInheritedAffineMv:1878,
fillAffineMvpCand:1955, getAffineControlPointCand:2234,
getInterMergeSbTMVPCand:2374, getAffineMergeCand:2587, setAllAffineMv:2904,
clipColPos:2988), InterPrediction.cpp (xPredAffineBlk:1497,
isSubblockVectorSpreadOverLimit:1457, applyPROFCore:88, gradFilterCore:114),
InterpolationFilter.cpp (m_lumaFilter4x4:64 — the 6-tap affine luma filter).

MVs at the internal 1/16-pel precision; CPMVs per control point LT/RT/LB.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .motion import (MotionInfo, get_colocated_mvp, same_motion,
                     _avail_inter)
from ..ops.interp import (mc_block_np, bi_average_np, bcw_average_np,
                          IF_INTERNAL_PREC, IF_INTERNAL_OFFS)

MAX_CU_DEPTH = 7                 # log2(max CTU); affine shift base
SB = 4                           # AFFINE_MIN_BLOCK_SIZE
ATMVP_SB = 8                     # 1 << ATMVP_SUB_BLOCK_SIZE
STOR_MIN, STOR_MAX = -(1 << 17), (1 << 17) - 1
AFF_AMVR_SHIFTS = (2, 0, 4)      # imv 0=quarter, 1=1/16, 2=int (Mv.cpp:58)

# 6-tap affine luma filter, stored 8-wide with zero guard taps so the
# regular 8-tap windowing applies (InterpolationFilter.cpp:64 + the
# filter<6> coeff++/src-offset convention == 8-tap with zero ends)
AFFINE_LUMA_FILTER = np.array([
    [0, 0,   0, 64,  0,   0,  0,  0],
    [0, 1,  -3, 63,  4,  -2,  1,  0],
    [0, 1,  -5, 62,  8,  -3,  1,  0],
    [0, 2,  -8, 60, 13,  -4,  1,  0],
    [0, 3, -10, 58, 17,  -5,  1,  0],
    [0, 3, -11, 52, 26,  -8,  2,  0],
    [0, 2,  -9, 47, 31, -10,  3,  0],
    [0, 3, -11, 45, 34, -10,  3,  0],
    [0, 3, -11, 40, 40, -11,  3,  0],
    [0, 3, -10, 34, 45, -11,  3,  0],
    [0, 3, -10, 31, 47,  -9,  2,  0],
    [0, 2,  -8, 26, 52, -11,  3,  0],
    [0, 1,  -5, 17, 58, -10,  3,  0],
    [0, 1,  -4, 13, 60,  -8,  2,  0],
    [0, 1,  -3,  8, 62,  -5,  1,  0],
    [0, 1,  -2,  4, 63,  -3,  1,  0]], dtype=np.int32)


def round_affine_mv(vx: int, vy: int, shift: int) -> Tuple[int, int]:
    """vvenc roundAffineMv (Mv.cpp:61)."""
    off = 1 << (shift - 1)
    return ((vx + off - (1 if vx >= 0 else 0)) >> shift,
            (vy + off - (1 if vy >= 0 else 0)) >> shift)


def _clip_stor(mv) -> Tuple[int, int]:
    return (max(STOR_MIN, min(STOR_MAX, mv[0])),
            max(STOR_MIN, min(STOR_MAX, mv[1])))


def round_mv_aff_amvr(mv, imv: int = 0) -> Tuple[int, int]:
    """roundAffinePrecInternal2Amvr (Mv.h:247)."""
    sh = AFF_AMVR_SHIFTS[imv]
    if sh == 0:
        return tuple(mv)
    off = 1 << (sh - 1)

    def r(v):
        v = (v + off - 1) >> sh if v >= 0 else (v + off) >> sh
        return v << sh
    return (r(mv[0]), r(mv[1]))


@dataclass(frozen=True)
class AffineInfo:
    """Stored per affine CU for neighbor CPMV inheritance."""
    x: int
    y: int
    w: int
    h: int
    aff_type: int                       # 0 = 4-param, 1 = 6-param
    cpmv: tuple                         # ((LT,RT,LB) L0, (LT,RT,LB) L1)
    inter_dir: int
    ref_idx: Tuple[int, int]
    bcw: int


@dataclass
class AffineMergeCand:
    inter_dir: int = 0
    aff_type: int = 0
    cpmv: tuple = (((0, 0),) * 3, ((0, 0),) * 3)
    ref_idx: Tuple[int, int] = (-1, -1)
    bcw: int = 2
    is_sbtmvp: bool = False
    sub_mi: Optional[list] = None       # per-8x8 MotionInfo grid (SbTMVP)


# ---------------------------------------------------------------------------
# control-point MV derivation
# ---------------------------------------------------------------------------

def _log2(v: int) -> int:
    return v.bit_length() - 1


def inherited_affine_mv(aff: AffineInfo, mf, ctu_size: int, cx: int, cy: int,
                        cw: int, ch: int, li: int, cur_6p: bool
                        ) -> List[Tuple[int, int]]:
    """CU::xInheritedAffineMv (UnitTools.cpp:1878): extrapolate the
    neighbor's CPMVs to the current CU's corners."""
    nx, ny, nw, nh = aff.x, aff.y, aff.w, aff.h
    mv_lt, mv_rt, mv_lb = aff.cpmv[li]
    top_ctu_boundary = False
    if (ny + nh) % ctu_size == 0 and (ny + nh) == cy:
        # inherit from the neighbor's bottom sub-block row (motion field)
        mi_lb = mf.at(nx, ny + nh - 1)
        mi_rb = mf.at(nx + nw - 1, ny + nh - 1)
        mv_lt = mi_lb.mv[li]
        mv_rt = mi_rb.mv[li]
        ny += nh
        top_ctu_boundary = True
    shift = MAX_CU_DEPTH
    dhx = (mv_rt[0] - mv_lt[0]) << (shift - _log2(nw))
    dhy = (mv_rt[1] - mv_lt[1]) << (shift - _log2(nw))
    if aff.aff_type == 1 and not top_ctu_boundary:
        dvx = (mv_lb[0] - mv_lt[0]) << (shift - _log2(nh))
        dvy = (mv_lb[1] - mv_lt[1]) << (shift - _log2(nh))
    else:
        dvx, dvy = -dhy, dhx
    base_x = mv_lt[0] << shift
    base_y = mv_lt[1] << shift

    def at(px, py):
        hx = base_x + dhx * (px - nx) + dvx * (py - ny)
        vy = base_y + dhy * (px - nx) + dvy * (py - ny)
        return _clip_stor(round_affine_mv(hx, vy, shift))
    out = [at(cx, cy), at(cx + cw, cy)]
    out.append(at(cx, cy + ch) if cur_6p else (0, 0))
    return out


def subblock_mv_grid(cpmv, x: int, y: int, w: int, h: int, aff_type: int,
                     inter_dir: int):
    """CU::setAllAffineMv / xPredAffineBlk MV grid: per-4x4 sub-block MVs
    (storage-clipped, before the MC range clamp).  Returns (nby, nbx, 2)."""
    lt, rt, lb = cpmv
    shift = MAX_CU_DEPTH
    same = lt == rt and (aff_type == 0 or rt == lb)
    nbx, nby = w // SB, h // SB
    out = np.zeros((nby, nbx, 2), np.int64)
    if same:
        out[:, :, 0] = lt[0]
        out[:, :, 1] = lt[1]
        return out, (0, 0, 0, 0), False
    dhx = (rt[0] - lt[0]) << (shift - _log2(w))
    dhy = (rt[1] - lt[1]) << (shift - _log2(w))
    if aff_type == 1:
        dvx = (lb[0] - lt[0]) << (shift - _log2(h))
        dvy = (lb[1] - lt[1]) << (shift - _log2(h))
    else:
        dvx, dvy = -dhy, dhx
    spread = is_spread_over_limit(dhx, dhy, dvx, dvy, inter_dir)
    base_x = lt[0] << shift
    base_y = lt[1] << shift
    half = SB >> 1
    for by in range(nby):
        for bx in range(nbx):
            if spread:
                hx = base_x + dhx * (w >> 1) + dvx * (h >> 1)
                vy = base_y + dhy * (w >> 1) + dvy * (h >> 1)
            else:
                hx = base_x + dhx * (half + bx * SB) + dvx * (half + by * SB)
                vy = base_y + dhy * (half + bx * SB) + dvy * (half + by * SB)
            out[by, bx] = _clip_stor(round_affine_mv(hx, vy, shift))
    return out, (dhx, dhy, dvx, dvy), spread


def is_spread_over_limit(a, b, c, d, inter_dir) -> bool:
    """InterPredInterpolation::isSubblockVectorSpreadOverLimit (:1457)."""
    s4 = 4 << 11
    ft = 6
    if inter_dir == 3:
        rw = max(0, 4 * a + s4, 4 * c, 4 * a + 4 * c + s4) \
            - min(0, 4 * a + s4, 4 * c, 4 * a + 4 * c + s4)
        rh = max(0, 4 * b, 4 * d + s4, 4 * b + 4 * d + s4) \
            - min(0, 4 * b, 4 * d + s4, 4 * b + 4 * d + s4)
        rw = (rw >> 11) + ft + 3
        rh = (rh >> 11) + ft + 3
        return rw * rh > (ft + 9) * (ft + 9)
    rw = max(0, 4 * a + s4) - min(0, 4 * a + s4)
    rh = max(0, 4 * b) - min(0, 4 * b)
    if ((rw >> 11) + ft + 3) * ((rh >> 11) + ft + 3) > (ft + 9) * (ft + 5):
        return True
    rw = max(0, 4 * c) - min(0, 4 * c)
    rh = max(0, 4 * d + s4) - min(0, 4 * d + s4)
    return ((rw >> 11) + ft + 3) * ((rh >> 11) + ft + 3) > \
        (ft + 5) * (ft + 9)


# ---------------------------------------------------------------------------
# affine AMVP (fillAffineMvpCand)
# ---------------------------------------------------------------------------

_DIR_OFF = {
    "left": (-1, 0), "above": (0, -1), "above_right": (1, -1),
    "below_left": (-1, 1), "above_left": (-1, -1),
}


def _affine_nb(coder, ps, px, py):
    """Available affine neighbor (AffineInfo) at position, or None."""
    if not ps.is_coded(px, py):
        return None
    return coder.mf.aff_at(px, py)


def _add_affine_amvp_unscaled(coder, ps, cu, li, ref_idx, pos, d, out):
    px, py = pos[0] + _DIR_OFF[d][0], pos[1] + _DIR_OFF[d][1]
    aff = _affine_nb(coder, ps, px, py)
    if aff is None:
        return False
    cur_poc = coder.ref_pocs[li][ref_idx]
    for src in (li, 1 - li):
        if not (aff.inter_dir & (src + 1)):
            continue
        r = aff.ref_idx[src]
        if r < 0 or r >= len(coder.ref_pocs[src]) or \
                coder.ref_pocs[src][r] != cur_poc:
            continue
        mvs = inherited_affine_mv(aff, coder.mf, coder.ctu_size, cu.x, cu.y,
                                  cu.w, cu.h, src, cu.affine_type == 1)
        out.append([round_mv_aff_amvr(m, cu.imv) for m in mvs])
        return True
    return False


def _mvp_cand_unscaled(coder, ps, cu, li, ref_idx, pos, d):
    """CU::addMVPCandUnscaled analog returning a single MV or None."""
    px, py = pos[0] + _DIR_OFF[d][0], pos[1] + _DIR_OFF[d][1]
    mi = _avail_inter(ps, coder.mf, px, py)
    if mi is None:
        return None
    cur_poc = coder.ref_pocs[li][ref_idx]
    for src in (li, 1 - li):
        r = mi.ref_idx[src]
        if r >= 0 and r < len(coder.ref_pocs[src]) and \
                coder.ref_pocs[src][r] == cur_poc:
            return mi.mv[src]
    return None


def affine_amvp_list(coder, ps, cu, li: int, ref_idx: int) -> List[list]:
    """fillAffineMvpCand (UnitTools.cpp:1955) -> 2 CPMV triples."""
    cands: List[list] = []
    lt = (cu.x, cu.y)
    rt = (cu.x + cu.w - 1, cu.y)
    lb = (cu.x, cu.y + cu.h - 1)
    # inherited: left group then above group
    if not _add_affine_amvp_unscaled(coder, ps, cu, li, ref_idx, lb,
                                     "below_left", cands):
        _add_affine_amvp_unscaled(coder, ps, cu, li, ref_idx, lb, "left",
                                  cands)
    if not _add_affine_amvp_unscaled(coder, ps, cu, li, ref_idx, rt,
                                     "above_right", cands):
        if not _add_affine_amvp_unscaled(coder, ps, cu, li, ref_idx, rt,
                                         "above", cands):
            _add_affine_amvp_unscaled(coder, ps, cu, li, ref_idx, lt,
                                      "above_left", cands)
    if len(cands) >= 2:
        return cands[:2]
    # constructed from per-corner translational neighbors
    v0 = None
    for d in ("above_left", "above", "left"):
        v0 = _mvp_cand_unscaled(coder, ps, cu, li, ref_idx, lt, d)
        if v0 is not None:
            break
    v1 = None
    for d in ("above", "above_right"):
        v1 = _mvp_cand_unscaled(coder, ps, cu, li, ref_idx, rt, d)
        if v1 is not None:
            break
    v2 = None
    for d in ("left", "below_left"):
        v2 = _mvp_cand_unscaled(coder, ps, cu, li, ref_idx, lb, d)
        if v2 is not None:
            break
    pattern = (1 if v0 is not None else 0) | (2 if v1 is not None else 0) \
        | (4 if v2 is not None else 0)
    out = [round_mv_aff_amvr(v, cu.imv) if v is not None else (0, 0)
           for v in (v0, v1, v2)]
    if pattern == 7 or (pattern == 3 and cu.affine_type == 0):
        cands.append(list(out))
    if len(cands) < 2:
        for i in (2, 1, 0):
            if len(cands) >= 2:
                break
            if pattern & (1 << i):
                cands.append([out[i], out[i], out[i]])
        # TMVP fallback
        if len(cands) < 2 and coder.tmvp is not None:
            from .motion import _tmvp_c0_c1
            c0, c1 = _tmvp_c0_c1(coder.tmvp, cu.x, cu.y, cu.w, cu.h)
            mv = None
            if c0 is not None:
                mv = get_colocated_mvp(coder.tmvp, li, c0, ref_idx)
            if mv is None:
                mv = get_colocated_mvp(coder.tmvp, li, c1, ref_idx)
            if mv is not None:
                m = round_mv_aff_amvr(mv, cu.imv)
                cands.append([m, m, m])
        while len(cands) < 2:
            cands.append([(0, 0), (0, 0), (0, 0)])
    return cands[:2]


# ---------------------------------------------------------------------------
# affine merge (getAffineMergeCand) + SbTMVP
# ---------------------------------------------------------------------------

def _clip_col_pos(px, py, cu, ctu_size, pic_w, pic_h):
    """clipColPos (UnitTools.cpp:2988)."""
    ctu_x = (cu.x >> _log2(ctu_size)) << _log2(ctu_size)
    ctu_y = (cu.y >> _log2(ctu_size)) << _log2(ctu_size)
    hor_max = min(pic_w - 1, ctu_x + ctu_size + 3)
    ver_max = min(pic_h - 1, ctu_y + ctu_size - 1)
    return (min(hor_max, max(ctu_x, px)), min(ver_max, max(ctu_y, py)))


def sbtmvp_candidate(coder, ps, cu, first_mi: Optional[MotionInfo]):
    """CU::getInterMergeSbTMVPCand (UnitTools.cpp:2374).

    first_mi: the A1 spatial candidate (or None).  Returns (ctr_list of
    (mv, ref) per list as a MotionInfo, sub_mi 8x8 grid) or None."""
    tmvp = coder.tmvp
    if tmvp is None:
        return None
    col_poc = tmvp.col_poc
    tmv = (0, 0)
    if first_mi is not None:
        r0 = first_mi.ref_idx[0]
        if r0 >= 0 and coder.ref_pocs[0][r0] == col_poc:
            tmv = first_mi.mv[0]
        elif coder.is_b:
            r1 = first_mi.ref_idx[1]
            if r1 >= 0 and coder.ref_pocs[1][r1] == col_poc:
                tmv = first_mi.mv[1]
    # integer temporal vector
    tix = (tmv[0] + (8 - (1 if tmv[0] >= 0 else 0))) >> 4
    tiy = (tmv[1] + (8 - (1 if tmv[1] >= 0 else 0))) >> 4
    mask = ~7
    n_lists = 2 if coder.is_b else 1
    cx = cu.x + (cu.w >> 1) + tix
    cy = cu.y + (cu.h >> 1) + tiy
    cx, cy = _clip_col_pos(cx, cy, cu, coder.ctu_size, ps.w, ps.h)
    cx &= mask
    cy &= mask
    ctr_mi = tmvp.col_mf.at(cx, cy)
    if ctr_mi is None:
        return None
    ctr_mv = [None, None]
    for li in range(n_lists):
        mv = get_colocated_mvp(tmvp, li, (cx, cy), 0, sb_flag=True)
        ctr_mv[li] = mv
    if ctr_mv[0] is None and ctr_mv[1] is None:
        return None
    ctr = MotionInfo(
        (tuple(ctr_mv[0] or (0, 0)), tuple(ctr_mv[1] or (0, 0))),
        (0 if ctr_mv[0] is not None else -1,
         0 if ctr_mv[1] is not None else -1))
    # sub-block motion (8x8 grid)
    pw = ATMVP_SB if cu.w > ATMVP_SB else cu.w
    ph = ATMVP_SB if cu.h > ATMVP_SB else cu.h
    x_off = (pw >> 1) + tix
    y_off = (ph >> 1) + tiy
    nbx = max(1, cu.w // pw)
    nby = max(1, cu.h // ph)
    grid = [[None] * nbx for _ in range(nby)]
    restricted = cu.w + cu.h == 12
    for by in range(nby):
        for bx in range(nbx):
            px = cu.x + bx * pw + x_off
            py = cu.y + by * ph + y_off
            px, py = _clip_col_pos(px, py, cu, coder.ctu_size, ps.w, ps.h)
            px &= mask
            py &= mask
            col = tmvp.col_mf.at(px, py)
            mv = [None, None]
            if col is not None:
                for li in range(n_lists):
                    mv[li] = get_colocated_mvp(tmvp, li, (px, py), 0,
                                               sb_flag=True)
            if mv[0] is None and mv[1] is None:
                mi = ctr
            else:
                mi = MotionInfo(
                    (tuple(mv[0] or (0, 0)), tuple(mv[1] or (0, 0))),
                    (0 if mv[0] is not None else -1,
                     0 if mv[1] is not None else -1))
            if restricted and mi.inter_dir == 3:
                mi = MotionInfo((mi.mv[0], (0, 0)), (mi.ref_idx[0], -1))
            grid[by][bx] = mi
    return ctr, grid, (pw, ph)


def _ctrl_point_cand(cu, mi, avail, ver_idx, bcw, model_idx, ver_num,
                     is_b, out):
    """CU::getAffineControlPointCand (UnitTools.cpp:2234)."""
    shift = MAX_CU_DEPTH
    shift_htow = shift + _log2(cu.w) - _log2(cu.h)
    ref_idx = [-1, -1]
    direction = 0
    idxs = ver_idx[:ver_num]
    if any(not avail[i] for i in idxs):
        return
    for li in range(2):
        rs = [mi[i].ref_idx[li] for i in idxs]
        if all(r >= 0 for r in rs) and all(r == rs[0] for r in rs):
            direction |= li + 1
            ref_idx[li] = rs[0]
    if direction == 0:
        return
    cmv = [[(0, 0)] * 4 for _ in range(2)]
    for li in range(2):
        if not (direction & (li + 1)):
            continue
        for i in idxs:
            cmv[li][i] = mi[i].mv[li]
        m = cmv[li]
        if model_idx == 1:    # LT, RT, RB -> LB
            m[2] = _clip_stor((m[3][0] + m[0][0] - m[1][0],
                               m[3][1] + m[0][1] - m[1][1]))
        elif model_idx == 2:  # LT, LB, RB -> RT
            m[1] = _clip_stor((m[3][0] + m[0][0] - m[2][0],
                               m[3][1] + m[0][1] - m[2][1]))
        elif model_idx == 3:  # RT, LB, RB -> LT
            m[0] = _clip_stor((m[1][0] + m[2][0] - m[3][0],
                               m[1][1] + m[2][1] - m[3][1]))
        elif model_idx == 5:  # LT, LB -> RT
            vx = (m[0][0] << shift) + ((m[2][1] - m[0][1]) << shift_htow)
            vy = (m[0][1] << shift) - ((m[2][0] - m[0][0]) << shift_htow)
            m[1] = _clip_stor(round_affine_mv(vx, vy, shift))
    cand = AffineMergeCand(
        inter_dir=direction,
        aff_type=0 if ver_num == 2 else 1,
        cpmv=(tuple(cmv[0][:3]), tuple(cmv[1][:3])),
        ref_idx=(ref_idx[0], ref_idx[1]),
        bcw=bcw if direction == 3 else 2)
    out.append(cand)


def affine_merge_list(coder, ps, cu, max_cands: int, mrg_idx: int = -1
                      ) -> List[AffineMergeCand]:
    """CU::getAffineMergeCand (UnitTools.cpp:2587)."""
    cands: List[AffineMergeCand] = []
    mf = coder.mf
    lb = (cu.x, cu.y + cu.h - 1)
    lt = (cu.x, cu.y)
    rt = (cu.x + cu.w - 1, cu.y)

    def done():
        return len(cands) >= max_cands or \
            (mrg_idx >= 0 and len(cands) > mrg_idx)

    # SbTMVP candidate first
    if coder.sbtmvp_active:
        mi_a1 = _avail_inter(ps, mf, lb[0] - 1, lb[1])
        res = sbtmvp_candidate(coder, ps, cu, mi_a1)
        if res is not None:
            ctr, grid, sbsz = res
            cands.append(AffineMergeCand(
                inter_dir=ctr.inter_dir, aff_type=2,
                cpmv=((ctr.mv[0],) * 3, (ctr.mv[1],) * 3),
                ref_idx=ctr.ref_idx, is_sbtmvp=True, sub_mi=(grid, sbsz)))
            if done():
                return cands
    if coder.affine_en:
        # inherited: one from the left group, one from the above group
        nbs = []
        for px, py in ((lb[0] - 1, lb[1] + 1), (lb[0] - 1, lb[1])):
            aff = _affine_nb(coder, ps, px, py)
            if aff is not None:
                nbs.append(aff)
                break
        for px, py in ((rt[0] + 1, rt[1] - 1), (rt[0], rt[1] - 1),
                       (lt[0] - 1, lt[1] - 1)):
            aff = _affine_nb(coder, ps, px, py)
            if aff is not None:
                nbs.append(aff)
                break
        for aff in nbs:
            cp = [((0, 0),) * 3, ((0, 0),) * 3]
            for li in range(2):
                use = (aff.inter_dir != 2) if li == 0 else \
                    (coder.is_b and aff.inter_dir != 1)
                if use:
                    cp[li] = tuple(inherited_affine_mv(
                        aff, mf, coder.ctu_size, cu.x, cu.y, cu.w, cu.h,
                        li, aff.aff_type == 1))
            cands.append(AffineMergeCand(
                inter_dir=aff.inter_dir, aff_type=aff.aff_type,
                cpmv=(cp[0], cp[1]), ref_idx=aff.ref_idx, bcw=aff.bcw))
            if done():
                return cands
        # constructed candidates from corner motion
        none_mi = MotionInfo()
        mi = [none_mi] * 4
        avail = [False] * 4
        nb_bcw = [2, 2]
        for d, px, py in (("b2", lt[0] - 1, lt[1] - 1),
                          ("b3", lt[0], lt[1] - 1),
                          ("a2", lt[0] - 1, lt[1])):
            m = _avail_inter(ps, mf, px, py)
            if m is not None:
                avail[0] = True
                mi[0] = m
                nb_bcw[0] = m.bcw
                break
        for d, px, py in (("b1", rt[0], rt[1] - 1),
                          ("b0", rt[0] + 1, rt[1] - 1)):
            m = _avail_inter(ps, mf, px, py)
            if m is not None:
                avail[1] = True
                mi[1] = m
                nb_bcw[1] = m.bcw
                break
        for d, px, py in (("a1", lb[0] - 1, lb[1]),
                          ("a0", lb[0] - 1, lb[1] + 1)):
            m = _avail_inter(ps, mf, px, py)
            if m is not None:
                avail[2] = True
                mi[2] = m
                break
        if coder.tmvp is not None:
            rbx, rby = cu.x + cu.w - 4, cu.y + cu.h - 4
            if rbx + 4 < ps.w and rby + 4 < ps.h and \
                    (rby & (coder.ctu_size - 1)) + 4 < coder.ctu_size:
                mv = [None, None]
                mv[0] = get_colocated_mvp(coder.tmvp, 0, (rbx + 4, rby + 4),
                                          0)
                if coder.is_b:
                    mv[1] = get_colocated_mvp(coder.tmvp, 1,
                                              (rbx + 4, rby + 4), 0)
                if mv[0] is not None or mv[1] is not None:
                    avail[3] = True
                    mi[3] = MotionInfo(
                        (tuple(mv[0] or (0, 0)), tuple(mv[1] or (0, 0))),
                        (0 if mv[0] is not None else -1,
                         0 if mv[1] is not None else -1))
        model = ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3), (0, 1), (0, 2))
        ver_num = (3, 3, 3, 3, 2, 2)
        start = 0 if coder.affine_type_en else 4
        for m_idx in range(start, 6):
            _ctrl_point_cand(cu, mi, avail, list(model[m_idx]) + [0],
                             nb_bcw[1] if m_idx == 3 else nb_bcw[0],
                             m_idx, ver_num[m_idx], coder.is_b, cands)
            if done():
                return cands
    # zero padding
    while len(cands) < max_cands:
        if coder.is_b:
            cands.append(AffineMergeCand(
                inter_dir=3, cpmv=(((0, 0),) * 3, ((0, 0),) * 3),
                ref_idx=(0, 0)))
        else:
            cands.append(AffineMergeCand(
                inter_dir=1, cpmv=(((0, 0),) * 3, ((0, 0),) * 3),
                ref_idx=(0, -1)))
        if done():
            break
    return cands


# ---------------------------------------------------------------------------
# motion compensation (xPredAffineBlk) + PROF
# ---------------------------------------------------------------------------

def _mc_sub(ref, px, py, bw, bh, mvx, mvy, bit_depth, is_luma, intermediate,
            affine_luma):
    return mc_block_np(ref, px, py, bw, bh, mvx, mvy, bit_depth,
                       is_luma=is_luma, intermediate=intermediate,
                       taps_override=AFFINE_LUMA_FILTER
                       if (is_luma and affine_luma) else None)


def _prof_dmv_grid(dhx, dhy, dvx, dvy):
    """Per-pixel dMv of a 4x4 sub-block (xPredAffineBlk:1583-1630)."""
    qhx, qhy = 4 * dhx, 4 * dhy
    qvx, qvy = 4 * dvx, 4 * dvy
    dmx = np.zeros((SB, SB), np.int64)
    dmy = np.zeros((SB, SB), np.int64)
    dmx[0, 0] = ((dhx + dvx) * 2) - ((qhx + qvx) * 2)
    dmy[0, 0] = ((dhy + dvy) * 2) - ((qhy + qvy) * 2)
    for w in range(1, SB):
        dmx[0, w] = dmx[0, w - 1] + qhx
        dmy[0, w] = dmy[0, w - 1] + qhy
    for h in range(1, SB):
        dmx[h] = dmx[h - 1] + qvx
        dmy[h] = dmy[h - 1] + qvy
    # round shift 8, clip +-31
    off = 1 << 7
    dmx = (dmx + off - (dmx >= 0)) >> 8
    dmy = (dmy + off - (dmy >= 0)) >> 8
    return np.clip(dmx, -31, 31), np.clip(dmy, -31, 31)


def _ref_int_window(ref, x0, y0, w, h):
    """Integer reference window with edge replication."""
    ph, pw = ref.shape
    xs = np.clip(np.arange(x0, x0 + w), 0, pw - 1)
    ys = np.clip(np.arange(y0, y0 + h), 0, ph - 1)
    return ref[np.ix_(ys, xs)].astype(np.int64)


def affine_predict_list(coder, cu, li: int, comp: int, intermediate: bool):
    """Affine MC of one list/component (xPredAffineBlk:1497)."""
    ref = coder.ref_pics[li][cu.ref_idx[li]][comp]
    bd = coder.bit_depth
    sc = 0 if comp == 0 else 1
    grid = cu.aff_grids[li]              # (nby, nbx, 2) storage MVs
    dhv = cu.aff_dhv[li]
    spread = cu.aff_spread[li]
    # MC MV range clamp (xPredAffineBlk:1544-1548)
    hor_max = (coder.pic_w + 8 - cu.x - 1) << 4
    hor_min = (-coder.ctu_size - 8 - cu.x + 1) << 4
    ver_max = (coder.pic_h + 8 - cu.y - 1) << 4
    ver_min = (-coder.ctu_size - 8 - cu.y + 1) << 4
    cw, ch = cu.w >> sc, cu.h >> sc
    enable_prof = (comp == 0 and coder.prof_en
                   and not cu.sbtmvp
                   and not (cu.cpmv[li][0] == cu.cpmv[li][1]
                            and (cu.affine_type == 0
                                 or cu.cpmv[li][0] == cu.cpmv[li][2]))
                   and not spread)
    is_last = (not intermediate) and not enable_prof
    out = np.zeros((ch, cw), np.int32 if is_last else np.int64)
    if enable_prof:
        dmx, dmy = _prof_dmv_grid(*dhv)
        shift_num = max(2, IF_INTERNAL_PREC - bd)
        prof_off = (1 << (shift_num - 1)) + IF_INTERNAL_OFFS
        di_lim = 1 << max(bd + 1, 13)
        maxval = (1 << bd) - 1
    for by in range(0, ch, SB):
        for bx in range(0, cw, SB):
            if comp == 0:
                mvx, mvy = int(grid[by >> 2, bx >> 2, 0]), \
                    int(grid[by >> 2, bx >> 2, 1])
            else:
                a = grid[(by >> 1), (bx >> 1)]
                b = grid[(by >> 1) + 1, (bx >> 1) + 1]
                mvx, mvy = round_affine_mv(int(a[0] + b[0]),
                                           int(a[1] + b[1]), 1)
            mvx = max(hor_min, min(hor_max, mvx))
            mvy = max(ver_min, min(ver_max, mvy))
            px, py = (cu.x >> sc) + bx, (cu.y >> sc) + by
            pred = _mc_sub(ref, px, py, SB, SB, mvx, mvy, bd,
                           comp == 0, intermediate or enable_prof,
                           affine_luma=True)
            if enable_prof:
                fx, fy = mvx & 15, mvy & 15
                xo, yo = fx >> 3, fy >> 3
                xi, yi = px + (mvx >> 4), py + (mvy >> 4)
                # 6x6 buffer: MC core + integer-sample border
                sh = shift_num
                ext = np.zeros((SB + 2, SB + 2), np.int64)
                ext[1:SB + 1, 1:SB + 1] = pred
                top = _ref_int_window(ref, xi + xo - 1, yi + yo - 1,
                                      SB + 2, 1)[0]
                bot = _ref_int_window(ref, xi + xo - 1, yi + yo + SB,
                                      SB + 2, 1)[0]
                ext[0, :] = (top << sh) - IF_INTERNAL_OFFS
                ext[SB + 1, :] = (bot << sh) - IF_INTERNAL_OFFS
                lef = _ref_int_window(ref, xi + xo - 1, yi + yo, 1,
                                      SB)[:, 0]
                rig = _ref_int_window(ref, xi + xo + SB, yi + yo, 1,
                                      SB)[:, 0]
                ext[1:SB + 1, 0] = (lef << sh) - IF_INTERNAL_OFFS
                ext[1:SB + 1, SB + 1] = (rig << sh) - IF_INTERNAL_OFFS
                gx = (ext[1:SB + 1, 2:] >> 6) - (ext[1:SB + 1, :SB] >> 6)
                gy = (ext[2:, 1:SB + 1] >> 6) - (ext[:SB, 1:SB + 1] >> 6)
                di = np.clip(dmx * gx + dmy * gy, -di_lim, di_lim - 1)
                refined = pred + di
                if not intermediate:
                    refined = np.clip((refined + prof_off) >> shift_num,
                                      0, maxval)
                pred = refined
            out[by:by + SB, bx:bx + SB] = pred
    return out.astype(np.int32)


def sbtmvp_predict(coder, cu, comp: int) -> np.ndarray:
    """SbTMVP MC: per-8x8 sub-block translational prediction."""
    bd = coder.bit_depth
    sc = 0 if comp == 0 else 1
    grid, (pw, ph) = cu.sub_mi_src
    out = np.zeros((cu.h >> sc, cu.w >> sc), np.int32)
    for by, row in enumerate(grid):
        for bx, mi in enumerate(row):
            x = cu.x + bx * pw
            y = cu.y + by * ph
            from .ctu_syntax import inter_predict
            blk = inter_predict(coder.ref_pics, mi.mv, mi.ref_idx,
                                x >> sc, y >> sc, pw >> sc, ph >> sc,
                                comp, bd)
            out[(by * ph) >> sc:((by + 1) * ph) >> sc,
                (bx * pw) >> sc:((bx + 1) * pw) >> sc] = blk
    return out


def affine_predict(coder, cu, comp: int) -> np.ndarray:
    """Full affine CU prediction for one component (uni/bi + BCW)."""
    if cu.sbtmvp:
        return sbtmvp_predict(coder, cu, comp)
    bd = coder.bit_depth
    bi = cu.ref_idx[0] >= 0 and cu.ref_idx[1] >= 0
    if bi:
        a = affine_predict_list(coder, cu, 0, comp, intermediate=True)
        b = affine_predict_list(coder, cu, 1, comp, intermediate=True)
        if cu.bcw_idx != 2:
            return bcw_average_np(a, b, cu.bcw_idx, bd)
        return bi_average_np(a, b, bd)
    li = 0 if cu.ref_idx[0] >= 0 else 1
    return affine_predict_list(coder, cu, li, comp, intermediate=False)


def derive_affine_grids(coder, cu) -> None:
    """Compute + cache the per-4x4 sub-block MV grids for both lists and
    build the CU's motion-field entries (setAllAffineMv:2904)."""
    grids = [None, None]
    dhvs = [None, None]
    spreads = [False, False]
    for li in range(2):
        if cu.ref_idx[li] < 0:
            continue
        g, dhv, spread = subblock_mv_grid(
            cu.cpmv[li], cu.x, cu.y, cu.w, cu.h, cu.affine_type,
            cu.inter_dir)
        grids[li], dhvs[li], spreads[li] = g, dhv, spread
    cu.aff_grids = grids
    cu.aff_dhv = dhvs
    cu.aff_spread = spreads
    # per-4x4 MotionInfo grid for the motion field / deblocking
    nbx, nby = cu.w // SB, cu.h // SB
    sub = []
    for by in range(nby):
        row = []
        for bx in range(nbx):
            mv = [(0, 0), (0, 0)]
            for li in range(2):
                if grids[li] is not None:
                    mv[li] = (int(grids[li][by, bx, 0]),
                              int(grids[li][by, bx, 1]))
            row.append(MotionInfo((tuple(mv[0]), tuple(mv[1])),
                                  tuple(cu.ref_idx), bcw=cu.bcw_idx))
        sub.append(row)
    cu.sub_mi = sub

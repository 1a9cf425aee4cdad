"""Motion vector prediction: merge list, AMVP, HMVP (H.266 8.5.2).

Behavioral reference: vvenc CommonLib/UnitTools.cpp
(getInterMergeCandidates:905, fillMvpCand:1692, addMVPCandUnscaled:2129,
addAMVPHMVPCand:2185, addMergeHMVPCand:760, saveMotionInHMVP:352),
CodingStructure::addMiToLut (CodingStructure.cpp:609), Mv precision helpers
(Mv.h:150-235).

MVs are stored at the internal 1/16-pel precision.  Round-1 inter scope:
translational uni/bi prediction, TMVP/SbTMVP off (SPS flags), no IBC.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

MAX_NUM_HMVP_CANDS = 5   # MRG_MAX_NUM_CANDS(6) - 1
MAX_NUM_HMVP_AMVP_CANDS = 4
AMVP_MAX_NUM_CANDS = 2
MV_FRACTIONAL_BITS_INTERNAL = 4


@dataclass(frozen=True)
class MotionInfo:
    """Uni/bi motion of a block: per-list (mv, ref_idx); ref_idx -1 = unused.
    bcw: bi-prediction weight index (BCW_DEFAULT=2); alt_hpel: the block
    used the alternative half-pel interpolation filter (AMVR half mode)."""
    mv: Tuple[Tuple[int, int], Tuple[int, int]] = ((0, 0), (0, 0))
    ref_idx: Tuple[int, int] = (-1, -1)
    bcw: int = 2
    alt_hpel: bool = False

    @property
    def inter_dir(self) -> int:
        return (1 if self.ref_idx[0] >= 0 else 0) | \
               (2 if self.ref_idx[1] >= 0 else 0)


def same_motion(a: Optional["MotionInfo"], b: Optional["MotionInfo"]) -> bool:
    """Motion equality for candidate pruning: refIdx + mv only (vvenc
    MotionInfo::operator==, MotionInfo.h:115 — BcwIdx/altHpel excluded)."""
    if a is None or b is None:
        return a is b
    for li in range(2):
        if a.ref_idx[li] != b.ref_idx[li]:
            return False
        if a.ref_idx[li] >= 0 and a.mv[li] != b.mv[li]:
            return False
    return True


AMVR_SHIFTS = (2, 4, 6, 3)  # imv 0=quarter, 1=int, 2=4pel, 3=half


def round_mv_amvr(mv: Tuple[int, int], imv: int = 0) -> Tuple[int, int]:
    """roundTransPrecInternal2Amvr: round 1/16 MV to the AMVR precision
    and back (Mv.h:222 via changePrecision, asymmetric >=0 offset)."""
    sh = AMVR_SHIFTS[imv]
    off = 1 << (sh - 1)

    def r(v):
        v = (v + off - 1) >> sh if v >= 0 else (v + off) >> sh
        return v << sh
    return (r(mv[0]), r(mv[1]))


def round_mv_quarter(mv: Tuple[int, int]) -> Tuple[int, int]:
    return round_mv_amvr(mv, 0)


def round_pairwise(v: int) -> int:
    """roundAffineMv with shift 1 (Mv.cpp:61)."""
    return (v + 1 - (1 if v >= 0 else 0)) >> 1


class HmvpLut:
    """History-based MVP FIFO (reset at each CTU row start)."""

    def __init__(self):
        self.lut: List[MotionInfo] = []

    def reset(self):
        self.lut.clear()

    def add(self, mi: MotionInfo):
        pruned_idx = -1
        for i, e in enumerate(self.lut):
            if same_motion(e, mi):
                pruned_idx = i
                break
        if pruned_idx >= 0 or len(self.lut) == MAX_NUM_HMVP_CANDS:
            self.lut.pop(max(pruned_idx, 0))
        self.lut.append(mi)


class MotionField:
    """Per-4x4-unit motion storage on the current picture.

    Array-backed (numpy) so the native C++ CTU search reads/writes the
    SAME storage zero-copy (the reference keeps its motion buffer as
    flat arrays too — CodingStructure m_motionBuf, CodingStructure.h).
    `at()` materializes MotionInfo views on demand."""

    def __init__(self, w: int, h: int):
        self.uw, self.uh = w // 4, h // 4
        sh = (self.uh, self.uw)
        self.valid = np.zeros(sh, np.uint8)
        self.mv = np.zeros(sh + (2, 2), np.int32)      # [..., list, x/y]
        self.ref = np.full(sh + (2,), -1, np.int8)
        self.bcw = np.full(sh, 2, np.int8)
        self.alt = np.zeros(sh, np.uint8)
        self.skipf = np.zeros(sh, np.uint8)
        self.isaff = np.zeros(sh, np.uint8)
        # affine state: per-unit AffineInfo (CPMV inheritance source, real
        # affine CUs only); IBC block vectors (internal 1/16) or None
        self.aff = np.empty(sh, object)
        self.ibc = np.empty(sh, object)
        # numeric mirror of `aff` for the native searcher:
        # [x y w h type cpmv_l0(6) cpmv_l1(6) dir ref0 ref1 bcw]
        self.aff_valid = np.zeros(sh, np.uint8)
        self.aff_data = np.zeros(sh + (21,), np.int32)

    def _mi_at_unit(self, uy: int, ux: int) -> Optional[MotionInfo]:
        if not self.valid[uy, ux]:
            return None
        m = self.mv[uy, ux]
        r = self.ref[uy, ux]
        return MotionInfo(
            ((int(m[0, 0]), int(m[0, 1])), (int(m[1, 0]), int(m[1, 1]))),
            (int(r[0]), int(r[1])), bcw=int(self.bcw[uy, ux]),
            alt_hpel=bool(self.alt[uy, ux]))

    def set_unit_mi(self, ux: int, uy: int, mi: Optional[MotionInfo]):
        """Write one 4x4 unit's motion (DMVR mf refinement)."""
        if mi is None:
            self.valid[uy, ux] = 0
            return
        self.valid[uy, ux] = 1
        self.mv[uy, ux, 0] = mi.mv[0]
        self.mv[uy, ux, 1] = mi.mv[1]
        self.ref[uy, ux] = mi.ref_idx
        self.bcw[uy, ux] = mi.bcw
        self.alt[uy, ux] = 1 if mi.alt_hpel else 0

    def set_cu(self, x, y, w, h, mi: Optional[MotionInfo], skip=False,
               ibc_bv=None):
        uy0, uy1 = y >> 2, (y + h) >> 2
        ux0, ux1 = x >> 2, (x + w) >> 2
        s = np.s_[uy0:uy1, ux0:ux1]
        if mi is None:
            self.valid[s] = 0
        else:
            self.valid[s] = 1
            self.mv[uy0:uy1, ux0:ux1, 0] = mi.mv[0]
            self.mv[uy0:uy1, ux0:ux1, 1] = mi.mv[1]
            self.ref[s] = mi.ref_idx
            self.bcw[s] = mi.bcw
            self.alt[s] = 1 if mi.alt_hpel else 0
        self.skipf[s] = 1 if skip else 0
        self.isaff[s] = 0
        self.aff[s] = None
        self.aff_valid[s] = 0
        self.ibc[s] = None
        if ibc_bv is not None:
            for uy in range(uy0, uy1):
                for ux in range(ux0, ux1):
                    self.ibc[uy, ux] = ibc_bv

    def set_sub_cu(self, x, y, w, h, sub_mi, skip=False,
                   aff_info=None, is_aff=True) -> None:
        """Per-4x4 sub-block motion of an affine/SbTMVP/GEO CU (sub_mi
        indexed [uy][ux] relative to the CU, one entry per 4x4)."""
        uy0, ux0 = y >> 2, x >> 2
        row = None
        if aff_info is not None:
            a = aff_info
            row = np.asarray(
                [a.x, a.y, a.w, a.h, a.aff_type]
                + [c for li in range(2) for cp in a.cpmv[li] for c in cp]
                + [a.inter_dir, a.ref_idx[0], a.ref_idx[1], a.bcw],
                np.int32)
        for uy in range(uy0, (y + h) >> 2):
            for ux in range(ux0, (x + w) >> 2):
                mi = sub_mi[uy - uy0][ux - ux0]
                self.set_unit_mi(ux, uy, mi)
                self.skipf[uy, ux] = 1 if skip else 0
                self.aff[uy, ux] = aff_info
                if row is None:
                    self.aff_valid[uy, ux] = 0
                else:
                    self.aff_valid[uy, ux] = 1
                    self.aff_data[uy, ux] = row
                self.isaff[uy, ux] = 1 if is_aff else 0
                self.ibc[uy, ux] = None

    def at(self, x, y) -> Optional[MotionInfo]:
        if x < 0 or y < 0 or x >= self.uw * 4 or y >= self.uh * 4:
            return None
        return self._mi_at_unit(y >> 2, x >> 2)

    def aff_at(self, x, y):
        if x < 0 or y < 0 or x >= self.uw * 4 or y >= self.uh * 4:
            return None
        return self.aff[y >> 2, x >> 2]

    def ibc_at(self, x, y):
        if x < 0 or y < 0 or x >= self.uw * 4 or y >= self.uh * 4:
            return None
        return self.ibc[y >> 2, x >> 2]

    def is_aff_at(self, x, y) -> bool:
        if x < 0 or y < 0 or x >= self.uw * 4 or y >= self.uh * 4:
            return False
        return bool(self.isaff[y >> 2, x >> 2])

    def skip_at(self, x, y) -> bool:
        if x < 0 or y < 0 or x >= self.uw * 4 or y >= self.uh * 4:
            return False
        return bool(self.skipf[y >> 2, x >> 2])

    def save_region(self, x, y, size):
        ux0, uy0 = x >> 2, y >> 2
        ux1 = min(self.uw, (x + size) >> 2)
        uy1 = min(self.uh, (y + size) >> 2)
        s = np.s_[uy0:uy1, ux0:ux1]
        return (ux0, uy0, ux1, uy1,
                self.valid[s].copy(), self.mv[s].copy(),
                self.ref[s].copy(), self.bcw[s].copy(),
                self.alt[s].copy(), self.skipf[s].copy(),
                self.isaff[s].copy(), self.aff[s].copy(),
                self.ibc[s].copy(), self.aff_valid[s].copy(),
                self.aff_data[s].copy())

    def restore_region(self, snap):
        (ux0, uy0, ux1, uy1, valid, mv, ref, bcw, alt, skipf, isaff,
         aff, ibc, aff_valid, aff_data) = snap
        s = np.s_[uy0:uy1, ux0:ux1]
        self.valid[s] = valid
        self.mv[s] = mv
        self.ref[s] = ref
        self.bcw[s] = bcw
        self.alt[s] = alt
        self.skipf[s] = skipf
        self.isaff[s] = isaff
        self.aff[s] = aff
        self.ibc[s] = ibc
        self.aff_valid[s] = aff_valid
        self.aff_data[s] = aff_data


def _avail_inter(ps, mf: MotionField, x: int, y: int) -> Optional[MotionInfo]:
    """Neighbor motion if the position is coded and inter."""
    if not ps.is_coded(x, y):
        return None
    return mf.at(x, y)


# ---------------------------------------------------------------------------
# TMVP (temporal motion vector prediction, H.266 8.5.2.12)
# ---------------------------------------------------------------------------

_MV_EXP_BITS = 4
_MV_MAN_BITS = 6
_MV_MAN_UPPER = (1 << (_MV_MAN_BITS - 1)) - 1
_MV_MAN_LIMIT = 1 << (_MV_MAN_BITS - 1)
_MV_EXP_MASK = (1 << _MV_EXP_BITS) - 1
_MV_CLIP_MIN, _MV_CLIP_MAX = -(1 << 17), (1 << 17) - 1


def _round_mv_storage(val: int) -> int:
    """Temporal-storage float round-trip (vvenc roundMvComp,
    UnitTools.cpp:1349 via convertMvFixedToFloat/FloatToFixed)."""
    sign = -1 if val < 0 else 0
    scale = ((val ^ sign) | _MV_MAN_UPPER).bit_length() - 1 - (_MV_MAN_BITS - 1)
    if scale >= 0:
        rnd = (1 << scale) >> 1
        n = (val + rnd) >> scale
        exponent = scale + ((n ^ sign) >> (_MV_MAN_BITS - 1))
        mantissa = (n & _MV_MAN_UPPER) | (sign * _MV_MAN_LIMIT)
    else:
        exponent = 0
        mantissa = val
    if exponent == 0:
        return mantissa
    return (mantissa ^ _MV_MAN_LIMIT) * (1 << (exponent - 1))


def _dist_scale_factor(cur_poc, cur_ref_poc, col_poc, col_ref_poc) -> int:
    """vvenc CU::getDistScaleFactor (UnitTools.cpp:1354)."""
    diff_d = col_poc - col_ref_poc
    diff_b = cur_poc - cur_ref_poc
    if diff_d == diff_b:
        return 4096
    tdb = max(-128, min(127, diff_b))
    tdd = max(-128, min(127, diff_d))
    # C trunc division: abs(tdd/2) == abs(tdd)//2; num/neg == -(num//|den|)
    num = 0x4000 + (abs(tdd) >> 1)
    x = num // tdd if tdd > 0 else -(num // -tdd)
    return max(-4096, min(4095, (tdb * x + 32) >> 6))


def _scale_mv(mv, scale: int):
    """Mv::scaleMv (Mv.h:182)."""
    def sc(v):
        p = scale * v
        return max(_MV_CLIP_MIN, min(_MV_CLIP_MAX,
                                     (p + 128 - (1 if p >= 0 else 0)) >> 8))
    return (sc(mv[0]), sc(mv[1]))


@dataclass
class TmvpCtx:
    """Collocated-picture context for TMVP derivation."""
    col_mf: "MotionField"            # collocated picture's motion field
    col_ref_pocs: list               # its [l0, l1] reference POCs
    col_poc: int
    cur_poc: int
    ref_pocs: list                   # current slice [l0, l1] reference POCs
    col_from_l0: int
    check_ldc: bool                  # all current refs are past pictures
    pic_w: int
    pic_h: int
    ctu_size: int


def get_colocated_mvp(tmvp: TmvpCtx, list_idx: int, pos, ref_idx: int,
                      sb_flag: bool = False):
    """vvenc CU::getColocatedMVP (UnitTools.cpp:1412).  Returns a scaled
    1/16-pel MV or None.  sb_flag: SbTMVP variant (strict list when the
    current refs are not all past pictures, UnitTools.cpp:1454)."""
    px, py = pos[0] & ~7, pos[1] & ~7  # 8x8 temporal-motion granularity
    col_list = list_idx if tmvp.check_ldc else tmvp.col_from_l0
    mi = tmvp.col_mf.at(px, py)
    if mi is None:
        return None
    if sb_flag and not tmvp.check_ldc:
        col_list = list_idx
        col_ref = mi.ref_idx[col_list]
        if col_ref < 0:
            return None
    else:
        col_ref = mi.ref_idx[col_list]
        if col_ref < 0:
            col_list = 1 - col_list
            col_ref = mi.ref_idx[col_list]
            if col_ref < 0:
                return None
    mv = (_round_mv_storage(mi.mv[col_list][0]),
          _round_mv_storage(mi.mv[col_list][1]))
    col_ref_poc = tmvp.col_ref_pocs[col_list][col_ref]
    cur_ref_poc = tmvp.ref_pocs[list_idx][ref_idx]
    scale = _dist_scale_factor(tmvp.cur_poc, cur_ref_poc,
                               tmvp.col_poc, col_ref_poc)
    if scale == 4096:
        return mv
    return _scale_mv(mv, scale)


def _tmvp_c0_c1(tmvp: TmvpCtx, x, y, w, h):
    """C0 (bottom-right, CTU-row gated) and C1 (center) probe positions."""
    rbx, rby = x + w - 4, y + h - 4
    c0 = None
    if rbx + 4 < tmvp.pic_w and rby + 4 < tmvp.pic_h:
        if (rby & (tmvp.ctu_size - 1)) + 4 < tmvp.ctu_size:
            c0 = (rbx + 4, rby + 4)
    c1 = (x + (w >> 1), y + (h >> 1))
    return c0, c1


def tmvp_candidate(tmvp: TmvpCtx, x, y, w, h, list_idx: int, ref_idx: int):
    """First-available colocated MV at C0 then C1."""
    c0, c1 = _tmvp_c0_c1(tmvp, x, y, w, h)
    if c0 is not None:
        mv = get_colocated_mvp(tmvp, list_idx, c0, ref_idx)
        if mv is not None:
            return mv
    return get_colocated_mvp(tmvp, list_idx, c1, ref_idx)


def get_merge_candidates(ps, mf: MotionField, hmvp: HmvpLut, x, y, w, h,
                         max_cands: int, is_b: bool,
                         num_refs: Tuple[int, int],
                         tmvp: Optional[TmvpCtx] = None) -> List[MotionInfo]:
    """Regular merge candidate list (UnitTools getInterMergeCandidates:905).
    Returns exactly max_cands entries."""
    cands: List[MotionInfo] = []
    pos_rt = (x + w - 1, y)
    pos_lb = (x, y + h - 1)
    mi_b1 = _avail_inter(ps, mf, pos_rt[0], pos_rt[1] - 1)
    if mi_b1 is not None:
        cands.append(mi_b1)
    mi_a1 = _avail_inter(ps, mf, pos_lb[0] - 1, pos_lb[1])
    if mi_a1 is not None and not same_motion(mi_a1, mi_b1):
        cands.append(mi_a1)
    if len(cands) < max_cands:
        mi_b0 = _avail_inter(ps, mf, pos_rt[0] + 1, pos_rt[1] - 1)
        if mi_b0 is not None and not same_motion(mi_b0, mi_b1):
            cands.append(mi_b0)
    if len(cands) < max_cands:
        mi_a0 = _avail_inter(ps, mf, pos_lb[0] - 1, pos_lb[1] + 1)
        if mi_a0 is not None and not same_motion(mi_a0, mi_a1):
            cands.append(mi_a0)
    if len(cands) < max_cands and len(cands) < 4:
        mi_b2 = _avail_inter(ps, mf, x - 1, y - 1)
        if mi_b2 is not None and not same_motion(mi_b2, mi_a1) \
                and not same_motion(mi_b2, mi_b1):
            cands.append(mi_b2)
    # TMVP (UnitTools.cpp:1112): ref idx 0 per list, C0 then C1, no pruning
    if tmvp is not None and w + h > 12 and len(cands) < max_cands:
        mv0 = tmvp_candidate(tmvp, x, y, w, h, 0, 0)
        mv1 = tmvp_candidate(tmvp, x, y, w, h, 1, 0) if is_b else None
        if mv0 is not None or mv1 is not None:
            cands.append(MotionInfo(
                (mv0 or (0, 0), mv1 or (0, 0)),
                (0 if mv0 is not None else -1,
                 0 if mv1 is not None else -1)))
    # HMVP (most recent first), pruned vs A1/B1 for the first two entries
    if len(cands) < max_cands - 1:
        lut = hmvp.lut
        for mrg_idx in range(1, len(lut) + 1):
            mi_n = lut[len(lut) - mrg_idx]
            if mrg_idx > 2 or (not same_motion(mi_n, mi_a1)
                               and not same_motion(mi_n, mi_b1)):
                cands.append(mi_n)
                if len(cands) == max_cands - 1:
                    break
    # pairwise average of the first two
    if 1 < len(cands) < max_cands:
        mv = [(0, 0), (0, 0)]
        ref = [-1, -1]
        for li in range(2 if is_b else 1):
            ri = cands[0].ref_idx[li]
            rj = cands[1].ref_idx[li]
            if ri < 0 and rj < 0:
                continue
            if ri >= 0 and rj >= 0:
                mv[li] = (round_pairwise(cands[0].mv[li][0] + cands[1].mv[li][0]),
                          round_pairwise(cands[0].mv[li][1] + cands[1].mv[li][1]))
                ref[li] = ri
            elif ri >= 0:
                mv[li], ref[li] = cands[0].mv[li], ri
            else:
                mv[li], ref[li] = cands[1].mv[li], rj
        alt = cands[0].alt_hpel if cands[0].alt_hpel == cands[1].alt_hpel \
            else False
        pair = MotionInfo((tuple(mv[0]), tuple(mv[1])), (ref[0], ref[1]),
                          alt_hpel=alt)
        if pair.inter_dir:
            cands.append(pair)
    # zero candidates with increasing ref idx
    ref_cnt = 0
    max_refs = min(num_refs[0], num_refs[1]) if is_b else num_refs[0]
    while len(cands) < max_cands:
        r = ref_cnt if ref_cnt < max_refs else 0
        if is_b:
            cands.append(MotionInfo(((0, 0), (0, 0)), (r, r)))
        else:
            cands.append(MotionInfo(((0, 0), (0, 0)), (r, -1)))
        ref_cnt += 1
    return cands[:max_cands]


def _mi_mv_for_ref(mi: MotionInfo, list_idx: int, ref_poc: int,
                   ref_pocs) -> Optional[Tuple[int, int]]:
    """First matching-list then other-list MV with the same reference POC."""
    for src in (list_idx, 1 - list_idx):
        r = mi.ref_idx[src]
        if r >= 0 and src < len(ref_pocs) and r < len(ref_pocs[src]) and \
                ref_pocs[src][r] == ref_poc:
            return mi.mv[src]
    return None


def get_amvp_candidates(ps, mf: MotionField, hmvp: HmvpLut, x, y, w, h,
                        list_idx: int, ref_idx: int, ref_pocs,
                        tmvp: Optional[TmvpCtx] = None, imv: int = 0
                        ) -> List[Tuple[int, int]]:
    """AMVP candidate list (fillMvpCand:1692) -> 2 entries, rounded to
    the AMVR precision of the CU."""
    ref_poc = ref_pocs[list_idx][ref_idx]
    cands: List[Tuple[int, int]] = []
    pos_lt = (x, y)
    pos_rt = (x + w - 1, y)
    pos_lb = (x, y + h - 1)
    # left group: A0 (below-left) then A1 (left)
    for px, py in ((pos_lb[0] - 1, pos_lb[1] + 1), (pos_lb[0] - 1, pos_lb[1])):
        mi = _avail_inter(ps, mf, px, py)
        if mi is not None:
            mv = _mi_mv_for_ref(mi, list_idx, ref_poc, ref_pocs)
            if mv is not None:
                cands.append(mv)
                break
    # above group: B0 (above-right), B1 (above), B2 (above-left)
    for px, py in ((pos_rt[0] + 1, pos_rt[1] - 1), (pos_rt[0], pos_rt[1] - 1),
                   (pos_lt[0] - 1, pos_lt[1] - 1)):
        mi = _avail_inter(ps, mf, px, py)
        if mi is not None:
            mv = _mi_mv_for_ref(mi, list_idx, ref_poc, ref_pocs)
            if mv is not None:
                cands.append(mv)
                break
    cands = [round_mv_amvr(m, imv) for m in cands]
    if len(cands) == 2 and cands[0] == cands[1]:
        cands = cands[:1]
    # TMVP (fillMvpCand:1749): rounded after scaling
    if tmvp is not None and w + h > 12 and len(cands) < AMVP_MAX_NUM_CANDS:
        mv = tmvp_candidate(tmvp, x, y, w, h, list_idx, ref_idx)
        if mv is not None:
            cands.append(round_mv_amvr(mv, imv))
    # HMVP (oldest first per reference loop lut[mrgIdx-1])
    if len(cands) < AMVP_MAX_NUM_CANDS:
        for mi_n in hmvp.lut[:MAX_NUM_HMVP_AMVP_CANDS]:
            done = False
            for src in (list_idx, 1 - list_idx):
                r = mi_n.ref_idx[src]
                if r >= 0 and r < len(ref_pocs[src]) and \
                        ref_pocs[src][r] == ref_poc:
                    cands.append(round_mv_amvr(mi_n.mv[src], imv))
                    if len(cands) >= AMVP_MAX_NUM_CANDS:
                        done = True
                        break
            if done:
                break
    while len(cands) < AMVP_MAX_NUM_CANDS:
        cands.append((0, 0))
    return cands[:AMVP_MAX_NUM_CANDS]


def hmvp_insertion_allowed(x, y, w, h, log2_par_merge_level=2) -> bool:
    """saveMotionInHMVP gating (UnitTools.cpp:352)."""
    xbr, ybr = x + w, y + h
    return ((xbr >> log2_par_merge_level) > (x >> log2_par_merge_level)) and \
           ((ybr >> log2_par_merge_level) > (y >> log2_par_merge_level))


# ---------------------------------------------------------------------------
# IBC (intra block copy) merge / AMVP
# ---------------------------------------------------------------------------

def get_ibc_merge_candidates(ps, mf: MotionField, hmvp_ibc: HmvpLut,
                             x, y, w, h, max_cands: int) -> List:
    """CU::getIBCMergeCandidates (UnitTools.cpp:803): A1, B1, HMVP, zero.
    Returns a list of BVs (internal 1/16 units)."""
    cands: List = []
    gt4x4 = w * h > 16
    bv_a1 = bv_b1 = None
    if gt4x4:
        if ps.is_coded(x - 1, y + h - 1):
            bv_a1 = mf.ibc_at(x - 1, y + h - 1)
            if bv_a1 is not None:
                cands.append(bv_a1)
        if ps.is_coded(x + w - 1, y - 1):
            bv_b1 = mf.ibc_at(x + w - 1, y - 1)
            if bv_b1 is not None and (bv_a1 is None or bv_b1 != bv_a1):
                cands.append(bv_b1)
    # HMVP (newest first; prune only the first entry vs A1/B1 when >4x4)
    lut = hmvp_ibc.lut
    for mrg_idx in range(1, len(lut) + 1):
        if len(cands) >= max_cands:
            break
        bv = lut[len(lut) - mrg_idx].mv[0]
        if (mrg_idx > 1 or not gt4x4) or \
                ((bv_a1 is None or bv != bv_a1) and
                 (bv_b1 is None or bv != bv_b1)):
            cands.append(bv)
    while len(cands) < max_cands:
        cands.append((0, 0))
    return cands[:max_cands]


def get_ibc_amvp_candidates(ps, mf: MotionField, hmvp_ibc: HmvpLut,
                            x, y, w, h, imv: int) -> List:
    """fillIBCMvpCand (UnitTools.cpp:1643): the first two IBC merge
    candidates rounded to the AMVR precision (int / 4-pel)."""
    cands = get_ibc_merge_candidates(ps, mf, hmvp_ibc, x, y, w, h, 2)
    sh = 6 if imv == 2 else 4   # m_amvrPrecIbc: INT, INT, 4PEL
    out = []
    for bv in cands:
        off = 1 << (sh - 1)

        def r(v):
            v = (v + off - 1) >> sh if v >= 0 else (v + off) >> sh
            return v << sh
        out.append((r(bv[0]), r(bv[1])))
    return out


def refine_mf_with_dmvr(mf, trees) -> None:
    """Write DMVR-refined MVs into the stored motion field (the TMVP
    source for later pictures — vvenc setRefinedMotionFieldCTU).  Shared
    by the decoder and the encoder (both keep the same field)."""
    def walk(node):
        cu = node.cu
        if cu is not None and getattr(cu, "dmvr_deltas", None):
            for (sy, sx), (dx_, dy_) in cu.dmvr_deltas.items():
                if dx_ == 0 and dy_ == 0:
                    continue
                mi = MotionInfo(
                    ((cu.mv[0][0] + dx_, cu.mv[0][1] + dy_),
                     (cu.mv[1][0] - dx_, cu.mv[1][1] - dy_)),
                    tuple(cu.ref_idx), bcw=cu.bcw_idx,
                    alt_hpel=cu.alt_hpel)
                # sparse 8x8-grid refinement (vvenc refineCU)
                x0a, y0a = cu.x + sx, cu.y + sy
                x1a = min(x0a + 16, cu.x + cu.w)
                y1a = min(y0a + 16, cu.y + cu.h)
                y2 = ((y0a - 1) & ~7) + 8
                while y2 < y1a:
                    x2 = ((x0a - 1) & ~7) + 8
                    while x2 < x1a:
                        mf.set_unit_mi(x2 >> 2, y2 >> 2, mi)
                        x2 += 8
                    y2 += 8
        for c in node.children:
            walk(c)
    for t in trees:
        walk(t)

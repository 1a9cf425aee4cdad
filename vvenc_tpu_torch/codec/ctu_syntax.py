"""Coding-tree / CU / TU syntax (encode + decode) with reconstruction.

Implements H.266 7.3.11.2-7.3.11.10 for the round-1 tool set: QT-only
partitioning (MTT hooks pending), intra CUs, single tree, TU == CU
(max TB 32), regular residual coding.

Behavioral reference: vvenc EncoderLib/CABACWriter.cpp (coding_tree_unit:156,
split_cu_mode:563, coding_unit:641, intra_luma_pred_modes:955,
intra_chroma_pred_mode:1178, transform_unit:2032, cbf_comp:1943),
CommonLib/UnitTools.cpp (getIntraMPMs:544, getIntraChromaCandModes:677),
CommonLib/ContextModelling.cpp (CtxSplit:147).

Both paths share the derivation helpers so encoder and decoder cannot
diverge; the decoder additionally reconstructs into the PictureState.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..bitstream import ctx_tables as ct
from ..bitstream.residual import encode_residual, decode_residual
from ..ops import intra as I
from ..ops import mip as MIP
from ..ops import transforms as T
from ..ops.interp import mc_block_np, bi_average_np
from .picture import PictureState
from .qp import QpState
from .motion import (MotionInfo, MotionField, HmvpLut, get_merge_candidates,
                     get_amvp_candidates, round_mv_quarter, round_mv_amvr,
                     hmvp_insertion_allowed, AMVR_SHIFTS,
                     _dist_scale_factor, _scale_mv)

MV_MAX = (1 << 17) - 1
MV_MIN = -(1 << 17)

PLANAR, DC, HOR, VER, VDIA = I.PLANAR_IDX, I.DC_IDX, I.HOR_IDX, I.VER_IDX, I.VDIA_IDX
NUM_LUMA_MODE = I.NUM_LUMA_MODE
DM_CHROMA = 67  # sentinel: derived mode
NUM_MPM = 6
from .cclm import (CCLM_MODES, LM_CHROMA_IDX, MDLM_L_IDX,  # noqa: E402
                   MDLM_T_IDX, cclm_predict)


# ---------------------------------------------------------------------------
# decision tree data model
# ---------------------------------------------------------------------------

@dataclass
class CuData:
    x: int
    y: int
    w: int
    h: int
    is_inter: bool = False
    skip: bool = False
    merge: bool = False
    merge_idx: int = 0
    mv: tuple = ((0, 0), (0, 0))     # internal 1/16-pel, per list
    ref_idx: tuple = (-1, -1)
    mvd: tuple = (0, 0)              # quarter-pel units as signalled (L0)
    mvp_idx: int = 0
    mvd_l1: tuple = (0, 0)
    mvp_idx_l1: int = 0
    root_cbf: bool = True
    luma_mode: int = PLANAR
    mip_flag: bool = False           # matrix intra prediction (luma_mode is
    mip_transposed: bool = False     # then the MIP mode index)
    ref_line: int = 0                # MRL reference line index (0, 1, 2)
    lfnst_idx: int = 0               # secondary transform index (0, 1, 2)
    mts_idx: int = 0                 # explicit MTS (0=DCT2, 1..4 DST7/DCT8)
    joint_cbcr: int = 0              # JCCR cbf mask (0=off, 1/2/3)
    imv: int = 0                     # AMVR precision (0=1/4,1=int,2=4pel,3=half)
    smvd: bool = False               # symmetric MVD mode
    mmvd_flag: bool = False          # MMVD merge
    mmvd_base: int = 0               # MMVD base candidate (0/1)
    mmvd_step: int = 0               # MMVD distance step (0..7)
    mmvd_pos: int = 0                # MMVD direction (0..3)
    bcw_idx: int = 2                 # bi-prediction weight index
    alt_hpel: bool = False           # alternative half-pel IF (AMVR half)
    dmvr_deltas: Optional[dict] = None  # {(sy,sx): (dx,dy) 1/16} per 16x16
    dmvr_bdof: Optional[dict] = None    # per-sub-PU BDOF enable
    geo: bool = False                # geometric partitioning merge
    geo_split_dir: int = 0           # GPM split mode (0..63)
    geo_idx0: int = 0                # GPM merge cand of partition 0
    geo_idx1: int = 0                # GPM merge cand of partition 1
    geo_mi: Optional[tuple] = None   # the two uni MotionInfos
    ciip: bool = False               # combined inter/intra prediction
    affine: bool = False             # affine CU (incl. SbTMVP merge)
    affine_type: int = 0             # 0 = 4-param, 1 = 6-param
    sbtmvp: bool = False             # subblock merge type SUBPU_ATMVP
    cpmv: tuple = (((0, 0),) * 3, ((0, 0),) * 3)  # CP MVs LT/RT/LB per list
    aff_mvds: Optional[tuple] = None    # signalled CPMV mvds per list
    sub_mi: Optional[list] = None       # per-4x4 MotionInfo grid
    sub_mi_src: Optional[tuple] = None  # SbTMVP (8x8 grid, (pw, ph))
    aff_grids: Optional[list] = None    # cached per-list sub-block MV grids
    aff_dhv: Optional[list] = None      # cached per-list affine deltas
    aff_spread: Optional[list] = None   # per-list spread-over-limit flags
    chroma_dir: int = DM_CHROMA      # signalled chroma mode (DM or mode value)
    coeff_y: Optional[np.ndarray] = None
    coeff_cb: Optional[np.ndarray] = None
    coeff_cr: Optional[np.ndarray] = None
    isp_mode: int = 0                # 0 none, 1 horizontal, 2 vertical
    isp_coeffs: Optional[list] = None   # per-partition luma coeff arrays
    sbt_idx: int = 0                 # 0 off, 1 VER_HALF, 2 HOR_HALF,
    sbt_pos: int = 0                 # 3 VER_QUAD, 4 HOR_QUAD; pos 0/1
    ts_y: bool = False               # transform_skip_flag per component
    ts_cb: bool = False
    ts_cr: bool = False
    bdpcm_y: int = 0                 # 0 off, 1 horizontal, 2 vertical
    bdpcm_c: int = 0
    is_ibc: bool = False             # intra block copy (BV in mv[0])
    luma_only: bool = False          # TREE_L CU of a local dual tree
    chroma_only: bool = False        # TREE_C region chroma CU
    recon_done: bool = False         # recon staged + maps marked by the
    #                                  native search; replay skips both
    cclm_allowed: bool = True        # CU::checkCCLMAllowed (dual tree)
    mtb_tus: Optional[list] = None   # implicit max-TB TU tiling: per-TU
                                     # (tx, ty, tw, th, cy, ccb, ccr, joint)
    qp: int = -1                     # luma QpY (cu_qp_delta); -1 = slice QP

    @property
    def inter_dir(self) -> int:
        return (1 if self.ref_idx[0] >= 0 else 0) | \
               (2 if self.ref_idx[1] >= 0 else 0)


# split modes
NO_SPLIT, QT_SPLIT, BT_H, BT_V, TT_H, TT_V = 0, 1, 2, 3, 4, 5

# mode-constraint types (vvenc ModeType, CommonDef: MODE_TYPE_ALL/INTER/INTRA)
MODE_ALL, MODE_INTER, MODE_INTRA = 0, 1, 2
# tree types for the local dual tree (vvenc TreeType: TREE_D/L/C).
# CHROMA_TREE marks the full dual-tree-intra chroma pass (DUAL_TREE_CHROMA):
# unlike TREE_C (the unsplittable SCIPU region chroma), it partitions with
# the chroma constraint set (UnitPartitioner canSplit areaC rules).
TREE_D, TREE_L, TREE_C = 0, 1, 2
CHROMA_TREE = 3
# signalModeCons results (vvenc LDT_MODE_TYPE_*)
LDT_INHERIT, LDT_INFER, LDT_SIGNAL = 0, 1, 2


def signal_mode_cons(w: int, h: int, split: int, mode_type_parent: int,
                     is_intra_slice: bool) -> int:
    """Whether a split codes/infers a mode constraint (SCIPU, VVC 7.4.11.4
    non_inter_flag; vvenc CS::signalModeCons, UnitTools.cpp:77).  4:2:0,
    single-tree SPS assumed."""
    if mode_type_parent != MODE_ALL:
        return LDT_INHERIT
    min_luma_area = (w * h) >> (2 if split in (QT_SPLIT, TT_H, TT_V) else 1)
    min_chroma_block = min_luma_area >> 2
    is_2xn_chroma = ((w >> 1) == 4 and split == BT_V) or \
                    ((w >> 1) == 8 and split == TT_V)
    if min_chroma_block >= 16 and not is_2xn_chroma:
        return LDT_INHERIT
    return LDT_INFER if (min_luma_area < 32 or is_intra_slice) \
        else LDT_SIGNAL


@dataclass
class PartInfo:
    """Per-node partitioner state (vvenc Partitioner depth counters)."""
    qt_depth: int = 0
    mtt_depth: int = 0
    bt_depth: int = 0
    impl_bt_depth: int = 0
    last_split: int = -1       # -1 = CTU level
    part_idx: int = 0
    mode_type: int = MODE_ALL  # SCIPU constraint inherited from ancestors
    tree_type: int = TREE_D    # TREE_L inside a chroma-not-split region
    subdiv: int = 0            # cbSubdiv (QG depth; vvenc currSubdiv)
    split_path: tuple = ()     # splits from the (dual-tree) root
                               # (CU::getSplitAtDepth series analog)

    def child(self, split: int, idx: int, implicit: bool = False) -> "PartInfo":
        p = PartInfo(self.qt_depth, self.mtt_depth, self.bt_depth,
                     self.impl_bt_depth, split, idx,
                     self.mode_type, self.tree_type, self.subdiv,
                     self.split_path + (split,))
        if split == QT_SPLIT:
            p.qt_depth += 1
            p.mtt_depth = 0
            p.bt_depth = 0
            p.subdiv += 2
        else:
            p.mtt_depth += 1
            p.bt_depth += 1 + (1 if split in (TT_H, TT_V) else 0)
            # QG subdiv: BT +1; TT outer parts +2, center +1
            p.subdiv += 2 if (split in (TT_H, TT_V) and idx != 1) else 1
            if implicit:
                # boundary-forced BT extends the MTT depth budget
                # (vvenc Partitioner::splitCurrArea currImplicitBtDepth++)
                p.impl_bt_depth += 1
        return p


def split_geometry(split: int, x: int, y: int, w: int, h: int):
    """Child (x, y, w, h) rectangles in coding order."""
    if split == QT_SPLIT:
        hw, hh = w >> 1, h >> 1
        return [(x, y, hw, hh), (x + hw, y, hw, hh),
                (x, y + hh, hw, hh), (x + hw, y + hh, hw, hh)]
    if split == BT_H:
        hh = h >> 1
        return [(x, y, w, hh), (x, y + hh, w, hh)]
    if split == BT_V:
        hw = w >> 1
        return [(x, y, hw, h), (x + hw, y, hw, h)]
    if split == TT_H:
        q = h >> 2
        return [(x, y, w, q), (x, y + q, w, h >> 1), (x, y + 3 * q, w, q)]
    if split == TT_V:
        q = w >> 2
        return [(x, y, q, h), (x + q, y, w >> 1, h), (x + 3 * q, y, q, h)]
    raise ValueError(split)


@dataclass
class TreeNode:
    x: int
    y: int
    size: int                   # kept for CTU-level API compat (width)
    qt_depth: int = 0
    split: bool = False
    split_mode: int = NO_SPLIT
    w: int = 0
    h: int = 0
    part: PartInfo = field(default_factory=PartInfo)
    children: List["TreeNode"] = field(default_factory=list)
    cu: Optional[CuData] = None
    mode_type_child: int = MODE_ALL  # constraint chosen/derived at this split
    chroma_cu: Optional[CuData] = None  # TREE_C region chroma (SCIPU)
    # a CTU root decided by the native search: its serialized decision
    # (native.ctu_writer.Record), which the native writer codes
    native_rec: Optional[object] = None


# ---------------------------------------------------------------------------
# shared derivations
# ---------------------------------------------------------------------------

MAX_TB = 64  # MAX_TB_SIZEY constraint used by BT/TT allowance


def implicit_split(ps: PictureState, x: int, y: int, w: int, h: int,
                   part: PartInfo, sps, tree_idx: int = 0) -> int:
    """Boundary-forced split (vvenc Partitioner::getImplicitSplit:612).

    tree_idx selects the slice-type partition constraints: 0 = intra
    slice (luma), 1 = inter slice (SPS 7.4.3.4 *_intra_slice_luma vs
    *_inter_slice syntax)."""
    bl_in = (x < ps.w) and (y + h <= ps.h)      # bottom-left inside
    tr_in = (x + w <= ps.w) and (y < ps.h)      # top-right inside
    if bl_in and tr_in:
        return NO_SPLIT
    max_btd = sps.max_mtt_depth[tree_idx] + part.impl_bt_depth
    bt_ok = (w <= sps.max_bt_size[tree_idx] and h <= sps.max_bt_size[tree_idx]
             and part.mtt_depth < max_btd)
    qt_ok = w > sps.min_qt_size[tree_idx] and part.bt_depth == 0
    if not bl_in and not tr_in and qt_ok:
        return QT_SPLIT
    if not bl_in and bt_ok and w <= MAX_TB:
        return BT_H
    if not tr_in and bt_ok and h <= MAX_TB:
        return BT_V
    return QT_SPLIT


def split_options_full(ps: PictureState, x: int, y: int, w: int, h: int,
                       part: PartInfo, sps, tree_idx: int = 0):
    """All six split allowances (vvenc Partitioner::canSplit:445).

    Returns [can_no, can_qt, can_bh, can_bv, can_th, can_tv]."""
    min_t = 1 << sps.log2_min_cb_size
    max_bt = sps.max_bt_size[tree_idx]
    max_tt = sps.max_tt_size[tree_idx]
    max_btd = sps.max_mtt_depth[tree_idx] + part.impl_bt_depth
    can_no = can_qt = can_bh = can_bv = can_th = can_tv = True
    can_btt = part.mtt_depth < max_btd

    if part.last_split not in (-1, QT_SPLIT):
        can_qt = False
    if w <= sps.min_qt_size[tree_idx]:
        can_qt = False

    # full dual-tree chroma pass: chroma-sample minimums
    # (UnitPartitioner::canSplit areaC rules, MIN_DUALTREE_CHROMA_*)
    ctree = part.tree_type == CHROMA_TREE
    wc, hc = w >> 1, h >> 1
    if ctree and wc <= 4:
        can_qt = False

    impl = implicit_split(ps, x, y, w, h, part, sps, tree_idx)
    if impl != NO_SPLIT:
        can_no = can_th = can_tv = False
        can_bh = impl == BT_H
        can_bv = impl == BT_V
        if ctree and wc == 4:
            can_bv = False
        if not can_bh and not can_bv and not can_qt:
            can_qt = True
        return [can_no, can_qt, can_bh, can_bv, can_th, can_tv]

    # redundancy: center TT child cannot use the parallel BT split
    if part.last_split in (TT_H, TT_V) and part.part_idx == 1:
        if part.last_split == TT_H:
            can_bh = False
        else:
            can_bv = False

    if can_btt and (w <= min_t and h <= min_t):
        can_btt = False
    if can_btt and (w > max_bt or h > max_bt) and (w > max_tt or h > max_tt):
        can_btt = False
    if not can_btt:
        return [can_no, can_qt, False, False, False, False]

    if w > max_bt or h > max_bt:
        can_bh = can_bv = False
    if h <= min_t:
        can_bh = False
    if w > MAX_TB and h <= MAX_TB:
        can_bh = False
    if ctree and wc * hc <= 16:
        can_bh = False
    if w <= min_t:
        can_bv = False
    if w <= MAX_TB and h > MAX_TB:
        can_bv = False
    if ctree and (wc * hc <= 16 or wc == 4):
        can_bv = False
    if h <= 2 * min_t or h > max_tt or w > max_tt:
        can_th = False
    if w > MAX_TB or h > MAX_TB:
        can_th = False
    if ctree and wc * hc <= 32:
        can_th = False
    if w <= 2 * min_t or w > max_tt or h > max_tt:
        can_tv = False
    if w > MAX_TB or h > MAX_TB:
        can_tv = False
    if ctree and (wc * hc <= 32 or wc == 8):
        can_tv = False
    # inside a MODE_TYPE_INTER region no 4x4/4x8/8x4 luma may be created
    # (vvenc UnitPartitioner.cpp:518,527)
    if part.mode_type == MODE_INTER and w * h == 32:
        can_bh = can_bv = False
    if part.mode_type == MODE_INTER and w * h == 64:
        can_th = can_tv = False
    return [can_no, can_qt, can_bh, can_bv, can_th, can_tv]


def split_ctx_ids(ps: PictureState, x: int, y: int, w: int, h: int,
                  part: PartInfo, can_spl):
    """Context indices for split_cu_mode (vvenc DeriveCtx::CtxSplit:147).

    Returns (ctx_split, ctx_qt, ctx_hv, ctx_h12, ctx_v12)."""
    if part.tree_type == CHROMA_TREE:
        # chroma-tree neighbours come from the chroma CU maps
        left = ps.chroma_cu_at(x - 1, y)
        above = ps.chroma_cu_at(x, y - 1)
    else:
        left = ps.cu_at(x - 1, y)
        above = ps.cu_at(x, y - 1)
    ctx_split = 0
    if left is not None:
        ctx_split += 1 if left[1] < h else 0
    if above is not None:
        ctx_split += 1 if above[0] < w else 0
    num_split = (2 if can_spl[1] else 0) + sum(1 for i in (2, 3, 4, 5)
                                              if can_spl[i])
    if num_split > 0:
        num_split -= 1
    ctx_split += 3 * (num_split >> 1)
    ctx_qt = 0
    if left is not None and left[2] > part.qt_depth:
        ctx_qt += 1
    if above is not None and above[2] > part.qt_depth:
        ctx_qt += 1
    ctx_qt += 0 if part.qt_depth < 2 else 3
    # hor/ver split context
    num_hor = (1 if can_spl[2] else 0) + (1 if can_spl[4] else 0)
    num_ver = (1 if can_spl[3] else 0) + (1 if can_spl[5] else 0)
    if num_ver == num_hor:
        w_above = above[0] if above is not None else 1
        h_left = left[1] if left is not None else 1
        dep_above = w // w_above
        dep_left = h // h_left
        if dep_above == dep_left or left is None or above is None:
            ctx_hv = 0
        elif dep_above < dep_left:
            ctx_hv = 1
        else:
            ctx_hv = 2
    elif num_ver < num_hor:
        ctx_hv = 3
    else:
        ctx_hv = 4
    ctx_h12 = 1 if part.mtt_depth <= 1 else 0
    ctx_v12 = 3 if part.mtt_depth <= 1 else 2
    return ctx_split, ctx_qt, ctx_hv, ctx_h12, ctx_v12


def write_split_mode(enc, ps, x, y, w, h, part, sps, split: int,
                     tree_idx: int = 0) -> None:
    """split_cu_mode (vvenc CABACWriter::split_cu_mode:563)."""
    can_spl = split_options_full(ps, x, y, w, h, part, sps, tree_idx)
    ctx_split, ctx_qt, ctx_hv, ctx_h12, ctx_v12 = \
        split_ctx_ids(ps, x, y, w, h, part, can_spl)
    can_no = can_spl[0]
    can_split_any = any(can_spl[1:])
    is_no = split == NO_SPLIT
    if can_no and can_split_any:
        enc.encode_bin(0 if is_no else 1, ct.CTX_SETS["SplitFlag"](ctx_split))
    if is_no:
        return
    can_btt = any(can_spl[2:])
    is_qt = split == QT_SPLIT
    if can_spl[1] and can_btt:
        enc.encode_bin(1 if is_qt else 0, ct.CTX_SETS["SplitQtFlag"](ctx_qt))
    if is_qt:
        return
    can_hor = can_spl[2] or can_spl[4]
    can_ver = can_spl[3] or can_spl[5]
    is_ver = split in (BT_V, TT_V)
    if can_ver and can_hor:
        enc.encode_bin(1 if is_ver else 0, ct.CTX_SETS["SplitHvFlag"](ctx_hv))
    can14 = can_spl[5] if is_ver else can_spl[4]
    can12 = can_spl[3] if is_ver else can_spl[2]
    is12 = split == (BT_V if is_ver else BT_H)
    if can12 and can14:
        enc.encode_bin(1 if is12 else 0,
                       ct.CTX_SETS["Split12Flag"](ctx_v12 if is_ver else ctx_h12))


def read_split_mode(dec, ps, x, y, w, h, part, sps, tree_idx: int = 0) -> int:
    can_spl = split_options_full(ps, x, y, w, h, part, sps, tree_idx)
    ctx_split, ctx_qt, ctx_hv, ctx_h12, ctx_v12 = \
        split_ctx_ids(ps, x, y, w, h, part, can_spl)
    can_no = can_spl[0]
    can_split_any = any(can_spl[1:])
    if can_no and can_split_any:
        is_split = dec.decode_bin(ct.CTX_SETS["SplitFlag"](ctx_split))
    else:
        is_split = 0 if can_no else 1
    if not is_split:
        return NO_SPLIT
    can_btt = any(can_spl[2:])
    if can_spl[1] and can_btt:
        is_qt = dec.decode_bin(ct.CTX_SETS["SplitQtFlag"](ctx_qt))
    else:
        is_qt = 1 if can_spl[1] else 0
    if is_qt:
        return QT_SPLIT
    can_hor = can_spl[2] or can_spl[4]
    can_ver = can_spl[3] or can_spl[5]
    if can_ver and can_hor:
        is_ver = dec.decode_bin(ct.CTX_SETS["SplitHvFlag"](ctx_hv))
    else:
        is_ver = 1 if can_ver else 0
    can14 = can_spl[5] if is_ver else can_spl[4]
    can12 = can_spl[3] if is_ver else can_spl[2]
    if can12 and can14:
        is12 = dec.decode_bin(
            ct.CTX_SETS["Split12Flag"](ctx_v12 if is_ver else ctx_h12))
    else:
        is12 = 1 if can12 else 0
    if is_ver:
        return BT_V if is12 else TT_V
    return BT_H if is12 else TT_H


def split_options(ps: PictureState, x: int, y: int, size: int, min_qt: int):
    """Legacy QT-only helper (kept for the round-1 encoder search)."""
    inside = (x + size <= ps.w) and (y + size <= ps.h)
    can_qt = size > min_qt
    return inside, can_qt


def split_flag_ctx(ps: PictureState, x: int, y: int, size: int) -> int:
    ctx = 0
    left = ps.cu_at(x - 1, y)
    above = ps.cu_at(x, y - 1)
    if left is not None:
        ctx += 1 if left[1] < size else 0   # neighbor height < current
    if above is not None:
        ctx += 1 if above[0] < size else 0  # neighbor width < current
    # QT-only: numSplit = 2 -> (numSplit-1)>>1 = 0 contribution
    return ctx


def get_intra_mpms(ps: PictureState, x: int, y: int, w: int, h: int,
                   ctu_size: int) -> list:
    """6-entry MPM list (vvenc CU::getIntraMPMs:544)."""
    left_dir = above_dir = PLANAR
    lc = ps.cu_at(x - 1, y + h - 1)
    if lc is not None and lc[4] and not lc[5]:
        left_dir = lc[3]
    # above only from the same CTU row: top edge not on a CTU boundary
    if (y % ctu_size) != 0:
        ac = ps.cu_at(x + w - 1, y - 1)
        if ac is not None and ac[4] and not ac[5]:
            above_dir = ac[3]
    offset = NUM_LUMA_MODE - 6  # 61
    mod = offset + 3            # 64
    mpm = [PLANAR, DC, VER, HOR, VER - 4, VER + 4]
    if left_dir == above_dir:
        if left_dir > DC:
            mpm = [PLANAR, left_dir,
                   ((left_dir + offset) % mod) + 2,
                   ((left_dir - 1) % mod) + 2,
                   ((left_dir + offset - 1) % mod) + 2,
                   (left_dir % mod) + 2]
    else:
        if left_dir > DC and above_dir > DC:
            mpm = [PLANAR, left_dir, above_dir, 0, 0, 0]
            mx = max(left_dir, above_dir)
            mn = min(left_dir, above_dir)
            if mx - mn == 1:
                mpm[3] = ((mn + offset) % mod) + 2
                mpm[4] = ((mx - 1) % mod) + 2
                mpm[5] = ((mn + offset - 1) % mod) + 2
            elif mx - mn >= 62:
                mpm[3] = ((mn - 1) % mod) + 2
                mpm[4] = ((mx + offset) % mod) + 2
                mpm[5] = (mn % mod) + 2
            elif mx - mn == 2:
                mpm[3] = ((mn - 1) % mod) + 2
                mpm[4] = ((mn + offset) % mod) + 2
                mpm[5] = ((mx - 1) % mod) + 2
            else:
                mpm[3] = ((mn + offset) % mod) + 2
                mpm[4] = ((mn - 1) % mod) + 2
                mpm[5] = ((mx + offset) % mod) + 2
        elif left_dir + above_dir >= 2:
            md = max(left_dir, above_dir)
            mpm = [PLANAR, md,
                   ((md + offset) % mod) + 2,
                   ((md - 1) % mod) + 2,
                   ((md + offset - 1) % mod) + 2,
                   (md % mod) + 2]
    return mpm


def scan_pos_last(coeff) -> int:
    """Last significant position in grouped-diagonal scan order (-1 if
    the block is empty / None)."""
    if coeff is None:
        return -1
    from ..bitstream.residual import scan_info
    h, w = coeff.shape
    sx, sy, _, _, _, _ = scan_info(w.bit_length() - 1, h.bit_length() - 1)
    nz = np.nonzero(coeff[sy, sx])[0]
    return int(nz[-1]) if nz.size else -1


def lfnst_chroma_mode(cu) -> int:
    """Intra mode driving the LFNST set for a chroma TB (vvenc
    xInvLfnst: CCLM -> co-located luma mode, DM -> derived mode)."""
    if cu.chroma_dir in CCLM_MODES or cu.chroma_dir == DM_CHROMA:
        return dm_luma_mode(cu)
    return cu.chroma_dir


def dm_luma_mode(cu) -> int:
    """Luma mode as seen by chroma DM / candidate derivation: MIP CUs
    count as PLANAR (VVC 8.4.3, vvenc PU::getCoLocatedIntraLumaMode)."""
    return PLANAR if cu.mip_flag else cu.luma_mode


def isp_partitions(w: int, h: int, isp_mode: int):
    """ISP partition rectangles (CU::getISPSplitDim, UnitTools.cpp:474):
    list of (x_off, y_off, pw, ph)."""
    if isp_mode == 1:      # horizontal split
        split_dim, non_split = h, w
    else:                  # vertical split
        split_dim, non_split = w, h
    factor = (16 // non_split) if non_split < 16 else 1
    part = max(split_dim >> 2, factor)
    n = split_dim // part
    out = []
    for k in range(n):
        if isp_mode == 1:
            out.append((0, k * part, w, part))
        else:
            out.append((k * part, 0, part, h))
    return out


def sbt_tu_rect(cu):
    """Residual-TU rectangle of an SBT CU (luma coords, relative) and its
    luma transform types (TrQuant::xSetTrTypes:435-466)."""
    if cu.sbt_idx in (1, 3):        # vertical split
        tw = cu.w >> (1 if cu.sbt_idx == 1 else 2)
        tx = 0 if cu.sbt_pos == 0 else cu.w - tw
        ty, th = 0, cu.h
        if th > 32:
            trh = trv = T.DCT2
        else:
            trh = T.DCT8 if cu.sbt_pos == 0 else T.DST7
            trv = T.DST7
    else:                            # horizontal split
        th = cu.h >> (1 if cu.sbt_idx == 2 else 2)
        ty = 0 if cu.sbt_pos == 0 else cu.h - th
        tx, tw = 0, cu.w
        if tw > 32:
            trh = trv = T.DCT2
        else:
            trh = T.DST7
            trv = T.DCT8 if cu.sbt_pos == 0 else T.DST7
    return tx, ty, tw, th, trh, trv


def mip_flag_ctx(ps: PictureState, x: int, y: int, w: int, h: int) -> int:
    """vvenc DeriveCtx::CtxMipFlag (ContextModelling.cpp)."""
    if w > 2 * h or h > 2 * w:
        return 3
    ctx = 0
    left = ps.cu_at(x - 1, y)
    if left is not None and left[5]:
        ctx += 1
    above = ps.cu_at(x, y - 1)
    if above is not None and above[5]:
        ctx += 1
    return ctx


def chroma_cand_modes(luma_mode: int) -> list:
    """4 signalled chroma candidates with VDIA substitution (UnitTools:677)."""
    modes = [PLANAR, VER, HOR, DC]
    for i in range(4):
        if modes[i] == luma_mode:
            modes[i] = VDIA
            break
    return modes


_TB_MAX = [0] * 257
for _i in range(1, 257):
    _TB_MAX[_i] = (_i).bit_length() - 1


def write_trunc_bin(enc, symbol: int, max_symbol: int) -> None:
    thresh = _TB_MAX[max_symbol]
    val = 1 << thresh
    b = max_symbol - val
    if symbol < val - b:
        enc.encode_bins_ep(symbol, thresh)
    else:
        symbol += val - b
        enc.encode_bins_ep(symbol >> 1, thresh)
        enc.encode_bin_ep(symbol & 1)


def read_trunc_bin(dec, max_symbol: int) -> int:
    thresh = _TB_MAX[max_symbol]
    val = 1 << thresh
    b = max_symbol - val
    v = dec.decode_bins_ep(thresh) if thresh else 0
    if v >= val - b:
        v = (v << 1) | dec.decode_bin_ep()
        v -= val - b
    return v


# ---------------------------------------------------------------------------
# encode path
# ---------------------------------------------------------------------------

class SyntaxCoder:
    """Encodes/decodes one slice's CTU stream.  Holds slice-level params."""

    def __init__(self, sps, pps, sh, qp_state: QpState, ref_pics=None,
                 ref_pocs=None, tmvp=None, cur_poc=None, reshape=None):
        self.sps = sps
        self.pps = pps
        self.sh = sh
        self.qp = qp_state
        self.ctu_size = sps.ctu_size
        self.min_qt = sps.min_qt_size[0]
        self.tree_idx = 0 if sh.slice_type == 2 else 1  # SPS constraint set
        if getattr(sh.ph, "partition_override", None):
            # per-picture QTBTT constraints (ph override): shallow-copy the
            # SPS with replaced constraint arrays
            import copy as _copy
            sps = _copy.copy(sps)
            sps.min_qt_size = list(sps.min_qt_size)
            sps.max_mtt_depth = list(sps.max_mtt_depth)
            sps.max_bt_size = list(sps.max_bt_size)
            sps.max_tt_size = list(sps.max_tt_size)
            for idx, (mq, d, bt, tt) in sh.ph.partition_override.items():
                sps.min_qt_size[idx] = mq
                sps.max_mtt_depth[idx] = d
                sps.max_bt_size[idx] = bt
                sps.max_tt_size[idx] = tt
            self.sps = sps
        # full dual tree in intra slices (sps_qtbtt_dual_tree_intra_flag)
        self.dual_tree_intra = bool(getattr(sps, "dual_i_tree", 0)) \
            and sh.slice_type == 2
        # per-64x64-unit luma records for the dual-tree CCLM gate
        # (CU::checkCCLMAllowed): (first split of the 64 node, 64x64-ISP)
        self.luma64 = {}
        self.bit_depth = sps.bit_depth
        # inter state (None for I slices): ref_pics[list][ref] = {comp: plane}
        self.ref_pics = ref_pics or [[], []]
        self.ref_pocs = ref_pocs or [[], []]
        self.num_refs = (len(self.ref_pics[0]), len(self.ref_pics[1]))
        self.is_b = sh.slice_type == 0
        self.is_intra_slice = sh.slice_type == 2
        self.mf = None
        self.hmvp = HmvpLut()
        self.tmvp = tmvp
        # implicit MTS: sps_mts on without explicit intra MTS
        # (vvenc SPS::getUseImplicitMTS, Slice.h:804)
        self.implicit_mts = bool(sps.mts and not sps.mts_intra)
        self.sdh = bool(getattr(sh, "sign_data_hiding_used", 0))
        self.jccr = bool(getattr(sps, "joint_cbcr", 0))
        self.jccr_sign = getattr(sh.ph, "joint_cbcr_sign", 0)
        # inter tools
        self.amvr = bool(getattr(sps, "amvr", 0))
        self.bdof_on = bool(getattr(sps, "bdof_present", 0))
        self.dmvr_on = bool(getattr(sps, "dmvr_present", 0))
        self.mmvd = bool(getattr(sps, "mmvd", 0))
        self.smvd_en = bool(getattr(sps, "smvd", 0))
        self.bcw_en = bool(getattr(sps, "bcw", 0))
        # transform skip / BDPCM (SCC)
        self.ts_en = bool(getattr(sps, "transform_skip", 0))
        self.max_ts_size = 1 << getattr(sps, "log2_max_ts_size", 2)
        self.bdpcm_en = bool(getattr(sps, "bdpcm", 0))
        self.min_qp_ts = 4 + 6 * getattr(sps, "internal_minus_input_bit_depth",
                                         0)
        self.ts_rc_disabled = bool(getattr(sh, "ts_residual_coding_disabled",
                                           0))
        self.ibc_en = bool(getattr(sps, "ibc", 0))
        self.max_ibc_merge = getattr(sps, "max_num_ibc_merge_cand", 6)
        from .motion import HmvpLut as _HL
        self.hmvp_ibc = _HL()
        self.geo_en = bool(getattr(sps, "geo", 0))
        self.ciip_en = bool(getattr(sps, "ciip", 0))
        self.max_geo_cand = getattr(sps, "max_num_geo_cand", 0)
        # affine / SbTMVP / PROF (sps_affine_* flags; picHeader
        # maxNumAffineMergeCand derivation EncGOP.cpp:2076)
        self.affine_en = bool(getattr(sps, "affine", 0))
        self.affine_type_en = bool(getattr(sps, "affine_type", 0))
        self.affine_amvr_en = bool(getattr(sps, "affine_amvr", 0))
        self.prof_en = bool(getattr(sps, "prof", 0)) and \
            not getattr(sh.ph, "dis_prof", 0)
        self.sbtmvp_en = bool(getattr(sps, "sbtmvp", 0))
        self.sbtmvp_active = self.sbtmvp_en and tmvp is not None
        if self.affine_en:
            self.max_aff_merge = getattr(sps, "max_num_affine_merge_cand", 5)
        else:
            self.max_aff_merge = 1 if self.sbtmvp_active else 0
        self.pic_w = pps.pic_width
        self.pic_h = pps.pic_height
        self.cur_poc = cur_poc
        # checkLDC: all reference POCs at or before the current picture
        self.check_ldc = bool(
            cur_poc is not None
            and all(p <= cur_poc for li in range(2)
                    for p in self.ref_pocs[li])
            and any(self.ref_pocs[li] for li in range(2)))
        self.bi_dir_pred = False
        self.sym_ref = (-1, -1)
        if (self.smvd_en and self.is_b and cur_poc is not None
                and not self.check_ldc and not sh.ph.mvd_l1_zero):
            self._derive_sym_refs()
        self.dq = bool(getattr(sh, "dep_quant_used", 0))
        # cu_qp_delta (vvenc CABACWriter cuCtx.qp/qgStart/isDQPCoded)
        self.use_dqp = bool(getattr(pps, "cu_qp_delta_enabled", 0))
        self.qg_subdiv = (getattr(sh.ph, "cu_qp_delta_subdiv_intra", 0)
                          if sh.slice_type == 2 else
                          getattr(sh.ph, "cu_qp_delta_subdiv_inter", 0))
        # LMCS (Reshape): reshape is a codec.lmcs.ReshapeState or None.
        # CTU flag semantics per the reference: inter-CU prediction mapping
        # only in non-I slices (EncGOP::xInitLMCS, EncGOP.cpp:2347-2351);
        # chroma scaling in I slices too (DecCu.cpp:161-167).
        self.reshape = reshape
        lmcs_used = reshape is not None and bool(
            getattr(sh, "lmcs_enabled", 0))
        self.lmcs_ctu_flag = lmcs_used and sh.slice_type != 2
        self.lmcs_chroma_scale = (lmcs_used
                                  and bool(getattr(sh.ph,
                                                   "chroma_residual_scale", 0))
                                  and (sh.slice_type == 2
                                       or self.lmcs_ctu_flag))
        self.cur_qp = sh.slice_qp
        self.qg_start = False
        self.dqp_coded = True
        self._qg_cus = []
        self.qg_pred_qp = sh.slice_qp
        self._qg_delta_at = None
        # native CTU writer: decided at the first CTU (None = not yet),
        # with its per-picture arrays
        self._native_writer = None
        self._native_prep = None

    def bdof_applies(self, cu) -> bool:
        """BDOF application condition (vvenc InterPrediction.cpp:465-483,
        CU::isBiPredFromDifferentDirEqDistPoc)."""
        if not self.bdof_on or getattr(self.sh.ph, "dis_bdof", 0):
            return False
        if cu.ref_idx[0] < 0 or cu.ref_idx[1] < 0 or cu.affine or cu.ciip:
            return False
        if cu.smvd or cu.bcw_idx != 2:
            return False
        if min(cu.w, cu.h) < 8 or cu.w * cu.h < 128:
            return False
        poc0 = self.ref_pocs[0][cu.ref_idx[0]]
        poc1 = self.ref_pocs[1][cu.ref_idx[1]]
        return (self.cur_poc - poc0) == (poc1 - self.cur_poc)

    def dmvr_applies(self, cu) -> bool:
        """vvenc CU::checkDMVRCondition (UnitTools.cpp:1300)."""
        if not self.dmvr_on or getattr(self.sh.ph, "dis_dmvr", 0):
            return False
        if not cu.merge or cu.mmvd_flag or cu.affine or cu.geo or cu.ciip:
            return False
        if cu.ref_idx[0] < 0 or cu.ref_idx[1] < 0 or cu.bcw_idx != 2:
            return False
        if min(cu.w, cu.h) < 8 or cu.w * cu.h < 128:
            return False
        poc0 = self.ref_pocs[0][cu.ref_idx[0]]
        poc1 = self.ref_pocs[1][cu.ref_idx[1]]
        return (self.cur_poc - poc0) == (poc1 - self.cur_poc)

    def prepare_refinement(self, ps, cu) -> None:
        """Run DMVR refinement for a candidate CU (what finish_cu will do);
        lets an encoder compute residuals against the refined prediction."""
        cu.dmvr_deltas = cu.dmvr_bdof = None
        if cu.is_inter and self.dmvr_applies(cu):
            from ..ops.dmvr import dmvr_refine
            cu.dmvr_deltas, dmvr_bdof = dmvr_refine(
                self.ref_pics[0][cu.ref_idx[0]][0],
                self.ref_pics[1][cu.ref_idx[1]][0],
                cu.x, cu.y, cu.w, cu.h, cu.mv[0], cu.mv[1],
                self.bit_depth, ps.w, ps.h, self.ctu_size)
            bdof_g = self.bdof_applies(cu)
            cu.dmvr_bdof = {k: (v and bdof_g)
                            for k, v in dmvr_bdof.items()}

    def pred_cu_inter(self, ps, cu, comp, mapped: bool = False):
        """Prediction of one component of a regular inter CU including
        DMVR/BDOF (prepare_refinement must have run for DMVR CUs).
        mapped=True returns the prediction as the reconstruction will use
        it (LMCS forward-mapped luma; CIIP maps its inter part pre-blend)."""
        if comp == 0:
            x, y, w, h = cu.x, cu.y, cu.w, cu.h
        else:
            x, y, w, h = cu.x >> 1, cu.y >> 1, cu.w >> 1, cu.h >> 1
        lmcs_map = (mapped and comp == 0 and self.lmcs_ctu_flag
                    and not cu.is_ibc)

        def _map(p):
            return self.reshape.fwd_lut[p] if lmcs_map else p
        if cu.affine:
            from .affine import affine_predict
            return _map(affine_predict(self, cu, comp))
        if cu.geo:
            from .geo import geo_predict
            return _map(geo_predict(self, cu, comp))
        if cu.ciip:
            from .geo import ciip_blend, ciip_num_intra
            inter = inter_predict(self.ref_pics, cu.mv, cu.ref_idx, x, y,
                                  w, h, comp, self.bit_depth, 2,
                                  cu.alt_hpel)
            if comp != 0 and (cu.w >> 1) <= 2:
                return inter
            inter = _map(inter)   # CIIP maps pre-blend (DecCu.cpp:316)
            intra = predict_cu_component(ps, cu, comp, self.bit_depth,
                                         self.ctu_size)
            return ciip_blend(inter, intra, ciip_num_intra(ps, cu))
        if cu.dmvr_deltas is not None:
            return _map(dmvr_predict(self.ref_pics, cu, comp,
                                     self.bit_depth, ps.w, ps.h,
                                     self.ctu_size))
        if comp == 0 and self.bdof_applies(cu):
            return _map(bdof_predict_luma(
                self.ref_pics[0][cu.ref_idx[0]][0],
                self.ref_pics[1][cu.ref_idx[1]][0], cu, self.bit_depth))
        return _map(inter_predict(self.ref_pics, cu.mv, cu.ref_idx, x, y,
                                  w, h, comp, self.bit_depth, cu.bcw_idx,
                                  cu.alt_hpel))

    def _derive_sym_refs(self):
        """Nearest forward L0 / backward L1 reference pair (vvenc
        Slice::checkBiDirRefs semantics, Slice.cpp:280-356)."""
        cur = self.cur_poc

        def nearest(pocs, forward):
            best, idx = None, -1
            for r, p in enumerate(pocs):
                if forward and p < cur and (best is None or p > best):
                    best, idx = p, r
                if not forward and p > cur and (best is None or p < best):
                    best, idx = p, r
            return best, idx
        f, i0 = nearest(self.ref_pocs[0], True)
        b, i1 = nearest(self.ref_pocs[1], False)
        if f is None or b is None:
            f, i0 = nearest(self.ref_pocs[0], False)
            b2, i1 = nearest(self.ref_pocs[1], True)
            if f is None or b2 is None:
                return
            f, b = b2, f  # forward POC from L1, backward from L0
        if f < cur and b > cur:
            self.bi_dir_pred = True
            self.sym_ref = (i0, i1)

    def attach_motion(self, ps: PictureState):
        """Create the per-picture motion field (once per picture)."""
        if self.mf is None or self.mf.uw != ps.w // 4:
            self.mf = MotionField(ps.w, ps.h)

    def new_ctu_row(self):
        self.hmvp.reset()
        self.hmvp_ibc.reset()

    # -- cu_qp_delta / quantization groups ---------------------------------
    # (vvenc CABACWriter::cu_qp_delta:2173, CU::predictQP UnitTools.cpp:324)
    def _qg_leaf_start(self, ps, x: int, y: int) -> None:
        """Consume qgStart at the first leaf CU of a quantization group:
        finalize the previous QG and derive the QP predictor."""
        if not self.use_dqp or not self.qg_start:
            return
        self._finalize_qg(ps)
        self.qg_start = False
        self.cur_qp = self._predict_qp(ps, x, y)
        self.qg_pred_qp = self.cur_qp
        self._qg_delta_at = None

    def _finalize_qg(self, ps) -> None:
        """Assign per-CU QPs of a finished quantization group: CUs decoded
        BEFORE the coded delta keep the predictor; the delta CU and the
        rest of the group carry the signaled QP (vvenc EncCu::xCheckDQP
        'reset QPs for CUs without residuals up to first coded CU')."""
        cut = self._qg_delta_at if self._qg_delta_at is not None \
            else len(self._qg_cus)
        for i, cu in enumerate(self._qg_cus):
            q = self.qg_pred_qp if i < cut else self.cur_qp
            cu.qp = q
            ps.qp_map[cu.y >> 2:(cu.y + cu.h) >> 2,
                      cu.x >> 2:(cu.x + cu.w) >> 2] = q
        self._qg_cus = []

    def _predict_qp(self, ps, x: int, y: int) -> int:
        mask = self.ctu_size - 1
        in_ctu_a = y & mask
        in_ctu_l = x & mask
        above = ps.qp_at(x, y - 1)
        if x == 0 and not in_ctu_l and not in_ctu_a and above is not None:
            # CTU at tile-left column, CU at CTU origin: inherit from above
            return above
        a = above if in_ctu_a else self.cur_qp
        b = ps.qp_at(x - 1, y) if in_ctu_l else self.cur_qp
        return (a + b + 1) >> 1

    def _wrap_dqp(self, dqp: int) -> int:
        off = self.qp.qp_bd_offset
        return ((dqp + 64 + 32 + off + off // 2) % (64 + off)) - 32 - off // 2

    def _enc_dqp(self, enc, qp: int) -> None:
        dqp = self._wrap_dqp(qp - self.cur_qp)
        abs_dqp = abs(dqp)
        # unary_max_symbol(abs, DeltaQP(0), DeltaQP(1), cMax=5) + EG0 suffix
        for i in range(min(abs_dqp + 1, 5)):
            enc.encode_bin(1 if abs_dqp > i else 0,
                           ct.CTX_SETS["DeltaQP"](0 if i == 0 else 1))
        if abs_dqp >= 5:
            rem, k = abs_dqp - 5, 0
            while rem >= (1 << k):
                enc.encode_bin_ep(1)
                rem -= 1 << k
                k += 1
            enc.encode_bin_ep(0)
            if k:
                enc.encode_bins_ep(rem, k)
        if abs_dqp > 0:
            enc.encode_bin_ep(1 if dqp < 0 else 0)
        off = self.qp.qp_bd_offset
        self.cur_qp = ((self.cur_qp + dqp + 64 + 2 * off) % (64 + off)) - off
        self.dqp_coded = True
        self._qg_delta_at = len(self._qg_cus)

    def _dec_dqp(self, dec) -> None:
        abs_dqp = 0
        if dec.decode_bin(ct.CTX_SETS["DeltaQP"](0)):
            abs_dqp = 1
            while abs_dqp < 5 and dec.decode_bin(ct.CTX_SETS["DeltaQP"](1)):
                abs_dqp += 1
        if abs_dqp == 5:
            k = 0
            while dec.decode_bin_ep():
                abs_dqp += 1 << k
                k += 1
            if k:
                abs_dqp += dec.decode_bins_ep(k)
        if abs_dqp and dec.decode_bin_ep():
            abs_dqp = -abs_dqp
        off = self.qp.qp_bd_offset
        self.cur_qp = ((self.cur_qp + abs_dqp + 64 + 2 * off) % (64 + off)) \
            - off
        self.dqp_coded = True
        self._qg_delta_at = len(self._qg_cus)

    # -- LFNST / explicit-MTS signaling (end of intra coding_unit) ----------
    # (vvenc CABACWriter::residual_lfnst_mode:2403, mts_idx:2351; constraint
    # flags set in residual_coding, CABACWriter.cpp:2288-2334)
    def _residual_tool_stats(self, cu):
        viol = False
        lfnst_last = False
        mts_last = False
        mts_viol = False
        tbs = []
        if cu.isp_mode and cu.isp_coeffs is not None:
            for (px, py, pw, ph), c in zip(
                    isp_partitions(cu.w, cu.h, cu.isp_mode), cu.isp_coeffs):
                tbs.append((pw, ph, c, True))
        elif not cu.chroma_only:
            tbs.append((cu.w, cu.h, cu.coeff_y, True))
        if not cu.luma_only:
            tbs.append((cu.w >> 1, cu.h >> 1, cu.coeff_cb, False))
            tbs.append((cu.w >> 1, cu.h >> 1, cu.coeff_cr, False))
        for w, h, coeff, is_l in tbs:
            if coeff is None or not np.any(coeff):
                continue
            last = scan_pos_last(coeff)
            if w >= 4 and h >= 4:
                maxpos = 7 if ((w == 4 and h == 4)
                               or (w == 8 and h == 8)) else 15
                if last > maxpos:
                    viol = True
                if last >= 1:
                    lfnst_last = True
            if is_l:
                if last >= 1:
                    mts_last = True
                ys, xs = np.nonzero(coeff)
                if ys.size and (int(xs.max()) >= 16 or int(ys.max()) >= 16):
                    mts_viol = True
        return viol, lfnst_last, mts_last, mts_viol

    # -- SBT (sub-block transform; CABACWriter::sbt_mode:1298) ---------------
    def _sbt_allowed_bits(self, cu) -> int:
        """CU::checkAllowedSbt (UnitTools.cpp:249): bit k set for SbtIdx k."""
        if not getattr(self.sps, "sbt", 0) or not cu.is_inter or cu.ciip \
                or cu.is_ibc:
            return 0
        if max(cu.w, cu.h) > self.sps.max_tb_size:
            return 0
        bits = 0
        if cu.w >= 8:
            bits |= 1 << 1   # SBT_VER_HALF
        if cu.h >= 8:
            bits |= 1 << 2   # SBT_HOR_HALF
        if cu.w >= 16:
            bits |= 1 << 3   # SBT_VER_QUAD
        if cu.h >= 16:
            bits |= 1 << 4   # SBT_HOR_QUAD
        return bits

    def _code_sbt_mode(self, coder, cu, encode: bool) -> None:
        bits = self._sbt_allowed_bits(cu)
        if not bits:
            return
        ctx = 1 if cu.w * cu.h <= 256 else 0
        if encode:
            coder.encode_bin(1 if cu.sbt_idx else 0,
                             ct.CTX_SETS["SbtFlag"](ctx))
            if not cu.sbt_idx:
                return
        else:
            if not coder.decode_bin(ct.CTX_SETS["SbtFlag"](ctx)):
                return
        half_allow = bool(bits & 0b00110)
        quad_allow = bool(bits & 0b11000)
        quad = False
        if half_allow and quad_allow:
            if encode:
                quad = cu.sbt_idx in (3, 4)
                coder.encode_bin(1 if quad else 0,
                                 ct.CTX_SETS["SbtQuadFlag"](0))
            else:
                quad = bool(coder.decode_bin(ct.CTX_SETS["SbtQuadFlag"](0)))
        elif quad_allow:
            quad = True
        ver_a = bool(bits & (1 << (3 if quad else 1)))
        hor_a = bool(bits & (1 << (4 if quad else 2)))
        if ver_a and hor_a:
            hctx = 0 if cu.w == cu.h else (1 if cu.w < cu.h else 2)
            if encode:
                hor = cu.sbt_idx in (2, 4)
                coder.encode_bin(1 if hor else 0,
                                 ct.CTX_SETS["SbtHorFlag"](hctx))
            else:
                hor = bool(coder.decode_bin(ct.CTX_SETS["SbtHorFlag"](hctx)))
        else:
            hor = hor_a
        if encode:
            coder.encode_bin(cu.sbt_pos, ct.CTX_SETS["SbtPosFlag"](0))
        else:
            cu.sbt_pos = coder.decode_bin(ct.CTX_SETS["SbtPosFlag"](0))
            cu.sbt_idx = (2 if hor else 1) + (2 if quad else 0)

    # -- transform skip / BDPCM ---------------------------------------------
    def _ts_allowed(self, cu, comp: int) -> bool:
        """TU::isTSAllowed (UnitTools.cpp:3593)."""
        if not self.ts_en or cu.sbt_idx:
            return False
        if comp == 0 and (cu.isp_mode or cu.bdpcm_y):
            return False
        if comp != 0 and cu.bdpcm_c:
            return False
        sc = 0 if comp == 0 else 1
        return (cu.w >> sc) <= self.max_ts_size and \
            (cu.h >> sc) <= self.max_ts_size

    def _code_ts_flag(self, coder, cu, comp: int, encode: bool) -> bool:
        """ts_flag (CABACWriter::ts_flag:2338); BDPCM implies skip."""
        if (cu.bdpcm_y if comp == 0 else cu.bdpcm_c):
            return True
        if not self._ts_allowed(cu, comp):
            return False
        ctx = 0 if comp == 0 else 1
        cur = (cu.ts_y, cu.ts_cb, cu.ts_cr)[comp]
        if encode:
            coder.encode_bin(1 if cur else 0,
                             ct.CTX_SETS["TransformSkipFlag"](ctx))
            return cur
        v = bool(coder.decode_bin(ct.CTX_SETS["TransformSkipFlag"](ctx)))
        if comp == 0:
            cu.ts_y = v
        elif comp == 1:
            cu.ts_cb = v
        else:
            cu.ts_cr = v
        return v

    def _residual_tb(self, coder, cu, comp: int, w: int, h: int,
                     encode: bool, coeff=None):
        """One TB: ts_flag + residual coding (regular or TSRC)."""
        from ..bitstream.residual import (encode_residual_ts,
                                          decode_residual_ts)
        ts = self._code_ts_flag(coder, cu, comp, encode)
        bd = cu.bdpcm_y if comp == 0 else cu.bdpcm_c
        use_ts_rc = ts and not self.ts_rc_disabled
        if encode:
            if use_ts_rc:
                encode_residual_ts(coder, coeff, comp == 0, bd)
            else:
                encode_residual(coder, coeff, comp == 0, dep_quant=self.dq,
                                sign_hiding=self.sdh)
            return None
        if use_ts_rc:
            return decode_residual_ts(coder, w, h, comp == 0, bd)
        return decode_residual(coder, w, h, comp == 0, dep_quant=self.dq,
                               sign_hiding=self.sdh)

    def _code_bdpcm_modes(self, coder, cu, encode: bool,
                          chroma: bool) -> None:
        """bdpcm_mode (CABACWriter::bdpcm_mode:799)."""
        if not self.bdpcm_en:
            return
        sc = 1 if chroma else 0
        if (cu.w >> sc) > self.max_ts_size or (cu.h >> sc) > self.max_ts_size:
            return
        base = 2 if chroma else 0
        mode = cu.bdpcm_c if chroma else cu.bdpcm_y
        if encode:
            coder.encode_bin(1 if mode else 0,
                             ct.CTX_SETS["BDPCMMode"](base))
            if mode:
                coder.encode_bin(1 if mode > 1 else 0,
                                 ct.CTX_SETS["BDPCMMode"](base + 1))
            return
        if coder.decode_bin(ct.CTX_SETS["BDPCMMode"](base)):
            mode = 1 + coder.decode_bin(ct.CTX_SETS["BDPCMMode"](base + 1))
            if chroma:
                cu.bdpcm_c = mode
            else:
                cu.bdpcm_y = mode
                cu.luma_mode = VER if mode == 2 else HOR

    def _isp_coded(self, cu) -> bool:
        """isp_mode signalling condition (CABACWriter::isp_mode:2385,
        CU::canUseISP:441)."""
        if cu.is_inter or cu.chroma_only or cu.mip_flag or cu.ref_line:
            return False
        if not getattr(self.sps, "isp", 0):
            return False
        max_tb = self.sps.max_tb_size
        if cu.w > max_tb or cu.h > max_tb:
            return False
        return (cu.w.bit_length() - 1) + (cu.h.bit_length() - 1) > 4

    # -- ISP transform-unit loop (CABACWriter::transform_unit ISP path) -----
    def _code_isp_tus(self, coder, cu, encode: bool) -> None:
        parts = isp_partitions(cu.w, cu.h, cu.isp_mode)
        n = len(parts)
        with_chroma = not cu.luma_only
        if encode:
            cbfs = [cu.isp_coeffs[k] is not None and
                    bool(np.any(cu.isp_coeffs[k])) for k in range(n)]
        else:
            cu.isp_coeffs = [None] * n
            cbfs = [False] * n
        dqp_done = False
        for k, (px, py, pw, ph) in enumerate(parts):
            is_last = k == n - 1
            cbf_cb = cbf_cr = False
            if is_last and with_chroma:
                if encode:
                    if cu.joint_cbcr:
                        cbf_cb = bool(cu.joint_cbcr & 2)
                        cbf_cr = bool(cu.joint_cbcr & 1)
                    else:
                        cbf_cb = cu.coeff_cb is not None and \
                            bool(np.any(cu.coeff_cb))
                        cbf_cr = cu.coeff_cr is not None and \
                            bool(np.any(cu.coeff_cr))
                    coder.encode_bin(1 if cbf_cb else 0,
                                     ct.CTX_SETS["QtCbfCb"](0))
                    coder.encode_bin(1 if cbf_cr else 0,
                                     ct.CTX_SETS["QtCbfCr"](1 if cbf_cb
                                                            else 0))
                else:
                    cbf_cb = bool(coder.decode_bin(ct.CTX_SETS["QtCbfCb"](0)))
                    cbf_cr = bool(coder.decode_bin(
                        ct.CTX_SETS["QtCbfCr"](1 if cbf_cb else 0)))
            # luma cbf: ctx 2+prevCbf; last inferred 1 if all previous 0
            inferred = is_last and not any(cbfs[:k])
            prev = cbfs[k - 1] if k else False
            if inferred:
                cbfs[k] = True
            elif encode:
                coder.encode_bin(1 if cbfs[k] else 0,
                                 ct.CTX_SETS["QtCbfLuma"](2 + int(prev)))
            else:
                cbfs[k] = bool(coder.decode_bin(
                    ct.CTX_SETS["QtCbfLuma"](2 + int(prev))))
            if not dqp_done and (cbfs[k] or cbf_cb or cbf_cr):
                self._maybe_code_dqp(coder, cu, True, encode=encode)
                dqp_done = True
            jccr_mask = (2 if cbf_cb else 0) + (1 if cbf_cr else 0)
            if is_last and with_chroma and self.jccr and jccr_mask:
                if encode:
                    coder.encode_bin(1 if cu.joint_cbcr else 0,
                                     ct.CTX_SETS["JointCbCrFlag"](
                                         jccr_mask - 1))
                elif coder.decode_bin(ct.CTX_SETS["JointCbCrFlag"](
                        jccr_mask - 1)):
                    cu.joint_cbcr = jccr_mask
            if cbfs[k]:
                if encode:
                    encode_residual(coder, cu.isp_coeffs[k], True,
                                    dep_quant=self.dq)
                else:
                    cu.isp_coeffs[k] = decode_residual(
                        coder, pw, ph, True, dep_quant=self.dq,
                        sign_hiding=self.sdh)
            if is_last and with_chroma:
                # chroma TBs go through the regular TB path so that the
                # transform_skip flag is coded when TS is allowed for the
                # chroma size (ISP restricts TS for luma only,
                # TU::isTSAllowed — missing this desyncs when
                # max_ts_size >= the chroma TB size)
                cw, chh = cu.w >> 1, cu.h >> 1
                if cu.joint_cbcr:
                    cc = 1 if cu.joint_cbcr in (2, 3) else 2
                    if encode:
                        coded = cu.coeff_cb if cc == 1 else cu.coeff_cr
                        self._residual_tb(coder, cu, cc, cw, chh, True,
                                          coded)
                    else:
                        coded = self._residual_tb(coder, cu, cc, cw, chh,
                                                  False)
                        if cc == 1:
                            cu.coeff_cb = coded
                        else:
                            cu.coeff_cr = coded
                else:
                    if cbf_cb:
                        if encode:
                            self._residual_tb(coder, cu, 1, cw, chh, True,
                                              cu.coeff_cb)
                        else:
                            cu.coeff_cb = self._residual_tb(
                                coder, cu, 1, cw, chh, False)
                    if cbf_cr:
                        if encode:
                            self._residual_tb(coder, cu, 2, cw, chh, True,
                                              cu.coeff_cr)
                        else:
                            cu.coeff_cr = self._residual_tb(
                                coder, cu, 2, cw, chh, False)

    def _code_max_tb_tus(self, coder, cu, encode: bool) -> None:
        """Implicit max-TB TU tiling of an inter CU larger than the max
        transform size (VVC 7.3.11.9 transform_tree TU_MAX_TR_SPLIT;
        vvenc CABACWriter::transform_tree maxTrSplit path): each maxTB
        tile codes cbf_cb / cbf_cr / cbf_luma explicitly (trDepth > 0)."""
        sw = min(cu.w, MAX_TB)
        sh_ = min(cu.h, MAX_TB)
        if not encode:
            cu.mtb_tus = []
        for k, (tx, ty) in enumerate(
                [(tx, ty) for ty in range(0, cu.h, sh_)
                 for tx in range(0, cu.w, sw)]):
            if encode:
                (_, _, _, _, cy_, ccb, ccr, joint,
                 _tscb, _tscr) = cu.mtb_tus[k]
            else:
                cy_ = ccb = ccr = None
                joint = 0
            cbf_cb = (ccb is not None or joint in (2, 3)) if encode else 0
            cbf_cr = (ccr is not None or joint in (1, 3)) if encode else 0
            if encode:
                coder.encode_bin(1 if cbf_cb else 0,
                                 ct.CTX_SETS["QtCbfCb"](0))
                coder.encode_bin(1 if cbf_cr else 0,
                                 ct.CTX_SETS["QtCbfCr"](1 if cbf_cb else 0))
                cbf_y = cy_ is not None
                coder.encode_bin(1 if cbf_y else 0,
                                 ct.CTX_SETS["QtCbfLuma"](0))
            else:
                cbf_cb = coder.decode_bin(ct.CTX_SETS["QtCbfCb"](0))
                cbf_cr = coder.decode_bin(
                    ct.CTX_SETS["QtCbfCr"](1 if cbf_cb else 0))
                cbf_y = coder.decode_bin(ct.CTX_SETS["QtCbfLuma"](0))
            self._maybe_code_dqp(coder, cu, bool(cbf_y or cbf_cb or cbf_cr),
                                 encode=encode)
            mask = (2 if cbf_cb else 0) + (1 if cbf_cr else 0)
            if self.jccr and mask == 3:
                if encode:
                    coder.encode_bin(1 if joint else 0,
                                     ct.CTX_SETS["JointCbCrFlag"](mask - 1))
                elif coder.decode_bin(ct.CTX_SETS["JointCbCrFlag"](
                        mask - 1)):
                    joint = mask
            if encode:
                ts_cb, ts_cr = cu.mtb_tus[k][8], cu.mtb_tus[k][9]
            else:
                ts_cb = ts_cr = False
            ts_ok = (self.ts_en and (sw >> 1) <= self.max_ts_size
                     and (sh_ >> 1) <= self.max_ts_size)

            def _ts_flag(cur: bool, comp: int) -> bool:
                # per-TU transform_skip flag (chroma TBs within the max-TB
                # size; luma TUs are always maxTB > maxTsSize)
                if not ts_ok:
                    return False
                cset = ct.CTX_SETS["TransformSkipFlag"](1)
                if encode:
                    coder.encode_bin(1 if cur else 0, cset)
                    return cur
                return bool(coder.decode_bin(cset))

            def _resid(data, is_luma, ww, hh, ts):
                use_ts = ts and not self.ts_rc_disabled
                if encode:
                    if use_ts:
                        from ..bitstream.residual import encode_residual_ts
                        encode_residual_ts(coder, data, is_luma, 0)
                    else:
                        encode_residual(coder, data, is_luma,
                                        dep_quant=self.dq,
                                        sign_hiding=self.sdh)
                    return data
                if use_ts:
                    from ..bitstream.residual import decode_residual_ts
                    return decode_residual_ts(coder, ww, hh, is_luma, 0)
                return decode_residual(coder, ww, hh, is_luma,
                                       dep_quant=self.dq,
                                       sign_hiding=self.sdh)
            if cbf_y:
                cy_ = _resid(cy_, True, sw, sh_, False)
            if joint:
                cc = 1 if joint in (2, 3) else 2
                ts_j = _ts_flag(ts_cb if cc == 1 else ts_cr, cc)
                if cc == 1:
                    ts_cb = ts_j
                else:
                    ts_cr = ts_j
                cdat = _resid(ccb if cc == 1 else ccr, False,
                              sw >> 1, sh_ >> 1, ts_j)
                if cc == 1:
                    ccb = cdat
                else:
                    ccr = cdat
            else:
                if cbf_cb:
                    ts_cb = _ts_flag(ts_cb, 1)
                    ccb = _resid(ccb, False, sw >> 1, sh_ >> 1, ts_cb)
                if cbf_cr:
                    ts_cr = _ts_flag(ts_cr, 2)
                    ccr = _resid(ccr, False, sw >> 1, sh_ >> 1, ts_cr)
            if not encode:
                cu.mtb_tus.append((tx, ty, sw, sh_, cy_, ccb, ccr, joint,
                                   ts_cb, ts_cr))

    def _lfnst_allowed(self, cu) -> bool:
        if not self.sps.lfnst or cu.is_inter:
            return False
        if cu.isp_mode:
            # LFNST with ISP only if the partitions are >= 4x4
            # (CU::canUseLfnstWithISP, UnitTools.cpp:452)
            _, _, pw, ph = isp_partitions(cu.w, cu.h, cu.isp_mode)[0]
            if pw < 4 or ph < 4:
                return False
        if cu.mip_flag and not (cu.w >= 16 and cu.h >= 16):
            return False
        if cu.chroma_only and min(cu.w >> 1, cu.h >> 1) < 4:
            return False
        if cu.w > 64 or cu.h > 64:  # max TB size
            return False
        return True

    def _code_lfnst_mts(self, coder, cu, encode: bool) -> None:
        if cu.is_inter:
            return
        viol, lfnst_last, mts_last, mts_viol = self._residual_tool_stats(cu)
        if cu.isp_mode:
            # the lfnstLastScanPos gate is bypassed for ISP
            # (CABACWriter::residual_lfnst_mode:2436)
            lfnst_last = True
        # a transform-skip TU blocks LFNST only if its cbf is set
        # (residual_lfnst_mode isTrSkip: getCbf && mtsIdx == MTS_SKIP,
        # CABACWriter.cpp:2423-2433)
        def _cbf(c):
            return c is not None and bool(np.any(c))
        cbf_y = (any(_cbf(c) for c in (cu.isp_coeffs or []))
                 if cu.isp_mode else _cbf(cu.coeff_y))
        cbf_cb = _cbf(cu.coeff_cb) or cu.joint_cbcr in (2, 3)
        cbf_cr = _cbf(cu.coeff_cr) or cu.joint_cbcr in (1, 3)
        is_tr_skip = (((cu.ts_y or cu.bdpcm_y) and cbf_y)
                      or ((cu.ts_cb or cu.bdpcm_c) and cbf_cb)
                      or ((cu.ts_cr or cu.bdpcm_c) and cbf_cr))
        if is_tr_skip:
            lfnst_last = False    # no LFNST with a coded transform-skip TU
        sep_tree = cu.luma_only or cu.chroma_only
        if self._lfnst_allowed(cu) and lfnst_last and not viol:
            cctx = 1 if sep_tree else 0
            if encode:
                coder.encode_bin(1 if cu.lfnst_idx else 0,
                                 ct.CTX_SETS["LFNSTIdx"](cctx))
                if cu.lfnst_idx:
                    coder.encode_bin(cu.lfnst_idx - 1,
                                     ct.CTX_SETS["LFNSTIdx"](2))
            else:
                if coder.decode_bin(ct.CTX_SETS["LFNSTIdx"](cctx)):
                    cu.lfnst_idx = 2 if coder.decode_bin(
                        ct.CTX_SETS["LFNSTIdx"](2)) else 1
        # tu_mts_idx (intra explicit MTS; luma TBs only; never for ISP/TS)
        if (self.sps.mts_intra and not cu.chroma_only and not cu.isp_mode
                and not cu.ts_y and not cu.bdpcm_y
                and cu.w <= 32 and cu.h <= 32 and mts_last and not mts_viol
                and cu.lfnst_idx == 0):
            if encode:
                coder.encode_bin(1 if cu.mts_idx else 0,
                                 ct.CTX_SETS["MTSIdx"](0))
                if cu.mts_idx:
                    for i in range(3):
                        sym = 1 if cu.mts_idx > i + 1 else 0
                        coder.encode_bin(sym, ct.CTX_SETS["MTSIdx"](i + 1))
                        if not sym:
                            break
            else:
                if coder.decode_bin(ct.CTX_SETS["MTSIdx"](0)):
                    cu.mts_idx = 1
                    for i in range(3):
                        if not coder.decode_bin(ct.CTX_SETS["MTSIdx"](i + 1)):
                            break
                        cu.mts_idx += 1

    def _maybe_code_dqp(self, coder, cu, any_cbf: bool, encode: bool) -> None:
        """cu_qp_delta gate at the (single) TU of a CU (vvenc
        CABACWriter::transform_unit:2135-2145)."""
        if not self.use_dqp or self.dqp_coded or cu.chroma_only:
            return
        if any_cbf or cu.w > 64 or cu.h > 64:
            if encode:
                self._enc_dqp(coder, cu.qp if cu.qp >= 0 else self.cur_qp)
            else:
                self._dec_dqp(coder)

    # -- encoding ----------------------------------------------------------
    def encode_ctu(self, enc, ps: PictureState, node: TreeNode) -> None:
        """Encode one CTU's coding tree; reconstructs into ps as it goes
        (the encoder relies on ps for neighbor-dependent syntax).

        A CTU that the native search decided, in a slice whose tools the
        native writer covers (native.ctu_writer.covers, decided once a
        picture), is coded by the native writer in one call that releases
        the GIL; every other CTU by the Python writer below, the
        specification the native one is held to."""
        from ..native import ctu_writer
        if self._native_writer is None:
            self._native_writer = ctu_writer.covers(self, ps)
        if self._native_writer and node.native_rec is not None:
            ctu_writer.write_ctu(self, enc, ps, node)
            ctu_writer.count("native")
            return
        ctu_writer.count("python")
        self._encode_ctu_py(enc, ps, node)

    def _encode_ctu_py(self, enc, ps: PictureState, node: TreeNode) -> None:
        if self.dual_tree_intra:
            # the QG-start rule fires at the CTU root (cbSubdiv 0 <=
            # qg_subdiv); the dual-tree unit loop skips that root node,
            # so open the quantization group here — without this a
            # 128-CTU dual-tree slice never codes cu_qp_delta (the
            # search quantizes at the per-CTU QP while the decoder
            # dequantizes at the predicted slice QP: ~25 dB loss)
            if self.use_dqp:
                self.qg_start = True
                self.dqp_coded = False
            for child in node.children:
                self._enc_tree(enc, ps, child)
        else:
            self._enc_tree(enc, ps, node)
        if self.use_dqp:
            self._finalize_qg(ps)

    def _enc_tree(self, enc, ps, node: TreeNode) -> None:
        x, y, w, h = node.x, node.y, node.w, node.h
        part = node.part
        if self.use_dqp and part.subdiv <= self.qg_subdiv \
                and part.tree_type not in (TREE_C, CHROMA_TREE):
            self.qg_start = True
            self.dqp_coded = False
        tidx = 2 if part.tree_type == CHROMA_TREE else self.tree_idx
        write_split_mode(enc, ps, x, y, w, h, part, self.sps,
                         node.split_mode, tidx)
        if self.dual_tree_intra and part.tree_type == TREE_L \
                and part.last_split == -1:
            self.luma64[(x, y)] = [
                node.split_mode,
                bool(node.cu.isp_mode) if node.cu is not None else False]
        if node.split_mode == NO_SPLIT:
            if part.tree_type == CHROMA_TREE:
                self._enc_chroma_cu(enc, ps, node.cu, part)
                return
            self._qg_leaf_start(ps, x, y)
            self._enc_cu(enc, ps, node)
            if self.use_dqp:
                self._qg_cus.append(node.cu)
            return
        # SCIPU mode constraint (mirror of _dec_tree)
        val = signal_mode_cons(w, h, node.split_mode, part.mode_type,
                               self.is_intra_slice)
        if val == LDT_SIGNAL:
            child_mt = node.mode_type_child
            assert child_mt in (MODE_INTER, MODE_INTRA)
            ctx = self._pred_mode_ctx(ps, x, y)
            enc.encode_bin(1 if child_mt == MODE_INTRA else 0,
                           ct.CTX_SETS["ModeConsFlag"](ctx))
        elif val == LDT_INFER:
            child_mt = MODE_INTRA
        else:
            child_mt = part.mode_type
        chroma_not_split = (part.mode_type == MODE_ALL
                            and child_mt == MODE_INTRA)
        assert not chroma_not_split or node.chroma_cu is not None, \
            "SCIPU split without region chroma CU (searcher must either " \
            "prune the split or build the local dual tree)"
        ci = 0
        for idx, (cx, cy, cw, chh) in enumerate(
                split_geometry(node.split_mode, x, y, w, h)):
            if cx >= ps.w or cy >= ps.h:
                continue
            child = node.children[ci]
            ci += 1
            assert (child.x, child.y, child.w, child.h) == (cx, cy, cw, chh)
            child.part.mode_type = child_mt
            child.part.tree_type = TREE_L if chroma_not_split \
                else part.tree_type
            # QG subdiv mirror of PartInfo.child (searcher-built parts may
            # not have threaded it)
            if node.split_mode == QT_SPLIT:
                child.part.subdiv = part.subdiv + 2
            else:
                child.part.subdiv = part.subdiv + (
                    2 if node.split_mode in (TT_H, TT_V) and idx != 1 else 1)
            self._enc_tree(enc, ps, child)
        assert ci == len(node.children)
        if chroma_not_split:
            self._enc_chroma_cu(enc, ps, node.chroma_cu, part)

    def _enc_chroma_cu(self, enc, ps, cu: CuData, part: PartInfo) -> None:
        """Mirror of _dec_chroma_cu (TREE_C region chroma)."""
        self._code_bdpcm_modes(enc, cu, encode=True, chroma=True)
        if not cu.bdpcm_c:
            self._enc_intra_chroma_mode(enc, cu)
        if cu.joint_cbcr:
            cbf_cb = bool(cu.joint_cbcr & 2)
            cbf_cr = bool(cu.joint_cbcr & 1)
        else:
            cbf_cb = cu.coeff_cb is not None and np.any(cu.coeff_cb)
            cbf_cr = cu.coeff_cr is not None and np.any(cu.coeff_cr)
        enc.encode_bin(1 if cbf_cb else 0, ct.CTX_SETS["QtCbfCb"](
            1 if cu.bdpcm_c else 0))
        enc.encode_bin(1 if cbf_cr else 0,
                       ct.CTX_SETS["QtCbfCr"](
                           2 if cu.bdpcm_c else (1 if cbf_cb else 0)))
        mask = (2 if cbf_cb else 0) + (1 if cbf_cr else 0)
        if self.jccr and not cu.bdpcm_c and mask:
            enc.encode_bin(1 if cu.joint_cbcr else 0,
                           ct.CTX_SETS["JointCbCrFlag"](mask - 1))
        if cu.joint_cbcr:
            cc = 1 if cu.joint_cbcr in (2, 3) else 2
            coded = cu.coeff_cb if cu.joint_cbcr in (2, 3) else cu.coeff_cr
            self._residual_tb(enc, cu, cc, cu.w >> 1, cu.h >> 1, True, coded)
        else:
            if cbf_cb:
                self._residual_tb(enc, cu, 1, cu.w >> 1, cu.h >> 1, True,
                                  cu.coeff_cb)
            if cbf_cr:
                self._residual_tb(enc, cu, 2, cu.w >> 1, cu.h >> 1, True,
                                  cu.coeff_cr)
        self._code_lfnst_mts(enc, cu, encode=True)
        self.finish_cu(ps, cu, part.qt_depth, comps=(1, 2))

    def _enc_cu(self, enc, ps, node: TreeNode) -> None:
        cu = node.cu
        w, h = node.w, node.h
        assert (w, h) == (cu.w, cu.h), (w, h, cu.w, cu.h)
        mt = node.part.mode_type
        cu.luma_only = node.part.tree_type == TREE_L
        is_4x4 = w == 4 and h == 4
        # mirror of _dec_tree's cu_skip_flag / pred_mode / IBC structure
        intra_like = self.is_intra_slice or mt == MODE_INTRA
        ibc_sz = self.ibc_en and w < 128 and h < 128
        if intra_like:
            if ibc_sz:
                ctx_skip = self._skip_ctx(ps, cu.x, cu.y)
                enc.encode_bin(1 if cu.skip else 0,
                               ct.CTX_SETS["SkipFlag"](ctx_skip))
                if cu.skip:
                    assert cu.is_ibc
                    self._enc_ibc_merge_idx(enc, cu.merge_idx)
                    self._finish_cu(ps, cu, node)
                    return
        elif not is_4x4 or self.ibc_en:
            ctx_skip = self._skip_ctx(ps, cu.x, cu.y)
            enc.encode_bin(1 if cu.skip else 0,
                           ct.CTX_SETS["SkipFlag"](ctx_skip))
            if cu.skip:
                if self.ibc_en and mt != MODE_INTER and not is_4x4 \
                        and ibc_sz:
                    enc.encode_bin(1 if cu.is_ibc else 0,
                                   ct.CTX_SETS["IBCFlag"](
                                       self._ibc_ctx(ps, cu.x, cu.y)))
                if cu.is_ibc:
                    self._enc_ibc_merge_idx(enc, cu.merge_idx)
                else:
                    self._enc_merge_data(enc, ps, cu)
                self._finish_cu(ps, cu, node)
                return
        if intra_like or is_4x4:
            if ibc_sz and mt != MODE_INTER:
                enc.encode_bin(1 if cu.is_ibc else 0,
                               ct.CTX_SETS["IBCFlag"](
                                   self._ibc_ctx(ps, cu.x, cu.y)))
            assert cu.is_ibc or not cu.is_inter
        elif mt == MODE_INTER:
            assert cu.is_inter
        else:
            ctx_pm = self._pred_mode_ctx(ps, cu.x, cu.y)
            enc.encode_bin(0 if cu.is_inter else 1,
                           ct.CTX_SETS["PredMode"](ctx_pm))
            if cu.is_inter and ibc_sz:
                enc.encode_bin(1 if cu.is_ibc else 0,
                               ct.CTX_SETS["IBCFlag"](
                                   self._ibc_ctx(ps, cu.x, cu.y)))
        if not cu.is_inter:
            self._code_bdpcm_modes(enc, cu, encode=True, chroma=False)
            if not cu.bdpcm_y:
                self._enc_intra_luma_mode(enc, ps, cu)
            if not cu.luma_only:
                self._code_bdpcm_modes(enc, cu, encode=True, chroma=True)
                if not cu.bdpcm_c:
                    self._enc_intra_chroma_mode(enc, cu)
        else:
            enc.encode_bin(1 if cu.merge else 0, ct.CTX_SETS["MergeFlag"](0))
            if cu.merge and cu.is_ibc:
                self._enc_ibc_merge_idx(enc, cu.merge_idx)
            elif cu.merge:
                self._enc_merge_data(enc, ps, cu)
            elif cu.is_ibc:
                # IBC AMVP: BVD + mvp_flag + IBC AMVR
                self._enc_mvd(enc, cu.mvd)
                if self.max_ibc_merge > 1:
                    enc.encode_bin(cu.mvp_idx, ct.CTX_SETS["MVPIdx"](0))
                if self.amvr and cu.mvd != (0, 0):
                    enc.encode_bin(1 if cu.imv == 2 else 0,
                                   ct.CTX_SETS["ImvFlag"](1))
            else:
                inter_dir = (1 if cu.ref_idx[0] >= 0 else 0) | \
                            (2 if cu.ref_idx[1] >= 0 else 0)
                if self.is_b:
                    # 4x8/8x4 cannot be bi-predicted: the bi bin is not
                    # coded (vvenc CABACWriter::inter_pred_idc:1785,
                    # CU::isBipredRestriction:2220)
                    if cu.w + cu.h > 12:
                        ctx = 7 - (((cu.w * cu.h).bit_length() - 1 + 1) >> 1)
                        enc.encode_bin(1 if inter_dir == 3 else 0,
                                       ct.CTX_SETS["InterDir"](ctx))
                    if inter_dir != 3:
                        enc.encode_bin(1 if inter_dir == 2 else 0,
                                       ct.CTX_SETS["InterDir"](5))
                # inter_affine_flag / cu_affine_type_flag
                # (vvenc CABACWriter::affine_flag:1512)
                if not self.is_intra_slice and self.affine_en \
                        and cu.w > 8 and cu.h > 8:
                    enc.encode_bin(1 if cu.affine else 0,
                                   ct.CTX_SETS["AffineFlag"](
                                       self._aff_ctx(ps, cu.x, cu.y)))
                    if cu.affine and self.affine_type_en:
                        enc.encode_bin(cu.affine_type,
                                       ct.CTX_SETS["AffineType"](0))
                # sym_mvd_flag (vvenc CABACWriter::smvd_mode:1798)
                if inter_dir == 3 and self.bi_dir_pred and not cu.affine:
                    enc.encode_bin(1 if cu.smvd else 0,
                                   ct.CTX_SETS["SmvdFlag"](0))
                n_cp = (3 if cu.affine_type else 2) if cu.affine else 1
                if inter_dir != 2:
                    if not cu.smvd and self.num_refs[0] > 1:
                        self._enc_ref_idx(enc, cu.ref_idx[0], self.num_refs[0])
                    if cu.affine:
                        for i in range(n_cp):
                            self._enc_mvd(enc, cu.aff_mvds[0][i])
                    else:
                        self._enc_mvd(enc, cu.mvd)
                    enc.encode_bin(cu.mvp_idx, ct.CTX_SETS["MVPIdx"](0))
                if inter_dir != 1:
                    if not cu.smvd:
                        if self.num_refs[1] > 1:
                            self._enc_ref_idx(enc, cu.ref_idx[1],
                                              self.num_refs[1])
                        if not (self.sh.ph.mvd_l1_zero and inter_dir == 3):
                            if cu.affine:
                                for i in range(n_cp):
                                    self._enc_mvd(enc, cu.aff_mvds[1][i])
                            else:
                                self._enc_mvd(enc, cu.mvd_l1)
                    enc.encode_bin(cu.mvp_idx_l1, ct.CTX_SETS["MVPIdx"](0))
                if not cu.affine:
                    self._enc_imv(enc, cu)
                else:
                    self._enc_affine_amvr(enc, cu)
                self._enc_bcw(enc, cu, inter_dir)
        # residual
        if cu.is_inter and not cu.merge:
            enc.encode_bin(1 if cu.root_cbf else 0,
                           ct.CTX_SETS["QtRootCbf"](0))
        if cu.is_inter and cu.root_cbf:
            self._code_sbt_mode(enc, cu, encode=True)
        if cu.isp_mode:
            self._code_isp_tus(enc, cu, encode=True)
            self._code_lfnst_mts(enc, cu, encode=True)
            self._finish_cu(ps, cu, node)
            return
        if cu.is_inter and cu.root_cbf and (w > MAX_TB or h > MAX_TB):
            self._code_max_tb_tus(enc, cu, encode=True)
            self._finish_cu(ps, cu, node)
            return
        if (not cu.is_inter or cu.root_cbf) and cu.luma_only:
            cbf_y = cu.coeff_y is not None and np.any(cu.coeff_y)
            if cu.is_inter:
                assert cbf_y, "luma-only inter/IBC cbf inferred 1"
            else:
                enc.encode_bin(1 if cbf_y else 0, ct.CTX_SETS["QtCbfLuma"](
                    1 if cu.bdpcm_y else 0))
            self._maybe_code_dqp(enc, cu, bool(cbf_y), encode=True)
            if cbf_y:
                self._residual_tb(enc, cu, 0, w, h, True, cu.coeff_y)
            self._code_lfnst_mts(enc, cu, encode=True)
            self._finish_cu(ps, cu, node)
            return
        if not cu.is_inter or cu.root_cbf:
            if cu.joint_cbcr:
                cbf_cb = bool(cu.joint_cbcr & 2)
                cbf_cr = bool(cu.joint_cbcr & 1)
            else:
                cbf_cb = cu.coeff_cb is not None and np.any(cu.coeff_cb)
                cbf_cr = cu.coeff_cr is not None and np.any(cu.coeff_cr)
            cbf_y = cu.coeff_y is not None and np.any(cu.coeff_y)
            enc.encode_bin(1 if cbf_cb else 0, ct.CTX_SETS["QtCbfCb"](
                1 if cu.bdpcm_c else 0))
            enc.encode_bin(1 if cbf_cr else 0,
                           ct.CTX_SETS["QtCbfCr"](
                               2 if cu.bdpcm_c else (1 if cbf_cb else 0)))
            if cu.is_inter and not cbf_cb and not cbf_cr:
                assert cbf_y, "inter luma cbf inferred 1 needs coefficients"
            else:
                enc.encode_bin(1 if cbf_y else 0, ct.CTX_SETS["QtCbfLuma"](
                    1 if cu.bdpcm_y else 0))
            self._maybe_code_dqp(enc, cu, bool(cbf_y or cbf_cb or cbf_cr),
                                 encode=True)
            mask = (2 if cbf_cb else 0) + (1 if cbf_cr else 0)
            if self.jccr and not cu.bdpcm_c and \
                    ((not cu.is_inter and mask) or mask == 3):
                enc.encode_bin(1 if cu.joint_cbcr else 0,
                               ct.CTX_SETS["JointCbCrFlag"](mask - 1))
            if cbf_y:
                self._residual_tb(enc, cu, 0, w, h, True, cu.coeff_y)
            if cu.joint_cbcr:
                cc = 1 if cu.joint_cbcr in (2, 3) else 2
                coded = cu.coeff_cb if cu.joint_cbcr in (2, 3) \
                    else cu.coeff_cr
                self._residual_tb(enc, cu, cc, w >> 1, h >> 1, True, coded)
            else:
                if cbf_cb:
                    self._residual_tb(enc, cu, 1, w >> 1, h >> 1, True,
                                      cu.coeff_cb)
                if cbf_cr:
                    self._residual_tb(enc, cu, 2, w >> 1, h >> 1, True,
                                      cu.coeff_cr)
        self._code_lfnst_mts(enc, cu, encode=True)
        self._finish_cu(ps, cu, node)

    # -- merge data (subblock / regular / MMVD) ------------------------------
    # (vvenc CABACWriter::merge_data:757, subblock_merge_flag:1501,
    #  mmvd_merge_idx:1676)
    def _aff_ctx(self, ps, x, y) -> int:
        """DeriveCtx::CtxAffineFlag (ContextModelling.h:571)."""
        c = 0
        if ps.is_coded(x - 1, y) and self.mf.is_aff_at(x - 1, y):
            c += 1
        if ps.is_coded(x, y - 1) and self.mf.is_aff_at(x, y - 1):
            c += 1
        return c

    def _ibc_ctx(self, ps, x, y) -> int:
        """DeriveCtx::CtxIBCFlag (ContextModelling.h:589)."""
        c = 0
        if ps.is_coded(x - 1, y) and self.mf.ibc_at(x - 1, y) is not None:
            c += 1
        if ps.is_coded(x, y - 1) and self.mf.ibc_at(x, y - 1) is not None:
            c += 1
        return c

    def _dec_ibc_merge_idx(self, dec) -> int:
        n = self.max_ibc_merge - 1
        if n <= 0:
            return 0
        if not dec.decode_bin(ct.CTX_SETS["MergeIdx"](0)):
            return 0
        idx = 1
        while idx < n and dec.decode_bin_ep():
            idx += 1
        return idx

    def _enc_ibc_merge_idx(self, enc, idx: int) -> None:
        n = self.max_ibc_merge - 1
        if n <= 0:
            return
        enc.encode_bin(0 if idx == 0 else 1, ct.CTX_SETS["MergeIdx"](0))
        if idx:
            for k in range(1, n):
                enc.encode_bin_ep(0 if idx == k else 1)
                if idx == k:
                    break

    def _dec_ibc_merge(self, dec, ps, cu) -> None:
        from .motion import get_ibc_merge_candidates
        cu.merge_idx = self._dec_ibc_merge_idx(dec)
        cands = get_ibc_merge_candidates(ps, self.mf, self.hmvp_ibc,
                                         cu.x, cu.y, cu.w, cu.h,
                                         self.max_ibc_merge)
        cu.mv = (tuple(cands[cu.merge_idx]), (0, 0))
        cu.ref_idx = (-1, -1)

    def _subblock_merge_coded(self, cu) -> bool:
        return (not self.is_intra_slice and self.max_aff_merge > 0
                and cu.w >= 8 and cu.h >= 8)

    def _enc_merge_data(self, enc, ps, cu) -> None:
        from .geo import geo_available, ciip_available
        if self._subblock_merge_coded(cu):
            enc.encode_bin(1 if cu.affine else 0,
                           ct.CTX_SETS["SubblockMergeFlag"](
                               self._aff_ctx(ps, cu.x, cu.y)))
        if cu.affine:
            self._enc_aff_merge_idx(enc, cu.merge_idx)
            return
        geo_av = geo_available(self, cu)
        ciip_av = ciip_available(self, cu)
        if geo_av or ciip_av:
            enc.encode_bin(0 if (cu.geo or cu.ciip) else 1,
                           ct.CTX_SETS["RegularMergeFlag"](
                               0 if cu.skip else 1))
        if not cu.geo and not cu.ciip:
            if self.mmvd:
                enc.encode_bin(1 if cu.mmvd_flag else 0,
                               ct.CTX_SETS["MmvdFlag"](0))
            if cu.mmvd_flag:
                self._enc_mmvd_idx(enc, cu)
            else:
                self._enc_merge_idx(enc, cu.merge_idx)
        else:
            if geo_av and ciip_av:
                enc.encode_bin(1 if cu.ciip else 0,
                               ct.CTX_SETS["CiipFlag"](0))
            if cu.geo:
                self._enc_geo_idx(enc, cu)
            else:
                self._enc_merge_idx(enc, cu.merge_idx)

    def _dec_merge_data(self, dec, ps, cu) -> None:
        from .geo import geo_available, ciip_available
        if self._subblock_merge_coded(cu):
            cu.affine = bool(dec.decode_bin(ct.CTX_SETS["SubblockMergeFlag"](
                self._aff_ctx(ps, cu.x, cu.y))))
        if cu.affine:
            cu.merge_idx = self._dec_aff_merge_idx(dec)
            self._apply_affine_merge(ps, cu)
            return
        geo_av = geo_available(self, cu)
        ciip_av = ciip_available(self, cu)
        regular = True
        if geo_av or ciip_av:
            regular = bool(dec.decode_bin(ct.CTX_SETS["RegularMergeFlag"](
                0 if cu.skip else 1)))
        if regular:
            if self.mmvd and dec.decode_bin(ct.CTX_SETS["MmvdFlag"](0)):
                cu.mmvd_flag = True
                self._dec_mmvd_idx(dec, cu)
                self._apply_mmvd(ps, cu)
            else:
                cu.merge_idx = self._dec_merge_idx(dec)
                self._apply_merge(ps, cu)
            return
        if geo_av and ciip_av:
            cu.ciip = bool(dec.decode_bin(ct.CTX_SETS["CiipFlag"](0)))
            cu.geo = not cu.ciip
        elif ciip_av:
            cu.ciip = True
        else:
            cu.geo = True
        if cu.geo:
            self._dec_geo_idx(dec, cu)
            self._apply_geo(ps, cu)
        else:
            cu.merge_idx = self._dec_merge_idx(dec)
            self._apply_merge(ps, cu)

    # -- GEO indices (CABACWriter::merge_idx geo branch :1685) ---------------
    def _enc_geo_idx(self, enc, cu) -> None:
        write_trunc_bin(enc, cu.geo_split_dir, 64)
        i0, i1 = cu.geo_idx0, cu.geo_idx1
        i1 -= 0 if i1 < i0 else 1
        n2 = self.max_geo_cand - 2
        enc.encode_bin(0 if i0 == 0 else 1, ct.CTX_SETS["MergeIdx"](0))
        if i0 > 0:
            self._unary_max_ep(enc, i0 - 1, n2)
        if n2 > 0:
            enc.encode_bin(0 if i1 == 0 else 1, ct.CTX_SETS["MergeIdx"](0))
            if i1 > 0:
                self._unary_max_ep(enc, i1 - 1, n2 - 1)

    def _dec_geo_idx(self, dec, cu) -> None:
        cu.geo_split_dir = read_trunc_bin(dec, 64)
        n2 = self.max_geo_cand - 2
        i0 = 0
        if dec.decode_bin(ct.CTX_SETS["MergeIdx"](0)):
            i0 = 1 + self._dec_unary_max_ep(dec, n2)
        i1 = 0
        if n2 > 0 and dec.decode_bin(ct.CTX_SETS["MergeIdx"](0)):
            i1 = 1 + self._dec_unary_max_ep(dec, n2 - 1)
        i1 += 1 if i1 >= i0 else 0
        cu.geo_idx0, cu.geo_idx1 = i0, i1

    @staticmethod
    def _unary_max_ep(enc, v: int, vmax: int) -> None:
        for _ in range(v):
            enc.encode_bin_ep(1)
        if v < vmax:
            enc.encode_bin_ep(0)

    @staticmethod
    def _dec_unary_max_ep(dec, vmax: int) -> int:
        v = 0
        while v < vmax and dec.decode_bin_ep():
            v += 1
        return v

    def _apply_geo(self, ps, cu) -> None:
        from .geo import geo_merge_candidates, geo_motion_grid
        cands = geo_merge_candidates(self, ps, cu)
        mi0 = cands[cu.geo_idx0]
        mi1 = cands[cu.geo_idx1]
        cu.geo_mi = (mi0, mi1)
        cu.sub_mi = geo_motion_grid(cu, mi0, mi1, cu.geo_split_dir)

    # -- affine merge (CABACWriter::merge_idx affine branch :1657) -----------
    def _enc_aff_merge_idx(self, enc, idx: int) -> None:
        n = self.max_aff_merge - 1
        if n <= 0:
            return
        enc.encode_bin(0 if idx == 0 else 1, ct.CTX_SETS["AffMergeIdx"](0))
        if idx > 0:
            for k in range(1, n):
                enc.encode_bin_ep(0 if idx == k else 1)
                if idx == k:
                    break

    def _dec_aff_merge_idx(self, dec) -> int:
        n = self.max_aff_merge - 1
        if n <= 0:
            return 0
        if not dec.decode_bin(ct.CTX_SETS["AffMergeIdx"](0)):
            return 0
        idx = 1
        while idx < n and dec.decode_bin_ep():
            idx += 1
        return idx

    def _apply_affine_merge(self, ps, cu) -> None:
        from .affine import affine_merge_list, derive_affine_grids
        cands = affine_merge_list(self, ps, cu, self.max_aff_merge,
                                  mrg_idx=cu.merge_idx)
        cand = cands[cu.merge_idx]
        cu.ref_idx = tuple(cand.ref_idx)
        cu.bcw_idx = cand.bcw
        cu.cpmv = cand.cpmv
        cu.affine_type = cand.aff_type if not cand.is_sbtmvp else 0
        if cand.is_sbtmvp:
            cu.sbtmvp = True
            cu.sub_mi_src = cand.sub_mi
            # per-4x4 spanning grid from the 8x8 SbTMVP sub-blocks
            grid, (pw, ph) = cand.sub_mi
            sub = []
            for uy in range(cu.h // 4):
                row = []
                for ux in range(cu.w // 4):
                    row.append(grid[(uy * 4) // ph][(ux * 4) // pw])
                sub.append(row)
            cu.sub_mi = sub
        else:
            derive_affine_grids(self, cu)

    def _enc_mmvd_idx(self, enc, cu) -> None:
        if self.sps.max_num_merge_cand > 1:
            enc.encode_bin(cu.mmvd_base, ct.CTX_SETS["MmvdMergeIdx"](0))
        if cu.mmvd_step == 0:
            enc.encode_bin(0, ct.CTX_SETS["MmvdStepMvpIdx"](0))
        else:
            enc.encode_bin(1, ct.CTX_SETS["MmvdStepMvpIdx"](0))
            for idx in range(1, 7):
                enc.encode_bin_ep(0 if cu.mmvd_step == idx else 1)
                if cu.mmvd_step == idx:
                    break
        enc.encode_bins_ep(cu.mmvd_pos, 2)

    def _dec_mmvd_idx(self, dec, cu) -> None:
        if self.sps.max_num_merge_cand > 1:
            cu.mmvd_base = dec.decode_bin(ct.CTX_SETS["MmvdMergeIdx"](0))
        step = 0
        if dec.decode_bin(ct.CTX_SETS["MmvdStepMvpIdx"](0)):
            step = 1
            while step < 7 and dec.decode_bin_ep():
                step += 1
        cu.mmvd_step = step
        cu.mmvd_pos = dec.decode_bins_ep(2)

    def _apply_mmvd(self, ps, cu) -> None:
        """Derive the MMVD motion (vvenc MergeCtx::setMmvdMergeCandiInfo,
        getMmvdDeltaMv, ContextModelling.cpp:261-404)."""
        cands = get_merge_candidates(ps, self.mf, self.hmvp, cu.x, cu.y,
                                     cu.w, cu.h, self.sps.max_num_merge_cand,
                                     self.is_b, self.num_refs, self.tmvp)
        base = cands[cu.mmvd_base]
        offset = 1 << (cu.mmvd_step + 2)  # MV_FRACTIONAL_BITS_DIFF = 2
        if getattr(self.sh.ph, "fpel_mmvd", 0):
            offset <<= 2
        table = ((offset, 0), (-offset, 0), (0, offset), (0, -offset))
        d0 = table[cu.mmvd_pos]
        r0, r1 = base.ref_idx
        mv = [base.mv[0], base.mv[1]]
        if r0 >= 0 and r1 >= 0:
            poc0 = self.ref_pocs[0][r0]
            poc1 = self.ref_pocs[1][r1]
            cur = self.cur_poc
            if (poc0 - cur) == (poc1 - cur):
                d1 = d0
            elif abs(poc1 - cur) > abs(poc0 - cur):
                d1 = d0
                scale = _dist_scale_factor(cur, poc0, cur, poc1)
                d0 = _scale_mv(d1, scale)
            else:
                scale = _dist_scale_factor(cur, poc1, cur, poc0)
                d1 = _scale_mv(d0, scale)
            mv[0] = (mv[0][0] + d0[0], mv[0][1] + d0[1])
            mv[1] = (mv[1][0] + d1[0], mv[1][1] + d1[1])
        elif r0 >= 0:
            mv[0] = (mv[0][0] + d0[0], mv[0][1] + d0[1])
        elif r1 >= 0:
            mv[1] = (mv[1][0] + d0[0], mv[1][1] + d0[1])
        cu.mv = (
            (max(MV_MIN, min(MV_MAX, mv[0][0])),
             max(MV_MIN, min(MV_MAX, mv[0][1]))),
            (max(MV_MIN, min(MV_MAX, mv[1][0])),
             max(MV_MIN, min(MV_MAX, mv[1][1]))))
        cu.ref_idx = (r0, r1)
        cu.alt_hpel = base.alt_hpel
        cu.bcw_idx = base.bcw if (r0 >= 0 and r1 >= 0) else 2
        if cu.w + cu.h == 12 and r0 >= 0 and r1 >= 0:
            cu.ref_idx = (r0, -1)
            cu.mv = (cu.mv[0], (0, 0))

    # -- AMVR (imv) / BCW ----------------------------------------------------
    def _has_nonzero_mvd(self, cu) -> bool:
        return cu.mvd != (0, 0) or cu.mvd_l1 != (0, 0)

    def _enc_imv(self, enc, cu) -> None:
        if not self.amvr or not self._has_nonzero_mvd(cu):
            return
        enc.encode_bin(1 if cu.imv > 0 else 0, ct.CTX_SETS["ImvFlag"](0))
        if cu.imv > 0:
            enc.encode_bin(1 if cu.imv < 3 else 0, ct.CTX_SETS["ImvFlag"](4))
            if cu.imv < 3:
                enc.encode_bin(1 if cu.imv > 1 else 0,
                               ct.CTX_SETS["ImvFlag"](1))

    def _dec_imv(self, dec, cu) -> None:
        if not self.amvr or not self._has_nonzero_mvd(cu):
            return
        if dec.decode_bin(ct.CTX_SETS["ImvFlag"](0)):
            if dec.decode_bin(ct.CTX_SETS["ImvFlag"](4)):
                cu.imv = 2 if dec.decode_bin(ct.CTX_SETS["ImvFlag"](1)) else 1
            else:
                cu.imv = 3
                cu.alt_hpel = True

    # -- affine AMVR (CABACWriter::affine_amvr_mode:1629) --------------------
    def _aff_has_mvd(self, cu) -> bool:
        return any(d != (0, 0) for li in range(2) for d in cu.aff_mvds[li])

    def _enc_affine_amvr(self, enc, cu) -> None:
        if not self.affine_amvr_en or not self._aff_has_mvd(cu):
            return
        enc.encode_bin(1 if cu.imv > 0 else 0, ct.CTX_SETS["ImvFlag"](2))
        if cu.imv > 0:
            enc.encode_bin(1 if cu.imv > 1 else 0, ct.CTX_SETS["ImvFlag"](3))

    def _dec_affine_amvr(self, dec, cu) -> None:
        if not self.affine_amvr_en or not self._aff_has_mvd(cu):
            return
        if dec.decode_bin(ct.CTX_SETS["ImvFlag"](2)):
            cu.imv = 2 if dec.decode_bin(ct.CTX_SETS["ImvFlag"](3)) else 1

    def _derive_affine_amvp_mvs(self, ps, cu) -> None:
        """CPMVs from the affine AMVP list + signalled (differential) MVDs:
        cpmv[i] = mvp[i] + mvd[i] + (i>0 ? mvd[0] : 0)
        (InterSearch.cpp:5145-5150 inverse)."""
        from .affine import (affine_amvp_list, derive_affine_grids,
                             AFF_AMVR_SHIFTS, _clip_stor)
        sh = AFF_AMVR_SHIFTS[cu.imv]
        cpmv = [((0, 0),) * 3, ((0, 0),) * 3]
        n_cp = 3 if cu.affine_type else 2
        for li in range(2):
            if cu.ref_idx[li] < 0:
                continue
            mvps = affine_amvp_list(self, ps, cu, li, cu.ref_idx[li])
            mvp_i = cu.mvp_idx if li == 0 else cu.mvp_idx_l1
            pred = mvps[mvp_i]
            d0 = cu.aff_mvds[li][0]
            out = []
            for i in range(n_cp):
                d = cu.aff_mvds[li][i]
                dx = (d[0] << sh) + ((d0[0] << sh) if i else 0)
                dy = (d[1] << sh) + ((d0[1] << sh) if i else 0)
                out.append(_clip_stor((pred[i][0] + dx, pred[i][1] + dy)))
            while len(out) < 3:
                out.append((0, 0))
            cpmv[li] = tuple(out)
        cu.cpmv = (cpmv[0], cpmv[1])
        derive_affine_grids(self, cu)

    _BCW_CODING_ORDER = (4, 2, 0, 1, 3)
    _BCW_PARSING_ORDER = (2, 3, 1, 4, 0)

    def _bcw_coded(self, cu, inter_dir: int) -> bool:
        return (self.bcw_en and self.is_b and inter_dir == 3
                and not cu.merge and cu.w * cu.h >= 256)

    def _enc_bcw(self, enc, cu, inter_dir: int) -> None:
        if not self._bcw_coded(cu, inter_dir):
            return
        code_idx = self._BCW_CODING_ORDER[cu.bcw_idx]
        num_bcw = 5 if self.check_ldc else 3
        enc.encode_bin(0 if code_idx == 0 else 1, ct.CTX_SETS["BcwIdx"](0))
        if num_bcw > 2 and code_idx != 0:
            for i in range(1, num_bcw - 1):
                if code_idx == i:
                    enc.encode_bin_ep(0)
                    break
                enc.encode_bin_ep(1)

    def _dec_bcw(self, dec, cu, inter_dir: int) -> None:
        if not self._bcw_coded(cu, inter_dir):
            return
        code_idx = 0
        if dec.decode_bin(ct.CTX_SETS["BcwIdx"](0)):
            num_bcw = 5 if self.check_ldc else 3
            code_idx = 1
            while code_idx < num_bcw - 1 and dec.decode_bin_ep():
                code_idx += 1
        cu.bcw_idx = self._BCW_PARSING_ORDER[code_idx]

    # -- shared inter helpers ---------------------------------------------
    def _skip_ctx(self, ps, x, y):
        ctx = 0
        if ps.is_coded(x - 1, y) and self.mf.skip_at(x - 1, y):
            ctx += 1
        if ps.is_coded(x, y - 1) and self.mf.skip_at(x, y - 1):
            ctx += 1
        return ctx

    def _pred_mode_ctx(self, ps, x, y):
        left = ps.cu_at(x - 1, y)
        above = ps.cu_at(x, y - 1)
        return 1 if ((left is not None and left[4]) or
                     (above is not None and above[4])) else 0

    def _enc_merge_idx(self, enc, idx):
        n_minus1 = self.sps.max_num_merge_cand - 1
        if n_minus1 > 0:
            enc.encode_bin(0 if idx == 0 else 1, ct.CTX_SETS["MergeIdx"](0))
            if idx > 0:
                for i in range(1, n_minus1):
                    enc.encode_bin_ep(0 if idx == i else 1)
                    if idx == i:
                        break

    def _dec_merge_idx(self, dec):
        n_minus1 = self.sps.max_num_merge_cand - 1
        if n_minus1 <= 0:
            return 0
        if not dec.decode_bin(ct.CTX_SETS["MergeIdx"](0)):
            return 0
        idx = 1
        while idx < n_minus1 and dec.decode_bin_ep():
            idx += 1
        return idx

    def _enc_ref_idx(self, enc, ref_idx, num_ref):
        enc.encode_bin(1 if ref_idx > 0 else 0, ct.CTX_SETS["RefPic"](0))
        if num_ref <= 2 or ref_idx == 0:
            return
        enc.encode_bin(1 if ref_idx > 1 else 0, ct.CTX_SETS["RefPic"](1))
        if num_ref <= 3 or ref_idx == 1:
            return
        for idx in range(3, num_ref):
            if ref_idx > idx - 1:
                enc.encode_bin_ep(1)
            else:
                enc.encode_bin_ep(0)
                break

    def _dec_ref_idx(self, dec, num_ref):
        if num_ref <= 1:
            return 0
        if not dec.decode_bin(ct.CTX_SETS["RefPic"](0)):
            return 0
        if num_ref <= 2:
            return 1
        if not dec.decode_bin(ct.CTX_SETS["RefPic"](1)):
            return 1
        if num_ref <= 3:
            return 2
        idx = 2
        while idx < num_ref - 1 and dec.decode_bin_ep():
            idx += 1
        return idx

    def _enc_mvd(self, enc, mvd):
        """mvd_coding (CABACWriter.cpp:1967), quarter-pel units."""
        hor, ver = mvd
        h_abs, v_abs = abs(hor), abs(ver)
        enc.encode_bin(1 if h_abs > 0 else 0, ct.CTX_SETS["Mvd"](0))
        enc.encode_bin(1 if v_abs > 0 else 0, ct.CTX_SETS["Mvd"](0))
        if h_abs > 0:
            enc.encode_bin(1 if h_abs > 1 else 0, ct.CTX_SETS["Mvd"](1))
        if v_abs > 0:
            enc.encode_bin(1 if v_abs > 1 else 0, ct.CTX_SETS["Mvd"](1))
        if h_abs > 0:
            if h_abs > 1:
                enc.encode_remabs_ep(h_abs - 2, 1, 0, 17)  # MV_BITS - 1
            enc.encode_bin_ep(1 if hor < 0 else 0)
        if v_abs > 0:
            if v_abs > 1:
                enc.encode_remabs_ep(v_abs - 2, 1, 0, 17)
            enc.encode_bin_ep(1 if ver < 0 else 0)

    def _dec_mvd(self, dec):
        h_gt0 = dec.decode_bin(ct.CTX_SETS["Mvd"](0))
        v_gt0 = dec.decode_bin(ct.CTX_SETS["Mvd"](0))
        h_abs = v_abs = 0
        if h_gt0:
            h_abs = 1 + dec.decode_bin(ct.CTX_SETS["Mvd"](1))
        if v_gt0:
            v_abs = 1 + dec.decode_bin(ct.CTX_SETS["Mvd"](1))
        hor = ver = 0
        if h_gt0:
            if h_abs > 1:
                h_abs = 2 + dec.decode_remabs_ep(1, 0, 17)
            hor = -h_abs if dec.decode_bin_ep() else h_abs
        if v_gt0:
            if v_abs > 1:
                v_abs = 2 + dec.decode_remabs_ep(1, 0, 17)
            ver = -v_abs if dec.decode_bin_ep() else v_abs
        return (hor, ver)

    def _apply_merge(self, ps, cu):
        cands = get_merge_candidates(ps, self.mf, self.hmvp, cu.x, cu.y,
                                     cu.w, cu.h, self.sps.max_num_merge_cand,
                                     self.is_b, self.num_refs, self.tmvp)
        mi = cands[cu.merge_idx]
        cu.mv = mi.mv
        cu.ref_idx = mi.ref_idx
        cu.alt_hpel = mi.alt_hpel
        cu.bcw_idx = mi.bcw if (mi.ref_idx[0] >= 0 and mi.ref_idx[1] >= 0) \
            else 2
        # 4x8/8x4: bi merge candidates become uni-L0
        # (vvenc CU::restrictBiPredMergeCandsOne, UnitTools.cpp:3085)
        if cu.w + cu.h == 12 and cu.ref_idx[0] >= 0 and cu.ref_idx[1] >= 0:
            cu.ref_idx = (cu.ref_idx[0], -1)
            cu.mv = (cu.mv[0], (0, 0))

    def derive_amvp(self, ps, cu, list_idx=0):
        return get_amvp_candidates(ps, self.mf, self.hmvp, cu.x, cu.y,
                                   cu.w, cu.h, list_idx, cu.ref_idx[list_idx],
                                   self.ref_pocs, self.tmvp, imv=cu.imv)

    def _derive_amvp_mvs(self, ps, cu) -> None:
        """Final MVs from AMVP + signalled MVDs at the AMVR precision
        (mvd scaling: vvenc Mv::changeTransPrecAmvr2Internal)."""
        sh_amvr = AMVR_SHIFTS[cu.imv]
        mvs = [(0, 0), (0, 0)]
        for li in range(2):
            if cu.ref_idx[li] < 0:
                continue
            amvp = self.derive_amvp(ps, cu, li)
            mvp_i = cu.mvp_idx if li == 0 else cu.mvp_idx_l1
            mvd = cu.mvd if li == 0 else cu.mvd_l1
            mvp = amvp[mvp_i]
            mvs[li] = (
                max(MV_MIN, min(MV_MAX, mvp[0] + (mvd[0] << sh_amvr))),
                max(MV_MIN, min(MV_MAX, mvp[1] + (mvd[1] << sh_amvr))))
        cu.mv = (mvs[0], mvs[1])
        cu.alt_hpel = cu.imv == 3

    def _finish_cu(self, ps, cu, node):
        comps = (0,) if cu.luma_only else (0, 1, 2)
        self.finish_cu(ps, cu, node.part.qt_depth, comps)

    def finish_cu(self, ps, cu, qt_depth: int, comps=(0, 1, 2)):
        """Reconstruct + update motion/attribute maps + HMVP."""
        if cu.is_inter and cu.geo and cu.geo_mi is None:
            # native-search trees carry the signalled geo fields only;
            # the motion derives from the live neighborhood exactly as
            # the decoder will (same progressive mf state)
            self._apply_geo(ps, cu)
        if cu.is_inter and cu.affine and cu.sub_mi is None:
            # native-search affine CUs likewise re-derive from the
            # signalled fields (merge idx / differential CPMV MVDs)
            if cu.merge:
                self._apply_affine_merge(ps, cu)
            else:
                self._derive_affine_amvp_mvs(ps, cu)
        if self.use_dqp:
            # dequant with the current QG QP (the delta, if any, is always
            # coded before the first residual of the QG)
            self.qp.set_cu_qp(self.cur_qp)
        if cu.recon_done:
            # the native CTU search (commit mode) already left this CU's
            # exact reconstruction samples in ps.rec; re-deriving them is
            # the replay's hottest redundant work.  The attribute maps
            # are still marked progressively here (identical to
            # reconstruct_cu's marking) — the writer's neighbor
            # availability depends on the marking order — and the
            # motion-field/HMVP updates below still run.
            if cu.chroma_only:
                ps.mark_chroma(cu.x, cu.y, cu.w, cu.h, qt_depth)
            else:
                ps.mark_cu(cu.x, cu.y, cu.w, cu.h, qt_depth,
                           dm_luma_mode(cu) if not cu.is_inter else DC,
                           is_intra=not cu.is_inter, is_mip=cu.mip_flag,
                           with_chroma=not cu.luma_only, qp=self.qp.qp_y)
        else:
            if cu.is_inter and self.dmvr_applies(cu):
                from ..ops.dmvr import dmvr_refine
                cu.dmvr_deltas, dmvr_bdof = dmvr_refine(
                    self.ref_pics[0][cu.ref_idx[0]][0],
                    self.ref_pics[1][cu.ref_idx[1]][0],
                    cu.x, cu.y, cu.w, cu.h, cu.mv[0], cu.mv[1],
                    self.bit_depth, ps.w, ps.h, self.ctu_size)
                bdof_g = self.bdof_applies(cu)
                cu.dmvr_bdof = {k: (v and bdof_g)
                                for k, v in dmvr_bdof.items()}
            reconstruct_cu(ps, cu, self.qp, qt_depth, self.bit_depth,
                           self.ref_pics, comps, self.implicit_mts,
                           self.ctu_size, self.dq, self.jccr_sign,
                           bdof=(cu.is_inter and cu.dmvr_deltas is None
                                 and self.bdof_applies(cu)),
                           coder=self)
        if cu.chroma_only:
            return
        if self.mf is not None:
            if cu.is_inter and cu.is_ibc:
                # store the BV for IBC neighbor/HMVP use; excluded from
                # the inter motion field (spanMotionInfo MI_NOT_VALID)
                self.mf.set_cu(cu.x, cu.y, cu.w, cu.h, None, cu.skip,
                               ibc_bv=tuple(cu.mv[0]))
                if cu.w * cu.h > 16:
                    self.hmvp_ibc.add(MotionInfo((tuple(cu.mv[0]), (0, 0)),
                                                 (0, -1)))
            elif cu.is_inter and cu.affine:
                # per-sub-block spanning; affine CUs do not update HMVP
                # (CU::saveMotionInHMVP gate on !cu.affine, UnitTools:354)
                aff_info = None
                if not cu.sbtmvp:
                    from .affine import AffineInfo
                    aff_info = AffineInfo(
                        cu.x, cu.y, cu.w, cu.h, cu.affine_type, cu.cpmv,
                        cu.inter_dir, tuple(cu.ref_idx), cu.bcw_idx)
                self.mf.set_sub_cu(cu.x, cu.y, cu.w, cu.h, cu.sub_mi,
                                   cu.skip, aff_info)
            elif cu.is_inter and cu.geo:
                # per-sub-block geo motion; geo CUs do not update HMVP
                self.mf.set_sub_cu(cu.x, cu.y, cu.w, cu.h, cu.sub_mi,
                                   cu.skip, None, is_aff=False)
            elif cu.is_inter:
                mi = MotionInfo((tuple(cu.mv[0]), tuple(cu.mv[1])),
                                tuple(cu.ref_idx), bcw=cu.bcw_idx,
                                alt_hpel=cu.alt_hpel)
                self.mf.set_cu(cu.x, cu.y, cu.w, cu.h, mi, cu.skip)
                if hmvp_insertion_allowed(cu.x, cu.y, cu.w, cu.h):
                    self.hmvp.add(mi)
            else:
                self.mf.set_cu(cu.x, cu.y, cu.w, cu.h, None, False)

    def _enc_intra_luma_mode(self, enc, ps, cu: CuData) -> None:
        # intra_mip_flag / mip modes (vvenc CABACWriter::mip_flag:2966,
        # mip_pred_mode:2994)
        if self.sps.mip:
            ctx = mip_flag_ctx(ps, cu.x, cu.y, cu.w, cu.h)
            enc.encode_bin(1 if cu.mip_flag else 0,
                           ct.CTX_SETS["MipFlag"](ctx))
            if cu.mip_flag:
                enc.encode_bin_ep(1 if cu.mip_transposed else 0)
                write_trunc_bin(enc, cu.luma_mode,
                                MIP.num_mip_modes(cu.w, cu.h))
                return
        # intra_luma_ref_idx (MRL; vvenc CABACWriter::extend_ref_line:925)
        if self.sps.mrl and (cu.y % self.ctu_size) != 0:
            enc.encode_bin(1 if cu.ref_line != 0 else 0,
                           ct.CTX_SETS["MultiRefLineIdx"](0))
            if cu.ref_line != 0:
                enc.encode_bin(1 if cu.ref_line != 1 else 0,
                               ct.CTX_SETS["MultiRefLineIdx"](1))
        # intra_subpartitions (vvenc CABACWriter::isp_mode:2383)
        if self._isp_coded(cu):
            enc.encode_bin(1 if cu.isp_mode else 0, ct.CTX_SETS["ISPMode"](0))
            if cu.isp_mode:
                enc.encode_bin(cu.isp_mode - 1, ct.CTX_SETS["ISPMode"](1))
        mpm = get_intra_mpms(ps, cu.x, cu.y, cu.w, cu.h, self.ctu_size)
        mode = cu.luma_mode
        mpm_idx = mpm.index(mode) if mode in mpm else NUM_MPM
        if cu.ref_line:
            assert 1 <= mpm_idx < NUM_MPM, "MRL modes must be non-planar MPMs"
        else:
            enc.encode_bin(1 if mpm_idx < NUM_MPM else 0,
                           ct.CTX_SETS["IntraLumaMpmFlag"](0))
        if mpm_idx < NUM_MPM:
            if cu.ref_line == 0:
                enc.encode_bin(1 if mpm_idx > 0 else 0,
                               ct.CTX_SETS["IntraLumaPlanarFlag"](
                                   0 if cu.isp_mode else 1))
            if mpm_idx:
                enc.encode_bin_ep(1 if mpm_idx > 1 else 0)
            if mpm_idx > 1:
                enc.encode_bin_ep(1 if mpm_idx > 2 else 0)
            if mpm_idx > 2:
                enc.encode_bin_ep(1 if mpm_idx > 3 else 0)
            if mpm_idx > 3:
                enc.encode_bin_ep(1 if mpm_idx > 4 else 0)
        else:
            srt = sorted(mpm)
            m = mode
            for v in reversed(srt):
                if m > v:
                    m -= 1
            write_trunc_bin(enc, m, NUM_LUMA_MODE - NUM_MPM)

    def _enc_intra_chroma_mode(self, enc, cu: CuData) -> None:
        # vvenc CABACWriter::intra_chroma_pred_mode:1177 (CCLM always
        # allowed in single tree, CU::checkCCLMAllowed:177)
        if self.sps.cclm and cu.cclm_allowed:
            is_lm = cu.chroma_dir in CCLM_MODES
            enc.encode_bin(1 if is_lm else 0, ct.CTX_SETS["CclmModeFlag"](0))
            if is_lm:
                sym = CCLM_MODES.index(cu.chroma_dir)
                enc.encode_bin(0 if sym == 0 else 1,
                               ct.CTX_SETS["CclmModeIdx"](0))
                if sym > 0:
                    enc.encode_bin_ep(sym - 1)
                return
        is_dm = cu.chroma_dir == DM_CHROMA
        enc.encode_bin(0 if is_dm else 1, ct.CTX_SETS["IntraChromaPredMode"](0))
        if not is_dm:
            cands = chroma_cand_modes(dm_luma_mode(cu))
            cand_id = cands.index(cu.chroma_dir)
            enc.encode_bins_ep(cand_id, 2)

    # -- decoding ----------------------------------------------------------
    def decode_ctu(self, dec, ps: PictureState, ctu_x: int, ctu_y: int) -> TreeNode:
        if self.dual_tree_intra:
            if self.use_dqp:   # QG opens at the CTU root (see encode_ctu)
                self.qg_start = True
                self.dqp_coded = False
            node = self._dual_tree_units(
                ps, ctu_x, ctu_y,
                lambda x, y, u, pl: self._dec_tree(dec, ps, x, y, u, u, pl))
        else:
            node = self._dec_tree(dec, ps, ctu_x, ctu_y, self.ctu_size,
                                  self.ctu_size, PartInfo())
        if self.use_dqp:
            self._finalize_qg(ps)
        return node

    def _dual_tree_units(self, ps, ctu_x, ctu_y, tree_fn) -> TreeNode:
        """Dual-tree-intra CTU: implicit QT down to 64x64 units, each coding
        a luma tree then a chroma tree (VVC 7.3.11.2 dual_tree_implicit_qt,
        vvenc EncCu::xCompressCtu dual-tree dispatch)."""
        ctu = self.ctu_size
        node = TreeNode(ctu_x, ctu_y, ctu, 0, w=ctu, h=ctu, part=PartInfo())
        unit = min(64, ctu)
        qtd = 1 if ctu > 64 else 0
        subdiv = 2 * qtd
        for uy in range(ctu_y, ctu_y + ctu, unit):
            for ux in range(ctu_x, ctu_x + ctu, unit):
                if ux >= ps.w or uy >= ps.h:
                    continue
                pl = PartInfo(qt_depth=qtd, subdiv=subdiv,
                              mode_type=MODE_INTRA, tree_type=TREE_L)
                node.children.append(tree_fn(ux, uy, unit, pl))
                pc = PartInfo(qt_depth=qtd, subdiv=subdiv,
                              mode_type=MODE_INTRA, tree_type=CHROMA_TREE)
                node.children.append(tree_fn(ux, uy, unit, pc))
        return node

    def _dec_tree(self, dec, ps, x, y, w, h, part: PartInfo) -> TreeNode:
        if self.use_dqp and part.subdiv <= self.qg_subdiv \
                and part.tree_type not in (TREE_C, CHROMA_TREE):
            self.qg_start = True
            self.dqp_coded = False
        node = TreeNode(x, y, max(w, h), part.qt_depth, w=w, h=h, part=part)
        tidx = 2 if part.tree_type == CHROMA_TREE else self.tree_idx
        node.split_mode = read_split_mode(dec, ps, x, y, w, h, part,
                                          self.sps, tidx)
        if self.dual_tree_intra and part.tree_type == TREE_L \
                and part.last_split == -1:
            self.luma64[(x, y)] = [node.split_mode, False]
        node.split = node.split_mode != NO_SPLIT
        if node.split:
            impl = implicit_split(ps, x, y, w, h, part, self.sps, tidx)
            is_impl = node.split_mode == impl
            # SCIPU mode constraint (vvenc CABACWriter::mode_constraint:540)
            val = signal_mode_cons(w, h, node.split_mode, part.mode_type,
                                   self.is_intra_slice)
            if val == LDT_SIGNAL:
                ctx = self._pred_mode_ctx(ps, x, y)  # CtxModeConsFlag
                child_mt = MODE_INTRA if dec.decode_bin(
                    ct.CTX_SETS["ModeConsFlag"](ctx)) else MODE_INTER
            elif val == LDT_INFER:
                child_mt = MODE_INTRA
            else:
                child_mt = part.mode_type
            node.mode_type_child = child_mt
            chroma_not_split = (part.mode_type == MODE_ALL
                                and child_mt == MODE_INTRA)
            child_tt = TREE_L if chroma_not_split else part.tree_type
            for idx, (cx, cy, cw, chh) in enumerate(
                    split_geometry(node.split_mode, x, y, w, h)):
                if cx >= ps.w or cy >= ps.h:
                    continue
                cpart = part.child(node.split_mode, idx, is_impl)
                cpart.mode_type = child_mt
                cpart.tree_type = child_tt
                node.children.append(
                    self._dec_tree(dec, ps, cx, cy, cw, chh, cpart))
            if chroma_not_split:
                node.chroma_cu = self._dec_chroma_cu(dec, ps, x, y, w, h,
                                                     part)
        elif part.tree_type == CHROMA_TREE:
            node.cu = self._dec_chroma_cu(dec, ps, x, y, w, h, part)
        else:
            self._qg_leaf_start(ps, x, y)
            node.cu = self._dec_cu(dec, ps, node)
            if self.use_dqp:
                self._qg_cus.append(node.cu)
            if self.dual_tree_intra and part.tree_type == TREE_L \
                    and part.last_split == -1:
                self.luma64[(x, y)][1] = bool(node.cu.isp_mode)
        return node

    def _cclm_allowed(self, ps, cu, part) -> bool:
        """Dual-tree CCLM gate (CU::checkCCLMAllowed, UnitTools.cpp:177):
        with CTU >= 64 the chroma-tree 64-node must split QT / HBT(+VBT) /
        not at all, and the collocated luma 64-node must be QT-split (or an
        unsplit non-ISP 64x64 CU)."""
        if not self.dual_tree_intra or self.ctu_size <= 32:
            return True
        sp = part.split_path
        p1 = sp[0] if len(sp) > 0 else NO_SPLIT
        p2 = sp[1] if len(sp) > 1 else NO_SPLIT
        allow = (p1 == QT_SPLIT
                 or (p1 == BT_H and p2 == BT_V)
                 or p1 == NO_SPLIT
                 or (p1 == BT_H and p2 == NO_SPLIT))
        if not allow:
            return False
        rec = self.luma64.get((cu.x & ~63, cu.y & ~63))
        lw = int(ps.cu_w[cu.y >> 2, cu.x >> 2])
        lh = int(ps.cu_h[cu.y >> 2, cu.x >> 2])
        if lw < 64 or lh < 64:
            # luma 64-node was split: only a QT first split keeps CCLM
            if rec is None or rec[0] != QT_SPLIT:
                return False
        elif rec is not None and rec[1]:
            return False       # unsplit 64x64 luma CU using ISP
        return True

    def _dec_chroma_cu(self, dec, ps, x, y, w, h, part: PartInfo) -> CuData:
        """Region chroma CU of a local dual tree (treeType TREE_C; vvenc
        CABACWriter::coding_tree chromaNotSplit tail, CABACWriter.cpp:494).
        Coordinates are the luma region; chroma covers (x>>1, y>>1)."""
        cu = CuData(x, y, w, h)
        cu.chroma_only = True
        # DM derives from the co-located CENTER luma mode (VVC 8.4.3)
        cu.luma_mode = int(ps.intra_mode[(y + (h >> 1)) >> 2,
                                         (x + (w >> 1)) >> 2])
        cu.cclm_allowed = self._cclm_allowed(ps, cu, part)
        self._code_bdpcm_modes(dec, cu, encode=False, chroma=True)
        if not cu.bdpcm_c:
            cu.chroma_dir = self._dec_intra_chroma_mode(dec, cu)
        cbf_cb = dec.decode_bin(ct.CTX_SETS["QtCbfCb"](
            1 if cu.bdpcm_c else 0))
        cbf_cr = dec.decode_bin(ct.CTX_SETS["QtCbfCr"](
            2 if cu.bdpcm_c else (1 if cbf_cb else 0)))
        mask = (2 if cbf_cb else 0) + (1 if cbf_cr else 0)
        if self.jccr and not cu.bdpcm_c and mask:
            if dec.decode_bin(ct.CTX_SETS["JointCbCrFlag"](mask - 1)):
                cu.joint_cbcr = mask
        if cu.joint_cbcr:
            cc = 1 if cu.joint_cbcr in (2, 3) else 2
            coded = self._residual_tb(dec, cu, cc, w >> 1, h >> 1, False)
            if cu.joint_cbcr in (2, 3):
                cu.coeff_cb = coded
            else:
                cu.coeff_cr = coded
        else:
            if cbf_cb:
                cu.coeff_cb = self._residual_tb(dec, cu, 1, w >> 1, h >> 1,
                                                False)
            if cbf_cr:
                cu.coeff_cr = self._residual_tb(dec, cu, 2, w >> 1, h >> 1,
                                                False)
        self._code_lfnst_mts(dec, cu, encode=False)
        self.finish_cu(ps, cu, part.qt_depth, comps=(1, 2))
        return cu

    def _dec_cu(self, dec, ps, node: TreeNode) -> CuData:
        x, y = node.x, node.y
        w, h = node.w, node.h
        cu = CuData(x, y, w, h)
        mt = node.part.mode_type
        cu.luma_only = node.part.tree_type == TREE_L
        is_4x4 = w == 4 and h == 4
        # cu_skip_flag (vvenc CABACWriter::cu_skip_flag:688; with IBC the
        # flag is also coded in I slices / for 4x4 / in intra-constrained
        # regions)
        intra_like = self.is_intra_slice or mt == MODE_INTRA
        ibc_sz = self.ibc_en and w < 128 and h < 128
        if intra_like:
            if ibc_sz and not cu.luma_only or (ibc_sz and cu.luma_only):
                ctx_skip = self._skip_ctx(ps, x, y)
                cu.skip = bool(dec.decode_bin(
                    ct.CTX_SETS["SkipFlag"](ctx_skip)))
                if cu.skip:
                    cu.is_inter = True
                    cu.is_ibc = True
                    cu.merge = True
                    cu.root_cbf = False
                    self._dec_ibc_merge(dec, ps, cu)
                    self._finish_cu(ps, cu, node)
                    return cu
        elif not is_4x4 or self.ibc_en:
            ctx_skip = self._skip_ctx(ps, x, y)
            cu.skip = bool(dec.decode_bin(ct.CTX_SETS["SkipFlag"](ctx_skip)))
            if cu.skip:
                cu.is_inter = True
                cu.merge = True
                cu.root_cbf = False
                if self.ibc_en and mt != MODE_INTER:
                    if is_4x4:
                        cu.is_ibc = True
                    elif ibc_sz and dec.decode_bin(ct.CTX_SETS["IBCFlag"](
                            self._ibc_ctx(ps, x, y))):
                        cu.is_ibc = True
                if cu.is_ibc:
                    self._dec_ibc_merge(dec, ps, cu)
                else:
                    self._dec_merge_data(dec, ps, cu)
                self._finish_cu(ps, cu, node)
                return cu
        # pred_mode_flag (+ pred_mode_ibc_flag; vvenc pred_mode:728)
        if intra_like or is_4x4:
            cu.is_inter = False
            if ibc_sz and mt != MODE_INTER:
                if dec.decode_bin(ct.CTX_SETS["IBCFlag"](
                        self._ibc_ctx(ps, x, y))):
                    cu.is_ibc = True
                    cu.is_inter = True
        elif mt == MODE_INTER:
            cu.is_inter = True
        else:
            ctx_pm = self._pred_mode_ctx(ps, x, y)
            cu.is_inter = not dec.decode_bin(ct.CTX_SETS["PredMode"](ctx_pm))
            if cu.is_inter and ibc_sz:
                if dec.decode_bin(ct.CTX_SETS["IBCFlag"](
                        self._ibc_ctx(ps, x, y))):
                    cu.is_ibc = True
        if not cu.is_inter:
            self._code_bdpcm_modes(dec, cu, encode=False, chroma=False)
            if not cu.bdpcm_y:
                cu.luma_mode = self._dec_intra_luma_mode(dec, ps, cu)
            if not cu.luma_only:
                self._code_bdpcm_modes(dec, cu, encode=False, chroma=True)
                if not cu.bdpcm_c:
                    cu.chroma_dir = self._dec_intra_chroma_mode(dec, cu)
        else:
            cu.merge = bool(dec.decode_bin(ct.CTX_SETS["MergeFlag"](0)))
            if cu.merge and cu.is_ibc:
                self._dec_ibc_merge(dec, ps, cu)
            elif cu.merge:
                self._dec_merge_data(dec, ps, cu)
            elif cu.is_ibc:
                # IBC AMVP: mvd (integer / 4-pel) + mvp_flag + amvr
                # (CABACWriter::prediction_unit IBC branch :1403-1414,
                #  imv_mode :1589-1627 IBC semantics)
                from .motion import get_ibc_amvp_candidates
                cu.mvd = self._dec_mvd(dec)
                if self.max_ibc_merge > 1:
                    cu.mvp_idx = dec.decode_bin(ct.CTX_SETS["MVPIdx"](0))
                if self.amvr and cu.mvd != (0, 0):
                    cu.imv = 2 if dec.decode_bin(
                        ct.CTX_SETS["ImvFlag"](1)) else 1
                amvp = get_ibc_amvp_candidates(ps, self.mf, self.hmvp_ibc,
                                               cu.x, cu.y, cu.w, cu.h,
                                               cu.imv)
                sh = 6 if cu.imv == 2 else 4
                mvp = amvp[cu.mvp_idx]
                cu.mv = ((max(MV_MIN, min(MV_MAX, mvp[0] + (cu.mvd[0] << sh))),
                          max(MV_MIN, min(MV_MAX,
                                          mvp[1] + (cu.mvd[1] << sh)))),
                         (0, 0))
                cu.ref_idx = (-1, -1)
            else:
                inter_dir = 1
                if self.is_b:
                    is_bi = False
                    if w + h > 12:  # bipred restriction: bi bin not coded
                        ctx = 7 - (((w * h).bit_length() - 1 + 1) >> 1)
                        is_bi = bool(dec.decode_bin(
                            ct.CTX_SETS["InterDir"](ctx)))
                    if is_bi:
                        inter_dir = 3
                    elif dec.decode_bin(ct.CTX_SETS["InterDir"](5)):
                        inter_dir = 2
                if not self.is_intra_slice and self.affine_en \
                        and w > 8 and h > 8:
                    cu.affine = bool(dec.decode_bin(ct.CTX_SETS["AffineFlag"](
                        self._aff_ctx(ps, cu.x, cu.y))))
                    if cu.affine and self.affine_type_en:
                        cu.affine_type = dec.decode_bin(
                            ct.CTX_SETS["AffineType"](0))
                if inter_dir == 3 and self.bi_dir_pred and not cu.affine:
                    cu.smvd = bool(dec.decode_bin(ct.CTX_SETS["SmvdFlag"](0)))
                refs = [-1, -1]
                n_cp = (3 if cu.affine_type else 2) if cu.affine else 1
                aff_mvds = [[(0, 0)] * 3, [(0, 0)] * 3]
                mvds = [(0, 0), (0, 0)]
                mvps = [0, 0]
                if inter_dir != 2:
                    refs[0] = self.sym_ref[0] if cu.smvd else \
                        self._dec_ref_idx(dec, self.num_refs[0])
                    if cu.affine:
                        for i in range(n_cp):
                            aff_mvds[0][i] = self._dec_mvd(dec)
                    else:
                        mvds[0] = self._dec_mvd(dec)
                    mvps[0] = dec.decode_bin(ct.CTX_SETS["MVPIdx"](0))
                if inter_dir != 1:
                    if cu.smvd:
                        refs[1] = self.sym_ref[1]
                        mvds[1] = (-mvds[0][0], -mvds[0][1])
                    else:
                        refs[1] = self._dec_ref_idx(dec, self.num_refs[1])
                        if self.sh.ph.mvd_l1_zero and inter_dir == 3:
                            pass  # all L1 mvds inferred zero
                        elif cu.affine:
                            for i in range(n_cp):
                                aff_mvds[1][i] = self._dec_mvd(dec)
                        else:
                            mvds[1] = self._dec_mvd(dec)
                    mvps[1] = dec.decode_bin(ct.CTX_SETS["MVPIdx"](0))
                cu.ref_idx = tuple(refs)
                cu.mvd = mvds[0]
                cu.mvp_idx = mvps[0]
                cu.mvd_l1 = mvds[1]
                cu.mvp_idx_l1 = mvps[1]
                if cu.affine:
                    cu.aff_mvds = (tuple(aff_mvds[0]), tuple(aff_mvds[1]))
                    self._dec_affine_amvr(dec, cu)
                    self._dec_bcw(dec, cu, inter_dir)
                    self._derive_affine_amvp_mvs(ps, cu)
                else:
                    self._dec_imv(dec, cu)
                    self._dec_bcw(dec, cu, inter_dir)
                    self._derive_amvp_mvs(ps, cu)
        if cu.is_inter and not cu.merge:
            cu.root_cbf = bool(dec.decode_bin(ct.CTX_SETS["QtRootCbf"](0)))
        if cu.is_inter and cu.root_cbf:
            self._code_sbt_mode(dec, cu, encode=False)
        if cu.isp_mode:
            self._code_isp_tus(dec, cu, encode=False)
            self._code_lfnst_mts(dec, cu, encode=False)
            self._finish_cu(ps, cu, node)
            return cu
        if cu.is_inter and cu.root_cbf and (w > MAX_TB or h > MAX_TB):
            # implicit TU_MAX_TR_SPLIT tiling (transform_tree, 7.3.11.9)
            self._code_max_tb_tus(dec, cu, encode=False)
            self._finish_cu(ps, cu, node)
            return cu
        tw, th = w, h
        if cu.sbt_idx:
            _, _, tw, th, _, _ = sbt_tu_rect(cu)
        if not cu.is_inter or cu.root_cbf:
            if cu.luma_only:
                if cu.is_inter:
                    cbf_y = 1   # inferred: no chroma TBs in this TU
                else:
                    cbf_y = dec.decode_bin(ct.CTX_SETS["QtCbfLuma"](
                        1 if cu.bdpcm_y else 0))
                self._maybe_code_dqp(dec, cu, bool(cbf_y), encode=False)
                if cbf_y:
                    cu.coeff_y = self._residual_tb(dec, cu, 0, w, h, False)
                self._code_lfnst_mts(dec, cu, encode=False)
                self._finish_cu(ps, cu, node)
                return cu
            cbf_cb = dec.decode_bin(ct.CTX_SETS["QtCbfCb"](
                1 if cu.bdpcm_c else 0))
            cbf_cr = dec.decode_bin(ct.CTX_SETS["QtCbfCr"](
                2 if cu.bdpcm_c else (1 if cbf_cb else 0)))
            if cu.is_inter and not cbf_cb and not cbf_cr:
                cbf_y = 1  # inferred for inter with no chroma cbf
            else:
                cbf_y = dec.decode_bin(ct.CTX_SETS["QtCbfLuma"](
                    1 if cu.bdpcm_y else 0))
            self._maybe_code_dqp(dec, cu, bool(cbf_y or cbf_cb or cbf_cr),
                                 encode=False)
            mask = (2 if cbf_cb else 0) + (1 if cbf_cr else 0)
            if self.jccr and not cu.bdpcm_c and \
                    ((not cu.is_inter and mask) or mask == 3):
                if dec.decode_bin(ct.CTX_SETS["JointCbCrFlag"](mask - 1)):
                    cu.joint_cbcr = mask
            if cbf_y:
                cu.coeff_y = self._residual_tb(dec, cu, 0, tw, th, False)
            if cu.joint_cbcr:
                cc = 1 if cu.joint_cbcr in (2, 3) else 2
                coded = self._residual_tb(dec, cu, cc, tw >> 1, th >> 1,
                                          False)
                if cu.joint_cbcr in (2, 3):
                    cu.coeff_cb = coded
                else:
                    cu.coeff_cr = coded
            else:
                if cbf_cb:
                    cu.coeff_cb = self._residual_tb(dec, cu, 1, tw >> 1,
                                                    th >> 1, False)
                if cbf_cr:
                    cu.coeff_cr = self._residual_tb(dec, cu, 2, tw >> 1,
                                                    th >> 1, False)
        self._code_lfnst_mts(dec, cu, encode=False)
        self._finish_cu(ps, cu, node)
        return cu

    def _dec_intra_luma_mode(self, dec, ps, cu: CuData) -> int:
        if self.sps.mip:
            ctx = mip_flag_ctx(ps, cu.x, cu.y, cu.w, cu.h)
            if dec.decode_bin(ct.CTX_SETS["MipFlag"](ctx)):
                cu.mip_flag = True
                cu.mip_transposed = bool(dec.decode_bin_ep())
                return read_trunc_bin(dec, MIP.num_mip_modes(cu.w, cu.h))
        if self.sps.mrl and (cu.y % self.ctu_size) != 0:
            if dec.decode_bin(ct.CTX_SETS["MultiRefLineIdx"](0)):
                cu.ref_line = 2 if dec.decode_bin(
                    ct.CTX_SETS["MultiRefLineIdx"](1)) else 1
        if self._isp_coded(cu):
            if dec.decode_bin(ct.CTX_SETS["ISPMode"](0)):
                cu.isp_mode = 1 + dec.decode_bin(ct.CTX_SETS["ISPMode"](1))
        mpm = get_intra_mpms(ps, cu.x, cu.y, cu.w, cu.h, self.ctu_size)
        if cu.ref_line:
            idx = 1
            while idx < NUM_MPM - 1 and dec.decode_bin_ep():
                idx += 1
            return mpm[idx]
        if dec.decode_bin(ct.CTX_SETS["IntraLumaMpmFlag"](0)):
            if not dec.decode_bin(ct.CTX_SETS["IntraLumaPlanarFlag"](
                    0 if cu.isp_mode else 1)):
                return mpm[0]
            idx = 1
            while idx < NUM_MPM - 1 and dec.decode_bin_ep():
                idx += 1
            return mpm[idx]
        m = read_trunc_bin(dec, NUM_LUMA_MODE - NUM_MPM)
        for v in sorted(mpm):
            if m >= v:
                m += 1
        return m

    def _dec_intra_chroma_mode(self, dec, cu: CuData) -> int:
        if self.sps.cclm and cu.cclm_allowed:
            if dec.decode_bin(ct.CTX_SETS["CclmModeFlag"](0)):
                if not dec.decode_bin(ct.CTX_SETS["CclmModeIdx"](0)):
                    return LM_CHROMA_IDX
                return MDLM_T_IDX if dec.decode_bin_ep() else MDLM_L_IDX
        if not dec.decode_bin(ct.CTX_SETS["IntraChromaPredMode"](0)):
            return DM_CHROMA
        cand_id = dec.decode_bins_ep(2)
        return chroma_cand_modes(dm_luma_mode(cu))[cand_id]


# ---------------------------------------------------------------------------
# reconstruction (shared)
# ---------------------------------------------------------------------------

def predict_cu_component(ps: PictureState, cu: CuData, comp: int,
                         bit_depth: int, ctu_size: int = 64) -> np.ndarray:
    """Intra prediction for one component of a CU from current rec state."""
    bdpcm = cu.bdpcm_y if comp == 0 else cu.bdpcm_c
    if bdpcm:
        # BDPCM: pure horizontal/vertical fill from unfiltered references
        # (IntraPrediction::xPredIntraBDPCM:683)
        if comp == 0:
            x, y, w, h = cu.x, cu.y, cu.w, cu.h
            rec, mask, unit = ps.rec[0], ps.avail_luma(), PictureState.LUMA_UNIT
        else:
            x, y, w, h = cu.x >> 1, cu.y >> 1, cu.w >> 1, cu.h >> 1
            rec, mask, unit = ps.rec[comp], ps.avail_chroma(), \
                PictureState.CHROMA_UNIT
        top, left = I.build_reference_samples(rec, x, y, w, h, mask, unit,
                                              bit_depth)
        if bdpcm == 1:
            return np.repeat(left[1:h + 1].reshape(h, 1), w, axis=1)
        return np.repeat(top[1:w + 1].reshape(1, w), h, axis=0)
    if comp != 0 and cu.chroma_dir in CCLM_MODES:
        return cclm_predict(ps, cu, comp, bit_depth, ctu_size)
    if comp == 0:
        mode = cu.luma_mode
        x, y, w, h = cu.x, cu.y, cu.w, cu.h
        rec = ps.rec[0]
        mask = ps.avail_luma()
        unit = PictureState.LUMA_UNIT
        is_luma = True
        if cu.mip_flag:
            top, left = I.build_reference_samples(rec, x, y, w, h, mask,
                                                  unit, bit_depth)
            return MIP.predict_mip(top[1:w + 1], left[1:h + 1], w, h,
                                   cu.luma_mode, cu.mip_transposed, bit_depth)
    else:
        mode = dm_luma_mode(cu) if cu.chroma_dir == DM_CHROMA \
            else cu.chroma_dir
        x, y, w, h = cu.x >> 1, cu.y >> 1, cu.w >> 1, cu.h >> 1
        rec = ps.rec[comp]
        mask = ps.avail_chroma()
        unit = PictureState.CHROMA_UNIT
        is_luma = False
    ref_line = cu.ref_line if comp == 0 else 0
    top, left = I.build_reference_samples(rec, x, y, w, h, mask, unit,
                                          bit_depth, ref_idx=ref_line)
    return I.predict_intra(top, left, mode, w, h, bit_depth, is_luma,
                           ref_idx=ref_line)


def inter_predict(ref_pics, mv, ref_idx, x, y, w, h, comp, bit_depth,
                  bcw_idx: int = 2, alt_hpel: bool = False):
    """Uni/bi motion-compensated prediction for one component block."""
    from ..ops.interp import bcw_average_np
    if ref_idx[0] >= 0 and ref_idx[1] >= 0:
        a = mc_block_np(ref_pics[0][ref_idx[0]][comp], x, y, w, h,
                        mv[0][0], mv[0][1], bit_depth,
                        is_luma=(comp == 0), intermediate=True,
                        alt_hpel=alt_hpel)
        b = mc_block_np(ref_pics[1][ref_idx[1]][comp], x, y, w, h,
                        mv[1][0], mv[1][1], bit_depth,
                        is_luma=(comp == 0), intermediate=True,
                        alt_hpel=alt_hpel)
        if bcw_idx != 2:
            return bcw_average_np(a, b, bcw_idx, bit_depth)
        return bi_average_np(a, b, bit_depth)
    li = 0 if ref_idx[0] >= 0 else 1
    ref = ref_pics[li][ref_idx[li]][comp]
    return mc_block_np(ref, x, y, w, h, mv[li][0], mv[li][1], bit_depth,
                       is_luma=(comp == 0), alt_hpel=alt_hpel)


def _ict_derive(coded: np.ndarray, mask: int, sign: int):
    """Inverse ICT (spatial domain): coded residual -> (resCb, resCr)
    (vvenc invTransformCbCr, TrQuant.cpp:148; g_ictModes Rom.cpp:1453)."""
    mode = (0, 3, 1, 2)[mask] * (-1 if sign else 1)
    am = abs(mode)
    neg = -coded if mode < 0 else coded
    if am == 1:
        return coded, neg >> 1
    if am == 2:
        return coded, neg
    return neg >> 1, coded  # am == 3: coded residual is Cr


def dmvr_predict(ref_pics, cu, comp, bit_depth, pic_w, pic_h, ctu_size):
    """Prediction of one component of a DMVR-refined CU (final padded MC
    per 16x16 sub-PU + optional BDOF; vvenc xProcessDMVR final stage)."""
    from ..ops.dmvr import clip_mv, padded_window_mc
    from ..ops.bdof import bdof_block_src
    sc = 0 if comp == 0 else 1
    sh = 4 + sc
    ref0 = ref_pics[0][cu.ref_idx[0]][comp]
    ref1 = ref_pics[1][cu.ref_idx[1]][comp]
    out = np.zeros((cu.h >> sc, cu.w >> sc), np.int32)
    for (sy, sx), delta in cu.dmvr_deltas.items():
        bw = min(16, cu.w) >> sc
        bh = min(16, cu.h) >> sc
        bx = (cu.x + sx) >> sc
        by = (cu.y + sy) >> sc
        use_bdof_n = comp == 0 and cu.dmvr_bdof.get((sy, sx), False)
        if not use_bdof_n:
            from .. import native as _native
            if _native.available():
                # fused native path: padded/plain MC for both lists +
                # bi average in one call (vte_dmvr_bi_subpu)
                out[sy >> sc:(sy >> sc) + bh,
                    sx >> sc:(sx >> sc) + bw] = _native.dmvr_bi_subpu(
                        ref0, ref1, bx, by, bw, bh, cu.mv[0], cu.mv[1],
                        delta, sc, bit_depth, pic_w, pic_h, ctu_size,
                        alt_hpel=cu.alt_hpel)
                continue
        srcs = []
        for li, sign in ((0, 1), (1, -1)):
            merge = cu.mv[li]
            ref = ref0 if li == 0 else ref1
            rmv = (max(MV_MIN, min(MV_MAX, merge[0] + sign * delta[0])),
                   max(MV_MIN, min(MV_MAX, merge[1] + sign * delta[1])))
            d_ix = (rmv[0] >> sh) - (merge[0] >> sh)
            d_iy = (rmv[1] >> sh) - (merge[1] >> sh)
            if d_ix or d_iy:
                srcs.append(("pad", ref, merge, rmv))
            else:
                cmv = clip_mv(rmv, bx << sc, by << sc, pic_w, pic_h,
                              ctu_size)
                srcs.append(("plain", ref, cmv))
        preds = []
        ext_srcs = []
        for spec in srcs:
            if spec[0] == "pad":
                _, ref, merge, rmv = spec
                preds.append(padded_window_mc(
                    ref, bx, by, bw, bh, merge, rmv, sc, bit_depth,
                    pic_w, pic_h, ctu_size, intermediate=True,
                    alt_hpel=cu.alt_hpel))
                if comp == 0:
                    from ..ops.dmvr import DMVR_ITER, NTAPS_LUMA
                    ext_srcs.append(None)  # rebuilt below
            else:
                _, ref, cmv = spec
                preds.append(mc_block_np(ref, bx, by, bw, bh, cmv[0],
                                         cmv[1], bit_depth,
                                         is_luma=(comp == 0),
                                         intermediate=True,
                                         alt_hpel=cu.alt_hpel))
        use_bdof = comp == 0 and cu.dmvr_bdof.get((sy, sx), False)
        if use_bdof:
            # BDOF needs (plane, x, y, mv) specs; padded windows get
            # block-local coordinates
            specs = []
            for spec in srcs:
                if spec[0] == "plain":
                    specs.append((spec[1], bx, by, spec[2]))
                else:
                    _, ref, merge, rmv = spec
                    from ..ops.dmvr import DMVR_ITER
                    filt = 8
                    ext = (filt >> 1) - 1
                    pad = DMVR_ITER
                    cmv0 = clip_mv(merge, bx, by, pic_w, pic_h, ctu_size)
                    x0 = bx + (cmv0[0] >> 4) - ext
                    y0 = by + (cmv0[1] >> 4) - ext
                    ph_, pw_ = ref.shape
                    xs = np.clip(np.arange(x0, x0 + bw + filt - 1), 0,
                                 pw_ - 1)
                    ys = np.clip(np.arange(y0, y0 + bh + filt - 1), 0,
                                 ph_ - 1)
                    padded = np.pad(ref[np.ix_(ys, xs)], pad, mode="edge")
                    rcl = clip_mv(rmv, bx, by, pic_w, pic_h, ctu_size)
                    d_ix = (rmv[0] >> 4) - (merge[0] >> 4)
                    d_iy = (rmv[1] >> 4) - (merge[1] >> 4)
                    fx = rcl[0] & 15
                    fy = rcl[1] & 15
                    specs.append((padded, pad + ext + d_ix,
                                  pad + ext + d_iy, (fx, fy)))
            blk = bdof_block_src(specs[0], specs[1], bw, bh, bit_depth,
                                 cu.alt_hpel)
        else:
            blk = bi_average_np(preds[0], preds[1], bit_depth)
        out[sy >> sc:(sy >> sc) + bh, sx >> sc:(sx >> sc) + bw] = blk
    return out


def bdof_predict_luma(ref0, ref1, cu, bit_depth):
    """BDOF luma prediction, split into <=16x16 sub-PUs
    (vvenc xSubPuBDOF, MAX_BDOF_APPLICATION_REGION=16)."""
    from ..ops.bdof import bdof_block
    out = np.zeros((cu.h, cu.w), dtype=np.int32)
    step = 16
    for sy in range(0, cu.h, step):
        for sx in range(0, cu.w, step):
            bw_ = min(step, cu.w - sx)
            bh = min(step, cu.h - sy)
            out[sy:sy + bh, sx:sx + bw_] = bdof_block(
                ref0, ref1, cu.x + sx, cu.y + sy, bw_, bh,
                cu.mv[0], cu.mv[1], bit_depth, cu.alt_hpel)
    return out


def isp_pred_reg_diff(w: int, h: int, isp_mode: int) -> bool:
    """Vertical ISP with partitions narrower than 4 predicts in 4-wide
    regions (CU::isPredRegDiffFromTB, UnitTools.cpp:3404; PRED_REG_MIN_WIDTH
    = 4): prediction runs once per region, TUs reuse its columns."""
    return isp_mode == 2 and (w == 4 or (w == 8 and h > 4))


def isp_predict_part(ps: PictureState, cu_x: int, cu_y: int, cu_w: int,
                     cu_h: int, isp_mode: int, mode: int, bit_depth: int,
                     px: int, py: int, pw: int, ph: int,
                     region_cache: dict) -> np.ndarray:
    """Prediction for one ISP partition: per-partition references
    (IntraPrediction.cpp initIntraPatternChTypeISP:1633-1742), with the
    4-wide prediction-region grouping for narrow vertical partitions
    (DecCu.cpp:108-126, CU::adjustPredArea)."""
    reg = isp_pred_reg_diff(cu_w, cu_h, isp_mode)
    rw = max(4, pw) if reg else pw
    if reg and (px % 4) != 0:
        # not the first TB in its prediction region: reuse
        rx = region_cache["px"]
        return region_cache["pred"][:, px - rx:px - rx + pw]
    ax, ay = cu_x + px, cu_y + py

    from .. import native as _native
    if _native.available() and ps.tile_map is None:
        top, left = _native.build_refs_isp(
            ps.rec[0], ax, ay, rw, ph, ps.coded_luma,
            PictureState.LUMA_UNIT, bit_depth,
            (cu_w + rw, cu_h + ph), cu_x, cu_y, cu_w, cu_h, isp_mode)
    else:
        def avail_fn(qx, qy, ax=ax, ay=ay):
            if cu_x <= qx < cu_x + cu_w and cu_y <= qy < cu_y + cu_h:
                return (qy < ay) if isp_mode == 1 else (qx < ax)
            return ps.is_coded(qx, qy)
        top, left = I.build_reference_samples(
            ps.rec[0], ax, ay, rw, ph, ps.avail_luma(),
            PictureState.LUMA_UNIT, bit_depth,
            pred_sizes=(cu_w + rw, cu_h + ph), avail_fn=avail_fn)
    pred = I.predict_intra(top, left, mode, rw, ph, bit_depth,
                           True, cu_dims=(cu_w, cu_h), isp=True)
    if reg:
        region_cache["px"] = px
        region_cache["pred"] = pred
        return pred[:, :pw]
    return pred


def _reconstruct_isp_luma(ps: PictureState, cu: CuData, q, bit_depth: int,
                          dep_quant: bool, sps_mts: bool) -> None:
    """Sequential ISP partition reconstruction: each partition predicts
    from the previous partitions' reconstruction (IntraPrediction.cpp
    ISP reference handling :1640-1742, spec refW/refH = nCb + nTb)."""
    maxval = (1 << bit_depth) - 1
    parts = isp_partitions(cu.w, cu.h, cu.isp_mode)
    region_cache = {}
    for k, (px, py, pw, ph) in enumerate(parts):
        ax, ay = cu.x + px, cu.y + py
        pred = isp_predict_part(ps, cu.x, cu.y, cu.w, cu.h, cu.isp_mode,
                                cu.luma_mode, bit_depth, px, py, pw, ph,
                                region_cache)
        coeff = cu.isp_coeffs[k] if cu.isp_coeffs else None
        if coeff is not None and np.any(coeff):
            trh, trv = T.isp_tr_types(pw, ph, cu.lfnst_idx, sps_mts)
            d = (T.dequant_dq_np(coeff, q, bit_depth) if dep_quant
                 else T.dequant_np(coeff, q, bit_depth))
            if cu.lfnst_idx:
                from ..ops.lfnst import inv_lfnst
                d = inv_lfnst(d, pw, ph, cu.luma_mode, cu.lfnst_idx,
                              map_dims=(cu.w, cu.h))
            resi = T.inv_transform_np(d, bit_depth, trh, trv)
            rec = np.clip(pred + resi, 0, maxval)
        else:
            rec = pred
        ps.rec[0][ay:ay + ph, ax:ax + pw] = rec


def reconstruct_cu(ps: PictureState, cu: CuData, qp: QpState, qt_depth: int,
                   bit_depth: int, ref_pics=None, comps=(0, 1, 2),
                   implicit_mts: bool = False, ctu_size: int = 64,
                   dep_quant: bool = False, jccr_sign: int = 0,
                   bdof: bool = False, coder=None) -> None:
    maxval = (1 << bit_depth) - 1

    # LMCS: forward-map inter luma prediction into the mapped domain
    # (DecCu.cpp:337 — gated off for CIIP [mapped pre-blend, :316] and IBC)
    lmcs_fwd = (coder is not None and coder.lmcs_ctu_flag and cu.is_inter
                and not cu.is_ibc)
    _adj_cache = []

    def _chroma_adj():
        if not _adj_cache:
            from .lmcs import chroma_adj_vpdu_nei
            tx0, ty0 = cu.x, cu.y
            if cu.sbt_idx:
                r = sbt_tu_rect(cu)
                tx0, ty0 = cu.x + r[0], cu.y + r[1]
            _adj_cache.append(chroma_adj_vpdu_nei(
                ps, coder.reshape, tx0, ty0,
                int(ctu_size).bit_length() - 1))
        return _adj_cache[0]

    def _scale_chroma(resi, tw, th):
        """Chroma residual scaling (DecCu.cpp:202-205; blocks > 4 samples)."""
        if (coder is None or not coder.lmcs_chroma_scale or tw * th <= 4):
            return resi
        from .lmcs import scale_chroma_resi_inv
        return scale_chroma_resi_inv(resi, _chroma_adj(), bit_depth)

    def _inter_pred(comp, x, y, w, h):
        if cu.is_ibc:
            # block copy from the unfiltered current reconstruction; the
            # fractional part is dropped for IBC, also for chroma
            # (InterPrediction::xPredInterBlk:786 isIBC -> frac = 0)
            sh = 4 if comp == 0 else 5
            return mc_block_np(ps.rec[comp], x, y, w, h,
                               (cu.mv[0][0] >> sh) << sh,
                               (cu.mv[0][1] >> sh) << sh, bit_depth,
                               is_luma=(comp == 0))
        if cu.affine:
            from .affine import affine_predict
            return affine_predict(coder, cu, comp)
        if cu.geo:
            from .geo import geo_predict
            return geo_predict(coder, cu, comp)
        if cu.ciip:
            # CIIP: regular-average MC (BCW ignored, InterPrediction.cpp:973)
            # blended with planar intra; chroma blend only for width > 2
            from .geo import ciip_blend, ciip_num_intra
            inter = inter_predict(ref_pics, cu.mv, cu.ref_idx, x, y, w, h,
                                  comp, bit_depth, 2, cu.alt_hpel)
            if comp != 0 and (cu.w >> 1) <= 2:
                return inter
            if comp == 0 and coder is not None and coder.lmcs_ctu_flag:
                # CIIP: map the inter part before blending (DecCu.cpp:316)
                inter = coder.reshape.fwd_lut[inter]
            intra = predict_cu_component(ps, cu, comp, bit_depth, ctu_size)
            return ciip_blend(inter, intra, ciip_num_intra(ps, cu))
        return inter_predict(ref_pics, cu.mv, cu.ref_idx, x, y, w, h,
                             comp, bit_depth, cu.bcw_idx, cu.alt_hpel)
    if cu.mtb_tus is not None:
        # implicit max-TB tiling: whole-CU prediction, per-TU residuals
        for comp in comps:
            if comp == 0:
                x, y, w, h = cu.x, cu.y, cu.w, cu.h
                q = qp.luma_qp()
            else:
                x, y, w, h = cu.x >> 1, cu.y >> 1, cu.w >> 1, cu.h >> 1
                q = qp.chroma_qp(comp)
            if cu.dmvr_deltas is not None:
                pred = dmvr_predict(ref_pics, cu, comp, bit_depth,
                                    ps.w, ps.h, ctu_size)
            elif bdof and comp == 0:
                pred = bdof_predict_luma(ref_pics[0][cu.ref_idx[0]][0],
                                         ref_pics[1][cu.ref_idx[1]][0],
                                         cu, bit_depth)
            else:
                pred = _inter_pred(comp, x, y, w, h)
            pred = np.asarray(pred).astype(np.int64)
            if comp == 0 and lmcs_fwd:
                pred = coder.reshape.fwd_lut[pred]
            rec = pred.copy()
            for (tx, ty, tw_, th_, cy_, ccb, ccr, joint,
                 ts_cb, ts_cr) in cu.mtb_tus:
                sc = 0 if comp == 0 else 1
                ox, oy = tx >> sc, ty >> sc
                if comp == 0:
                    coeff = cy_
                elif joint:
                    cc_ = 1 if joint in (2, 3) else 2
                    coeff = ccb if cc_ == 1 else ccr
                else:
                    coeff = ccb if comp == 1 else ccr
                if coeff is None or not np.any(coeff):
                    continue
                qq = qp.joint_qp() if (comp != 0 and joint == 3) else q
                if comp == 0:
                    ts_ = False
                elif joint:
                    ts_ = ts_cb if joint in (2, 3) else ts_cr
                else:
                    ts_ = ts_cb if comp == 1 else ts_cr
                if ts_:
                    resi = T.dequant_ts_np(coeff, qq,
                                           coder.min_qp_ts if coder else 16)
                else:
                    d = (T.dequant_dq_np(coeff, qq, bit_depth) if dep_quant
                         else T.dequant_np(coeff, qq, bit_depth))
                    resi = T.inv_transform_np(d, bit_depth)
                if comp != 0:
                    if joint:
                        rcb, rcr = _ict_derive(resi.astype(np.int64),
                                               joint, jccr_sign)
                        resi = rcb if comp == 1 else rcr
                    # LMCS chroma scaling with the TU-position adj
                    if (coder is not None and coder.lmcs_chroma_scale
                            and (tw_ >> 1) * (th_ >> 1) > 4):
                        from .lmcs import (chroma_adj_vpdu_nei,
                                           scale_chroma_resi_inv)
                        adj = chroma_adj_vpdu_nei(
                            ps, coder.reshape, cu.x + tx, cu.y + ty,
                            int(ctu_size).bit_length() - 1)
                        resi = scale_chroma_resi_inv(resi, adj, bit_depth)
                rec[oy:oy + (th_ >> sc), ox:ox + (tw_ >> sc)] += resi
            ps.rec[comp][y:y + h, x:x + w] = np.clip(rec, 0, maxval)
        ps.mark_cu(cu.x, cu.y, cu.w, cu.h, qt_depth, DC,
                   is_intra=False, is_mip=False,
                   with_chroma=not cu.luma_only, qp=qp.qp_y)
        return

    joint_resi = {}
    if cu.joint_cbcr and (1 in comps or 2 in comps):
        coded_comp = 1 if cu.joint_cbcr in (2, 3) else 2
        coeff = cu.coeff_cb if coded_comp == 1 else cu.coeff_cr
        q = qp.joint_qp() if cu.joint_cbcr == 3 \
            else qp.chroma_qp(coded_comp)
        ts_j = cu.ts_cb if coded_comp == 1 else cu.ts_cr
        if ts_j:
            resi = T.dequant_ts_np(coeff, q,
                                   coder.min_qp_ts if coder else 16)
        else:
            d = (T.dequant_dq_np(coeff, q, bit_depth) if dep_quant
                 else T.dequant_np(coeff, q, bit_depth))
            if cu.lfnst_idx and cu.chroma_only:
                from ..ops.lfnst import inv_lfnst
                d = inv_lfnst(d, cu.w >> 1, cu.h >> 1,
                              lfnst_chroma_mode(cu), cu.lfnst_idx)
            resi = T.inv_transform_np(d, bit_depth)
        rcb, rcr = _ict_derive(resi.astype(np.int64), cu.joint_cbcr,
                               jccr_sign)
        rcb = _scale_chroma(rcb, rcb.shape[1], rcb.shape[0])
        rcr = _scale_chroma(rcr, rcr.shape[1], rcr.shape[0])
        joint_resi = {1: rcb, 2: rcr}
    for comp, coeff in ((0, cu.coeff_y), (1, cu.coeff_cb), (2, cu.coeff_cr)):
        if comp not in comps:
            continue
        if comp in joint_resi:
            x, y, w, h = cu.x >> 1, cu.y >> 1, cu.w >> 1, cu.h >> 1
            if cu.is_inter:
                pred = _inter_pred(comp, x, y, w, h)
            else:
                pred = predict_cu_component(ps, cu, comp, bit_depth,
                                            ctu_size)
            jr = joint_resi[comp]
            if cu.sbt_idx:
                tx_, ty_ = sbt_tu_rect(cu)[:2]
                full = np.zeros((h, w), np.int64)
                full[ty_ >> 1:(ty_ >> 1) + jr.shape[0],
                     tx_ >> 1:(tx_ >> 1) + jr.shape[1]] = jr
                jr = full
            ps.rec[comp][y:y + h, x:x + w] = \
                np.clip(pred + jr, 0, maxval)
            continue
        if comp == 0:
            x, y, w, h = cu.x, cu.y, cu.w, cu.h
            q = qp.luma_qp()
            if cu.isp_mode:
                _reconstruct_isp_luma(ps, cu, q, bit_depth, dep_quant,
                                      bool(coder.sps.mts) if coder else True)
                continue
        else:
            x, y, w, h = cu.x >> 1, cu.y >> 1, cu.w >> 1, cu.h >> 1
            q = qp.chroma_qp(comp)
        if cu.is_inter:
            if cu.dmvr_deltas is not None:
                pred = dmvr_predict(ref_pics, cu, comp, bit_depth,
                                    ps.w, ps.h, ctu_size)
            elif bdof and comp == 0:
                pred = bdof_predict_luma(ref_pics[0][cu.ref_idx[0]][0],
                                         ref_pics[1][cu.ref_idx[1]][0],
                                         cu, bit_depth)
            else:
                pred = _inter_pred(comp, x, y, w, h)
        else:
            pred = predict_cu_component(ps, cu, comp, bit_depth, ctu_size)
        ts_c = (cu.ts_y or cu.bdpcm_y) if comp == 0 else \
            ((cu.ts_cb if comp == 1 else cu.ts_cr) or cu.bdpcm_c)
        if comp == 0 and lmcs_fwd and not cu.ciip:
            pred = coder.reshape.fwd_lut[pred]
        if ts_c and coeff is not None and np.any(coeff):
            bd = cu.bdpcm_y if comp == 0 else cu.bdpcm_c
            cc = T.inv_res_dpcm(coeff, bd) if bd else coeff
            resi = T.dequant_ts_np(cc, q,
                                   coder.min_qp_ts if coder else 16)
            if comp != 0:
                resi = _scale_chroma(resi, resi.shape[1], resi.shape[0])
            ps.rec[comp][y:y + h, x:x + w] = \
                np.clip(pred + resi, 0, maxval)
            continue
        if coeff is not None and np.any(coeff):
            if cu.sbt_idx:
                tx_, ty_, _, _, trh, trv = sbt_tu_rect(cu)
                # SBT DST7/DCT8 requires sps_mts (TrQuant::xSetTrTypes:424)
                if comp != 0 or not (coder is not None
                                     and getattr(coder.sps, "mts", 0)):
                    trh = trv = T.DCT2
            elif comp == 0 and cu.mts_idx:
                trh, trv = T.mts_tr_types(cu.mts_idx)
            else:
                # implicit MTS only applies with lfnst_idx == 0 and for
                # non-MIP intra luma (8.7.4.1)
                trh, trv = T.implicit_mts_types(
                    w, h, not cu.is_inter and comp == 0,
                    implicit_mts and cu.lfnst_idx == 0 and not cu.mip_flag)
            d = (T.dequant_dq_np(coeff, q, bit_depth) if dep_quant
                 else T.dequant_np(coeff, q, bit_depth))
            if cu.lfnst_idx and (comp == 0 or cu.chroma_only):
                from ..ops.lfnst import inv_lfnst
                if comp == 0:
                    lmode = PLANAR if cu.mip_flag else cu.luma_mode
                else:
                    lmode = lfnst_chroma_mode(cu)
                d = inv_lfnst(d, w, h, lmode, cu.lfnst_idx)
            resi = T.inv_transform_np(d, bit_depth, trh, trv)
            if comp != 0:
                resi = _scale_chroma(resi, resi.shape[1], resi.shape[0])
            if cu.sbt_idx:
                sc_ = 0 if comp == 0 else 1
                full = np.zeros((h, w), resi.dtype)
                full[ty_ >> sc_:(ty_ >> sc_) + resi.shape[0],
                     tx_ >> sc_:(tx_ >> sc_) + resi.shape[1]] = resi
                resi = full
            rec = np.clip(pred + resi, 0, maxval)
        else:
            rec = pred
        ps.rec[comp][y:y + h, x:x + w] = rec
    if cu.chroma_only:
        ps.mark_chroma(cu.x, cu.y, cu.w, cu.h, qt_depth)
    else:
        ps.mark_cu(cu.x, cu.y, cu.w, cu.h, qt_depth,
                   dm_luma_mode(cu) if not cu.is_inter else DC,
                   is_intra=not cu.is_inter, is_mip=cu.mip_flag,
                   with_chroma=not cu.luma_only, qp=qp.qp_y)

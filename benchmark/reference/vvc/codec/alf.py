"""Adaptive loop filter (ALF) + cross-component ALF, H.266 8.8.5.

Gradient-based 4x4 classification (25 classes x 4 transposes), 7x7 diamond
luma / 5x5 diamond chroma clipped filtering with the CTU-row virtual
boundary, the 16 normative fixed filter sets, APS syntax, and the CTU-level
CABAC syntax.

Behavioral reference: vvenc CommonLib/AdaptiveLoopFilter.cpp
(deriveClassificationBlk:524, filterBlk:731, filterBlkCcAlf:969,
reconstructCoeff:343, clipping values create():417-430),
EncoderLib/VLCWriter.cpp codeAlfAps:465/alfFilter, CABACWriter.cpp
coding_tree_unit ALF block:168-203, codeAlfCtuEnabledFlag:2890,
codeAlfCtuFilterIndex:3005, codeAlfCtuAlternative:3072,
codeCcAlfFilterControlIdc:2925.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..bitstream import ctx_tables as ct

MAX_NUM_ALF_CLASSES = 25
MAX_NUM_ALF_LUMA_COEFF = 13
NUM_FIXED_FILTER_SETS = 16
MAX_NUM_CC_ALF_FILTERS = 4
CCALF_BITS_PER_COEFF_LEVEL = 3
ALF_CTB_MAX_NUM_APS = 8
NUM_BITS = 8          # coefficient precision
SCALE_BITS = 7        # CC-ALF coefficient precision

_FIX = np.load(os.path.join(os.path.dirname(__file__), "alf_fixed.npz"))
FIXED_COEFF = _FIX["coef"]        # [64][13]
CLASS_TO_FILTER = _FIX["mapping"]  # [16][25]

# luma 7x7 transpose shuffles (vvenc filterBlk:820-850)
_TR7 = [list(range(13)),
        [9, 4, 10, 8, 1, 5, 11, 7, 3, 0, 2, 6, 12],
        [0, 3, 2, 1, 8, 7, 6, 5, 4, 9, 10, 11, 12],
        [9, 8, 10, 4, 3, 7, 11, 5, 1, 0, 2, 6, 12]]
_TR5 = [list(range(7)),
        [4, 1, 5, 3, 0, 2, 6],
        [0, 3, 2, 1, 4, 5, 6],
        [4, 3, 5, 1, 0, 2, 6]]


def clipping_values(bit_depth: int) -> np.ndarray:
    """Normative clip value table per clip idx (vvenc create():417)."""
    v = np.zeros(4, dtype=np.int32)
    v[0] = 1 << bit_depth
    for i in range(1, 4):
        v[i] = 1 << (7 - 2 * i + bit_depth - 8)
    return v


@dataclass
class AlfParam:
    new_filter: List[int] = field(default_factory=lambda: [0, 0])  # [L, C]
    nonlinear: List[int] = field(default_factory=lambda: [0, 0])
    num_luma_filters: int = 1
    filter_idx: List[int] = field(default_factory=lambda: [0] * 25)
    luma_coeff: Optional[np.ndarray] = None    # [numFilters][12] signalled
    luma_clip: Optional[np.ndarray] = None     # [numFilters][12] clip idx
    num_alts_chroma: int = 1
    chroma_coeff: Optional[np.ndarray] = None  # [alts][6]
    chroma_clip: Optional[np.ndarray] = None   # [alts][6]
    # CC-ALF (per component cb=0 / cr=1)
    cc_filter_signal: List[int] = field(default_factory=lambda: [0, 0])
    cc_filter_count: List[int] = field(default_factory=lambda: [0, 0])
    cc_coeff: Optional[np.ndarray] = None      # [2][4][7]


# ---------------------------------------------------------------------------
# APS syntax
# ---------------------------------------------------------------------------

ALF_APS = 0
LMCS_APS = 1
SCALING_LIST_APS = 2


def write_alf_aps(bw, aps_id: int, p: AlfParam, chroma_present: bool = True):
    """APS RBSP with ALF payload (vvenc HLSWriter::codeAPS:434)."""
    bw.write(ALF_APS, 3)
    bw.write(aps_id, 5)
    bw.write_flag(1 if chroma_present else 0)
    bw.write_flag(p.new_filter[0])
    if chroma_present:
        bw.write_flag(p.new_filter[1])
        bw.write_flag(p.cc_filter_signal[0])
        bw.write_flag(p.cc_filter_signal[1])
    if p.new_filter[0]:
        bw.write_flag(p.nonlinear[0])
        bw.write_uvlc(p.num_luma_filters - 1)
        if p.num_luma_filters > 1:
            ln = max(1, (p.num_luma_filters - 1).bit_length())
            for i in range(MAX_NUM_ALF_CLASSES):
                bw.write(p.filter_idx[i], ln)
        _write_filter(bw, p.luma_coeff, p.luma_clip, p.nonlinear[0],
                      p.num_luma_filters, 12)
    if p.new_filter[1]:
        bw.write_flag(p.nonlinear[1])
        bw.write_uvlc(p.num_alts_chroma - 1)
        for alt in range(p.num_alts_chroma):
            _write_filter(bw, p.chroma_coeff[alt:alt + 1],
                          p.chroma_clip[alt:alt + 1] if p.chroma_clip
                          is not None else None, p.nonlinear[1], 1, 6)
    for cc in range(2):
        if p.cc_filter_signal[cc]:
            bw.write_uvlc(p.cc_filter_count[cc] - 1)
            for f in range(p.cc_filter_count[cc]):
                for i in range(7):
                    c = int(p.cc_coeff[cc][f][i])
                    if c == 0:
                        bw.write(0, CCALF_BITS_PER_COEFF_LEVEL)
                    else:
                        bw.write(1 + (abs(c).bit_length() - 1),
                                 CCALF_BITS_PER_COEFF_LEVEL)
                        bw.write_flag(1 if c < 0 else 0)
    bw.write_rbsp_trailing_bits()


def _write_filter(bw, coeff, clip, nonlinear, num_filters, n):
    for f in range(num_filters):
        for i in range(n):
            c = int(coeff[f][i])
            bw.write_uvlc(abs(c))
            if c:
                bw.write_flag(1 if c < 0 else 0)
    if nonlinear:
        for f in range(num_filters):
            for i in range(n):
                bw.write(int(clip[f][i]) if clip is not None else 0, 2)


def read_aps(br):
    """Returns (aps_type, aps_id, AlfParam-or-None)."""
    aps_type = br.read(3)
    aps_id = br.read(5)
    chroma_present = br.read_flag()
    if aps_type == LMCS_APS:
        from .lmcs import read_lmcs_payload
        return aps_type, aps_id, read_lmcs_payload(br, chroma_present)
    if aps_type != ALF_APS:
        return aps_type, aps_id, None
    p = AlfParam()
    p.new_filter[0] = br.read_flag()
    if chroma_present:
        p.new_filter[1] = br.read_flag()
        p.cc_filter_signal[0] = br.read_flag()
        p.cc_filter_signal[1] = br.read_flag()
    if p.new_filter[0]:
        p.nonlinear[0] = br.read_flag()
        p.num_luma_filters = br.read_uvlc() + 1
        if p.num_luma_filters > 1:
            ln = max(1, (p.num_luma_filters - 1).bit_length())
            p.filter_idx = [br.read(ln) for _ in range(MAX_NUM_ALF_CLASSES)]
        p.luma_coeff, p.luma_clip = _read_filter(br, p.nonlinear[0],
                                                 p.num_luma_filters, 12)
    if p.new_filter[1]:
        p.nonlinear[1] = br.read_flag()
        p.num_alts_chroma = br.read_uvlc() + 1
        cc = np.zeros((p.num_alts_chroma, 6), np.int32)
        cl = np.zeros((p.num_alts_chroma, 6), np.int32)
        for alt in range(p.num_alts_chroma):
            c, l = _read_filter(br, p.nonlinear[1], 1, 6)
            cc[alt] = c[0]
            cl[alt] = l[0]
        p.chroma_coeff, p.chroma_clip = cc, cl
    p.cc_coeff = np.zeros((2, MAX_NUM_CC_ALF_FILTERS, 7), np.int32)
    for cc_i in range(2):
        if p.cc_filter_signal[cc_i]:
            p.cc_filter_count[cc_i] = br.read_uvlc() + 1
            for f in range(p.cc_filter_count[cc_i]):
                for i in range(7):
                    lvl = br.read(CCALF_BITS_PER_COEFF_LEVEL)
                    if lvl:
                        v = 1 << (lvl - 1)
                        if br.read_flag():
                            v = -v
                        p.cc_coeff[cc_i][f][i] = v
    return aps_type, aps_id, p


def _read_filter(br, nonlinear, num_filters, n):
    coeff = np.zeros((num_filters, n), np.int32)
    clip = np.zeros((num_filters, n), np.int32)
    for f in range(num_filters):
        for i in range(n):
            a = br.read_uvlc()
            if a:
                coeff[f][i] = -a if br.read_flag() else a
    if nonlinear:
        for f in range(num_filters):
            for i in range(n):
                clip[f][i] = br.read(2)
    return coeff, clip


# ---------------------------------------------------------------------------
# coefficient reconstruction
# ---------------------------------------------------------------------------

def reconstruct_luma_coeff(p: AlfParam, bit_depth: int):
    """Per-class [25][13] coefficient + clip-VALUE arrays for a signalled
    luma filter set (vvenc reconstructCoeff:343)."""
    factor = 1 << (NUM_BITS - 1)
    clips = clipping_values(bit_depth)
    coeff = np.zeros((MAX_NUM_ALF_CLASSES, 13), np.int32)
    clipv = np.full((MAX_NUM_ALF_CLASSES, 13), clips[0], np.int32)
    for cls in range(MAX_NUM_ALF_CLASSES):
        f = p.filter_idx[cls] if p.num_luma_filters > 1 else 0
        coeff[cls, :12] = p.luma_coeff[f]
        coeff[cls, 12] = factor
        if p.nonlinear[0]:
            clipv[cls, :12] = clips[p.luma_clip[f]]
        else:
            clipv[cls, :12] = clips[0]
    return coeff, clipv


def fixed_set_coeff(set_idx: int, bit_depth: int):
    """[25][13] coefficients + clip values of fixed filter set 0..15."""
    clips = clipping_values(bit_depth)
    coeff = np.zeros((MAX_NUM_ALF_CLASSES, 13), np.int32)
    clipv = np.full((MAX_NUM_ALF_CLASSES, 13), clips[0], np.int32)
    for cls in range(MAX_NUM_ALF_CLASSES):
        coeff[cls] = FIXED_COEFF[CLASS_TO_FILTER[set_idx][cls]]
    return coeff, clipv


def reconstruct_chroma_coeff(p: AlfParam, alt: int, bit_depth: int):
    factor = 1 << (NUM_BITS - 1)
    clips = clipping_values(bit_depth)
    coeff = np.zeros(7, np.int32)
    coeff[:6] = p.chroma_coeff[alt]
    coeff[6] = factor
    clipv = np.full(7, clips[0], np.int32)
    if p.nonlinear[1]:
        clipv[:6] = clips[p.chroma_clip[alt]]
    return coeff, clipv


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

_ACT_TH = np.array([0, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 4],
                   np.int32)
_TRANSPOSE_TABLE = [0, 1, 0, 2, 2, 3, 1, 3]


def classify_luma(rec: np.ndarray, bit_depth: int, ctu_size: int):
    """4x4 classification over the whole picture (deriveClassificationBlk).

    rec: post-SAO luma plane.  Returns (class_idx, transpose_idx) arrays of
    shape (H//4, W//4)."""
    h, w = rec.shape
    from .. import native
    if native.available():
        return native.alf_classify(rec, bit_depth, ctu_size)
    shift = bit_depth + 4
    vb_pos = ctu_size - 4
    pad = 4
    s = np.pad(rec, pad, mode="edge").astype(np.int64)
    hp = s.shape[0]

    # per-row neighbor indices with the virtual-boundary substitution
    # (vvenc :558-566: the row pair (y, y+1) reads rows y-1..y+2; row y-1
    # is replaced by y when y%ctu == vbPos, row y+2 by y+1 when
    # y%ctu == vbPos-2 — per-row this is: above(y)=y iff y%ctu==vbPos,
    # below(y)=y iff y%ctu==vbPos-1)
    yy = np.arange(-pad, h + pad)
    ym = yy - 1
    yp = yy + 1
    mm = (yy > 0) & ((yy & (ctu_size - 1)) == vb_pos)
    ym[mm] = yy[mm]
    mp = (yy > 0) & ((yy & (ctu_size - 1)) == vb_pos - 1)
    yp[mp] = yy[mp]
    ridx = np.clip(yy + pad, 0, hp - 1)
    midx = np.clip(ym + pad, 0, hp - 1)
    pidx = np.clip(yp + pad, 0, hp - 1)
    sc = s[ridx]
    sm = s[midx]
    sp2 = s[pidx]
    c2 = 2 * sc
    # full-resolution laplacians (on padded columns)
    lv = np.abs(c2[:, 1:-1] - sm[:, 1:-1] - sp2[:, 1:-1])
    lh = np.abs(c2[:, 1:-1] - sc[:, :-2] - sc[:, 2:])
    ld0 = np.abs(c2[:, 1:-1] - sm[:, :-2] - sp2[:, 2:])
    ld1 = np.abs(c2[:, 1:-1] - sp2[:, :-2] - sm[:, 2:])
    # grid points: (y_c, x_c) at even offsets starting -2; value =
    # lap(y_c, x_c) + lap(y_c+1, x_c+1)
    # padded-row index of y_c: y_c + pad; padded-col index of x_c in the
    # lv arrays (which dropped one col): x_c + pad - 1
    gy = np.arange(-2, h + 2, 2) + pad          # rows of y_c
    gx = np.arange(-2, w + 2, 2) + pad - 1      # cols of x_c
    def grid(a):
        return a[gy][:, gx] + a[gy + 1][:, gx + 1]
    gv, gh_, gd0, gd1 = grid(lv), grid(lh), grid(ld0), grid(ld1)

    # 4x4 block windows over the grid (4x4 grid entries, stride 2)
    n_by, n_bx = h // 4, w // 4
    def wsum(a, r0, r1):
        # sum over grid rows [by*2+r0, by*2+r1) and cols [bx*2, bx*2+4)
        cs = np.cumsum(a, axis=1)
        colw = cs[:, 3:] - np.concatenate(
            [np.zeros((a.shape[0], 1), a.dtype), cs[:, :-4]], axis=1)
        colw = colw[:, 0::2][:, :n_bx]          # (GY, n_bx)
        out = np.zeros((n_by, n_bx), np.int64)
        for by in range(n_by):
            out[by] = colw[by * 2 + r0:by * 2 + r1].sum(axis=0)
        return out

    blk_vb = (np.arange(n_by) * 4) & (ctu_size - 1)
    rows_case = np.where(blk_vb == vb_pos - 4, 1,
                         np.where(blk_vb == vb_pos, 2, 0))
    sv = np.zeros((n_by, n_bx), np.int64)
    sh_ = np.zeros_like(sv)
    sd0 = np.zeros_like(sv)
    sd1 = np.zeros_like(sv)
    for case, (r0, r1) in ((0, (0, 4)), (1, (0, 3)), (2, (1, 4))):
        m = rows_case == case
        if not m.any():
            continue
        sv[m] = wsum(gv, r0, r1)[m]
        sh_[m] = wsum(gh_, r0, r1)[m]
        sd0[m] = wsum(gd0, r0, r1)[m]
        sd1[m] = wsum(gd1, r0, r1)[m]
    mult = np.where(rows_case[:, None] == 0, 64, 96)

    act = np.clip(((sv + sh_) * mult) >> shift, 0, 15).astype(np.int32)
    cls = _ACT_TH[act].copy()
    hv_swap = sv > sh_
    hv1 = np.where(hv_swap, sv, sh_)
    hv0 = np.where(hv_swap, sh_, sv)
    dir_hv = np.where(hv_swap, 1, 3)
    d_swap = sd0 > sd1
    dd1 = np.where(d_swap, sd0, sd1)
    dd0 = np.where(d_swap, sd1, sd0)
    dir_d = np.where(d_swap, 0, 2)
    use_d = dd1 * hv0 > hv1 * dd0
    hvd1 = np.where(use_d, dd1, hv1)
    hvd0 = np.where(use_d, dd0, hv0)
    main_dir = np.where(use_d, dir_d, dir_hv)
    sec_dir = np.where(use_d, dir_hv, dir_d)
    strength = (hvd1 > 2 * hvd0).astype(np.int32) + \
        (hvd1 * 2 > 9 * hvd0).astype(np.int32)
    cls = cls + np.where(strength > 0,
                         (((main_dir & 1) << 1) + strength) * 5, 0)
    trn = np.asarray(_TRANSPOSE_TABLE, np.int32)[main_dir * 2
                                                 + (sec_dir >> 1)]
    return cls.astype(np.int32), trn.astype(np.int32)


# ---------------------------------------------------------------------------
# filtering
# ---------------------------------------------------------------------------

def _vb_taps(yvb: int, vb_pos: int, is_chroma: bool):
    """Per-row vertical tap clamping offsets (filterBlk:880-900).

    Returns (o1, o2, o3, o4, o5, o6) row offsets for pImg1..6 (+1,-1,+2,
    -2,+3,-3) and the near-VB flag."""
    o1, o2, o3, o4, o5, o6 = 1, -1, 2, -2, 3, -3
    rng = 2 if is_chroma else 4
    if yvb < vb_pos and yvb >= vb_pos - rng:      # above the boundary
        if yvb == vb_pos - 1:
            o1, o2 = 0, 0
        if yvb >= vb_pos - 2:
            o3, o4 = o1, o2
        if yvb >= vb_pos - 3:
            o5, o6 = o3, o4
    elif yvb >= vb_pos and yvb <= vb_pos + rng - 1:   # below
        if yvb == vb_pos:
            o1, o2 = 0, 0
        if yvb <= vb_pos + 1:
            o3, o4 = o1, o2
        if yvb <= vb_pos + 2:
            o5, o6 = o3, o4
    near = yvb == vb_pos - 1 or yvb == vb_pos
    return o1, o2, o3, o4, o5, o6, near


def _clip_alf(clip, curr, v0, v1):
    return np.clip(v0 - curr, -clip, clip) + np.clip(v1 - curr, -clip, clip)


def filter_luma_region(src: np.ndarray, dst: np.ndarray, x0, y0, w0, h0,
                       cls, trn, coeff, clipv, bit_depth, ctu_size,
                       sp=None):
    """7x7 diamond clipped ALF over region (x0, y0, w0, h0) of src -> dst.

    cls/trn: per-4x4 classification of the picture; coeff/clipv: [25][13].
    sp: optional pre-padded (pad=3, edge) int64 copy of src — pass it when
    filtering many regions of one plane (apply_alf_picture)."""
    h, w = src.shape
    from .. import native
    if native.available():
        native.alf_luma(src, dst, x0, y0, w0, h0, cls, trn, coeff, clipv,
                        bit_depth, ctu_size)
        return
    pad = 3
    if sp is None:
        sp = np.pad(src, pad, mode="edge").astype(np.int64)
    vb_pos = ctu_size - 4
    maxval = (1 << bit_depth) - 1
    shift = NUM_BITS - 1
    # tap pattern (dy, dx) pairs per coefficient (non-transposed, 7x7):
    # tap pairs per coefficient (vvenc filterBlk:905-917; pImg1/3/5 are
    # the rows BELOW, pImg2/4/6 above)
    taps = [((3, 0), (-3, 0)), ((2, 1), (-2, -1)), ((2, 0), (-2, 0)),
            ((2, -1), (-2, 1)), ((1, 2), (-1, -2)), ((1, 1), (-1, -1)),
            ((1, 0), (-1, 0)), ((1, -1), (-1, 1)), ((1, -2), (-1, 2)),
            ((0, 3), (0, -3)), ((0, 2), (0, -2)), ((0, 1), (0, -1))]
    ys = np.arange(y0, min(y0 + h0, h))
    xs = np.arange(x0, min(x0 + w0, w))
    ny = len(ys)
    # per-row VB-dependent tap offsets + shift
    omap = {0: np.zeros(ny, np.int32)}
    near_v = np.zeros(ny, bool)
    offs = np.zeros((ny, 6), np.int32)
    for i, yy in enumerate(ys):
        o1, o2, o3, o4, o5, o6, near = _vb_taps(int(yy) & (ctu_size - 1),
                                                vb_pos, False)
        offs[i] = (o1, o2, o3, o4, o5, o6)
        near_v[i] = near
    omap[1], omap[-1], omap[2] = offs[:, 0], offs[:, 1], offs[:, 2]
    omap[-2], omap[3], omap[-3] = offs[:, 3], offs[:, 4], offs[:, 5]
    row_shift = np.where(near_v, shift + 3, shift)[:, None]
    row_off = (np.int64(1) << (row_shift - 1))

    curr = sp[ys[:, None] + pad, xs[None, :] + pad]
    bcls = cls[ys[:, None] >> 2, xs[None, :] >> 2]
    btrn = trn[ys[:, None] >> 2, xs[None, :] >> 2]
    co = coeff[bcls]     # (ny, nx, 13)
    cl = clipv[bcls]
    for t in (1, 2, 3):  # transpose shuffles
        m = btrn == t
        if m.any():
            co[m] = co[m][:, _TR7[t]]
            cl[m] = cl[m][:, _TR7[t]]
    acc = np.zeros((ny, len(xs)), np.int64)
    for ci, ((dy0, dx0), (dy1, dx1)) in enumerate(taps):
        r0 = ys + omap[dy0]
        r1 = ys + omap[dy1]
        v0 = sp[r0[:, None] + pad, (xs + dx0)[None, :] + pad]
        v1 = sp[r1[:, None] + pad, (xs + dx1)[None, :] + pad]
        acc += co[:, :, ci] * _clip_alf(cl[:, :, ci], curr, v0, v1)
    out = (acc + row_off) >> row_shift
    dst[ys[:, None], xs[None, :]] = np.clip(curr + out, 0, maxval)


def filter_chroma_region(src: np.ndarray, dst: np.ndarray, x0, y0, w0, h0,
                         coeff, clipv, bit_depth, ctu_size_c, sp=None):
    """5x5 diamond chroma ALF (single filter per alternative)."""
    h, w = src.shape
    from .. import native
    if native.available():
        native.alf_chroma(src, dst, x0, y0, w0, h0, coeff, clipv,
                          bit_depth, ctu_size_c)
        return
    pad = 2
    if sp is None:
        sp = np.pad(src, pad, mode="edge").astype(np.int64)
    vb_pos = ctu_size_c - 2
    maxval = (1 << bit_depth) - 1
    shift = NUM_BITS - 1
    taps = [((2, 0), (-2, 0)), ((1, 1), (-1, -1)), ((1, 0), (-1, 0)),
            ((1, -1), (-1, 1)), ((0, 2), (0, -2)), ((0, 1), (0, -1))]
    ys = np.arange(y0, min(y0 + h0, h))
    xs = np.arange(x0, min(x0 + w0, w))
    ny = len(ys)
    omap = {0: np.zeros(ny, np.int32)}
    near_v = np.zeros(ny, bool)
    offs = np.zeros((ny, 4), np.int32)
    for i, yy in enumerate(ys):
        o1, o2, o3, o4, _, _, near = _vb_taps(int(yy) & (ctu_size_c - 1),
                                              vb_pos, True)
        offs[i] = (o1, o2, o3, o4)
        near_v[i] = near
    omap[1], omap[-1], omap[2], omap[-2] = (offs[:, 0], offs[:, 1],
                                            offs[:, 2], offs[:, 3])
    row_shift = np.where(near_v, shift + 3, shift)[:, None]
    row_off = (np.int64(1) << (row_shift - 1))
    curr = sp[ys[:, None] + pad, xs[None, :] + pad]
    acc = np.zeros((ny, len(xs)), np.int64)
    for ci, ((dy0, dx0), (dy1, dx1)) in enumerate(taps):
        r0 = ys + omap[dy0]
        r1 = ys + omap[dy1]
        v0 = sp[r0[:, None] + pad, (xs + dx0)[None, :] + pad]
        v1 = sp[r1[:, None] + pad, (xs + dx1)[None, :] + pad]
        acc += int(coeff[ci]) * _clip_alf(int(clipv[ci]), curr, v0, v1)
    out = (acc + row_off) >> row_shift
    dst[ys[:, None], xs[None, :]] = np.clip(curr + out, 0, maxval)


def filter_ccalf_region(luma: np.ndarray, chroma_dst: np.ndarray,
                        x0c, y0c, w0c, h0c, coeff, bit_depth, ctu_size):
    """Cross-component ALF: 3x4 diamond on co-located luma adds a
    correction to the (already ALF-filtered) chroma (filterBlkCcAlf:969).
    4:2:0 only.  x0c.. in chroma coords; luma is the pre-CC (post-SAO,
    pre-ALF? no: SAO-filtered luma) plane."""
    hc, wc = chroma_dst.shape
    h, w = luma.shape
    from .. import native
    if native.available():
        native.alf_ccalf(luma, chroma_dst, x0c, y0c, w0c, h0c, coeff,
                         bit_depth, ctu_size)
        return
    pad = 2
    lp = np.pad(luma, pad, mode="edge").astype(np.int64)
    vb_pos = ctu_size - 4
    maxval = (1 << bit_depth) - 1
    for yy in range(y0c, min(y0c + h0c, hc)):
        ly = yy << 1
        pos = ly & (ctu_size - 1)
        off1, off2, off3 = 1, -1, 2
        if pos == vb_pos - 2 or pos == vb_pos + 1:
            off3 = off1
        elif pos == vb_pos - 1 or pos == vb_pos:
            off1 = off2 = off3 = 0
        xs = np.arange(x0c, min(x0c + w0c, wc))
        lx = xs << 1
        curr = lp[ly + pad, lx + pad]
        s = np.zeros(len(xs), np.int64)
        s += coeff[0] * (lp[ly + off2 + pad, lx + pad] - curr)
        s += coeff[1] * (lp[ly + pad, lx - 1 + pad] - curr)
        s += coeff[2] * (lp[ly + pad, lx + 1 + pad] - curr)
        s += coeff[3] * (lp[ly + off1 + pad, lx - 1 + pad] - curr)
        s += coeff[4] * (lp[ly + off1 + pad, lx + pad] - curr)
        s += coeff[5] * (lp[ly + off1 + pad, lx + 1 + pad] - curr)
        s += coeff[6] * (lp[ly + off3 + pad, lx + pad] - curr)
        s = (s + ((1 << SCALE_BITS) >> 1)) >> SCALE_BITS
        half = 1 << bit_depth >> 1
        s = np.clip(s + half, 0, maxval) - half
        chroma_dst[yy, xs] = np.clip(chroma_dst[yy, xs] + s, 0, maxval)


# ---------------------------------------------------------------------------
# CTU-level CABAC syntax
# ---------------------------------------------------------------------------

def code_alf_ctu(coder, encode: bool, ctu_addr: int, w_ctus: int,
                 alf_enabled, num_aps: int, num_alts_chroma: int,
                 ctu_flags, ctu_filter_idx, ctu_alt,
                 cc_enabled, cc_filter_count, cc_control,
                 avail_left=None, avail_up=None):
    """Read/write the per-CTU ALF syntax at the start of a CTU
    (vvenc CABACWriter::coding_tree_unit:168-203).

    ctu_flags: [3][n_ctus] enable flags; ctu_filter_idx: [n_ctus] luma
    filter set index; ctu_alt: [2][n_ctus] chroma alternative;
    cc_control: [2][n_ctus] cc-alf filter control idc."""
    rx = ctu_addr % w_ctus
    ry = ctu_addr // w_ctus
    has_left = rx > 0 if avail_left is None else avail_left
    has_up = ry > 0 if avail_up is None else avail_up
    for comp in range(3):
        if not alf_enabled[comp]:
            continue
        ctx = 0
        if has_left and ctu_flags[comp][ctu_addr - 1]:
            ctx += 1
        if has_up and ctu_flags[comp][ctu_addr - w_ctus]:
            ctx += 1
        cset = ct.CTX_SETS["CtbAlfFlag"](comp * 3 + ctx)
        if encode:
            coder.encode_bin(1 if ctu_flags[comp][ctu_addr] else 0, cset)
        else:
            ctu_flags[comp][ctu_addr] = coder.decode_bin(cset)
        if comp == 0 and ctu_flags[0][ctu_addr]:
            _code_filter_idx(coder, encode, ctu_addr, num_aps,
                             ctu_filter_idx)
        if comp > 0 and ctu_flags[comp][ctu_addr]:
            # truncated unary alternative index
            cset = ct.CTX_SETS["CtbAlfAlternative"](comp - 1)
            if encode:
                ones = ctu_alt[comp - 1][ctu_addr]
                for _ in range(ones):
                    coder.encode_bin(1, cset)
                if ones < num_alts_chroma - 1:
                    coder.encode_bin(0, cset)
            else:
                ones = 0
                while ones < num_alts_chroma - 1 and coder.decode_bin(cset):
                    ones += 1
                ctu_alt[comp - 1][ctu_addr] = ones
    for cc in range(2):
        if not cc_enabled[cc]:
            continue
        ctx = 0
        if has_left and cc_control[cc][ctu_addr - 1]:
            ctx += 1
        if has_up and cc_control[cc][ctu_addr - w_ctus]:
            ctx += 1
        ctx += 3 if cc == 1 else 0
        cset = ct.CTX_SETS["CcAlfFilterControlFlag"](ctx)
        cnt = cc_filter_count[cc]
        if encode:
            idc = cc_control[cc][ctu_addr]
            coder.encode_bin(0 if idc == 0 else 1, cset)
            if idc > 0:
                for _ in range(idc - 1):
                    coder.encode_bin_ep(1)
                if idc < cnt:
                    coder.encode_bin_ep(0)
        else:
            idc = coder.decode_bin(cset)
            if idc:
                while idc < cnt and coder.decode_bin_ep():
                    idc += 1
            cc_control[cc][ctu_addr] = idc


def _code_filter_idx(coder, encode, ctu_addr, num_aps, ctu_filter_idx):
    from ..codec.ctu_syntax import write_trunc_bin, read_trunc_bin
    navail = num_aps + NUM_FIXED_FILTER_SETS
    if encode:
        idx = ctu_filter_idx[ctu_addr]
        if navail > NUM_FIXED_FILTER_SETS:
            use_aps = 1 if idx >= NUM_FIXED_FILTER_SETS else 0
            coder.encode_bin(use_aps, ct.CTX_SETS["AlfUseTemporalFilt"](0))
            if use_aps:
                if num_aps > 1:
                    write_trunc_bin(coder, idx - NUM_FIXED_FILTER_SETS,
                                    navail - NUM_FIXED_FILTER_SETS)
            else:
                write_trunc_bin(coder, idx, NUM_FIXED_FILTER_SETS)
        else:
            write_trunc_bin(coder, idx, NUM_FIXED_FILTER_SETS)
    else:
        if navail > NUM_FIXED_FILTER_SETS:
            if coder.decode_bin(ct.CTX_SETS["AlfUseTemporalFilt"](0)):
                idx = NUM_FIXED_FILTER_SETS
                if num_aps > 1:
                    idx += read_trunc_bin(coder,
                                          navail - NUM_FIXED_FILTER_SETS)
            else:
                idx = read_trunc_bin(coder, NUM_FIXED_FILTER_SETS)
        else:
            idx = read_trunc_bin(coder, NUM_FIXED_FILTER_SETS)
        ctu_filter_idx[ctu_addr] = idx


# ---------------------------------------------------------------------------
# picture-level application
# ---------------------------------------------------------------------------

def apply_alf_picture(rec, bit_depth, ctu_size, w_ctus, h_ctus,
                      aps_map, luma_aps_ids, chroma_aps_id,
                      alf_enabled, num_alts_chroma,
                      ctu_flags, ctu_filter_idx, ctu_alt,
                      cc_enabled, cc_aps_ids, cc_control):
    """Apply ALF + CC-ALF to a picture in place (rec: {0,1,2} planes).

    aps_map: {aps_id: AlfParam}."""
    h, w = rec[0].shape
    src = {c: rec[c].copy() for c in range(3)}  # pre-ALF (post-SAO)
    cls, trn = classify_luma(src[0], bit_depth, ctu_size)

    # pre-reconstruct available luma filter sets: 16 fixed + per-APS
    luma_sets = {}
    for i in range(NUM_FIXED_FILTER_SETS):
        luma_sets[i] = fixed_set_coeff(i, bit_depth)
    for k, aid in enumerate(luma_aps_ids):
        p = aps_map[aid]
        luma_sets[NUM_FIXED_FILTER_SETS + k] = \
            reconstruct_luma_coeff(p, bit_depth)
    chroma_sets = []
    if chroma_aps_id is not None and (alf_enabled[1] or alf_enabled[2]):
        p = aps_map[chroma_aps_id]
        for alt in range(p.num_alts_chroma):
            chroma_sets.append(reconstruct_chroma_coeff(p, alt, bit_depth))

    csz = ctu_size >> 1
    # pad each source plane once for all CTU region calls
    sp_y = np.pad(src[0], 3, mode="edge").astype(np.int64)
    sp_c = {c: np.pad(src[c], 2, mode="edge").astype(np.int64)
            for c in (1, 2) if alf_enabled[c]}
    for ry in range(h_ctus):
        for rx in range(w_ctus):
            addr = ry * w_ctus + rx
            x0, y0 = rx * ctu_size, ry * ctu_size
            if alf_enabled[0] and ctu_flags[0][addr]:
                coeff, clipv = luma_sets[ctu_filter_idx[addr]]
                filter_luma_region(src[0], rec[0], x0, y0, ctu_size,
                                   ctu_size, cls, trn, coeff, clipv,
                                   bit_depth, ctu_size, sp=sp_y)
            for comp in (1, 2):
                if alf_enabled[comp] and ctu_flags[comp][addr]:
                    coeff, clipv = chroma_sets[ctu_alt[comp - 1][addr]]
                    filter_chroma_region(src[comp], rec[comp], x0 >> 1,
                                         y0 >> 1, csz, csz, coeff, clipv,
                                         bit_depth, csz, sp=sp_c[comp])
    # CC-ALF runs on the SAO-filtered luma and adds to the ALF output
    for cc in range(2):
        if not cc_enabled[cc]:
            continue
        p = aps_map[cc_aps_ids[cc]]
        for ry in range(h_ctus):
            for rx in range(w_ctus):
                addr = ry * w_ctus + rx
                idc = cc_control[cc][addr]
                if not idc:
                    continue
                coeff = p.cc_coeff[cc][idc - 1]
                filter_ccalf_region(src[0], rec[cc + 1],
                                    (rx * ctu_size) >> 1,
                                    (ry * ctu_size) >> 1, csz, csz,
                                    coeff, bit_depth, ctu_size)

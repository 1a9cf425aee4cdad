"""Sample Adaptive Offset: CTU syntax parse/write + picture application.

H.266 7.3.11.3 (sao syntax) + 8.8.4 (application).  Behavioral reference:
vvenc EncoderLib/CABACWriter.cpp:237 (sao / sao_block_pars /
sao_offset_pars) and CommonLib/SampleAdaptiveOffset.cpp (invertQuantOffsets
:461, offset application).

Classification reads the pre-SAO (deblocked) picture; offsets write into
the output copy.  EO category mapping: edgeIdx' = {1,2,0,3,4}[2 + sign(c-n0)
+ sign(c-n1)], offsets for categories 3,4 are applied negated.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..bitstream import ctx_tables as ct

SAO_OFF, SAO_BO, SAO_EO = 0, 1, 2
NUM_BO_CLASSES = 32


@dataclass
class SaoCompParam:
    mode: int = SAO_OFF             # OFF / BO / EO
    eo_class: int = 0               # 0:hor 1:ver 2:135 3:45
    band_pos: int = 0
    offsets: List[int] = field(default_factory=lambda: [0, 0, 0, 0])


@dataclass
class SaoBlkParam:
    comps: List[SaoCompParam] = field(
        default_factory=lambda: [SaoCompParam(), SaoCompParam(),
                                 SaoCompParam()])


def _max_offset_qval(bit_depth: int) -> int:
    return (1 << (min(bit_depth, 10) - 5)) - 1


def _read_uvlc_trunc_ep(dec, cmax):
    v = 0
    while v < cmax and dec.decode_bin_ep():
        v += 1
    return v


def _write_uvlc_trunc_ep(enc, v, cmax):
    for i in range(v):
        enc.encode_bin_ep(1)
    if v < cmax:
        enc.encode_bin_ep(0)


def parse_sao_ctu(dec, sao_map, ctu_x, ctu_y, n_cols, slice_sao,
                  bit_depth: int, avail_left=None,
                  avail_up=None) -> SaoBlkParam:
    """Parse one CTU's SAO parameters (slice_sao = (luma_on, chroma_on)).
    avail_left/avail_up override merge availability at tile boundaries."""
    idx = ctu_y * n_cols + ctu_x
    left_avail = ctu_x > 0 if avail_left is None else avail_left
    above_avail = ctu_y > 0 if avail_up is None else avail_up
    if left_avail and dec.decode_bin(ct.CTX_SETS["SaoMergeFlag"](0)):
        return sao_map[idx - 1]
    if above_avail and dec.decode_bin(ct.CTX_SETS["SaoMergeFlag"](0)):
        return sao_map[idx - n_cols]
    blk = SaoBlkParam()
    enabled = (slice_sao[0], slice_sao[1], slice_sao[1])
    for comp in range(3):
        p = blk.comps[comp]
        if not enabled[comp]:
            continue
        first_of_ch = comp in (0, 1)
        if first_of_ch:
            if dec.decode_bin(ct.CTX_SETS["SaoTypeIdx"](0)):
                p.mode = SAO_EO if dec.decode_bin_ep() else SAO_BO
            else:
                p.mode = SAO_OFF
        else:
            p.mode = blk.comps[1].mode
            p.eo_class = blk.comps[1].eo_class
        if p.mode == SAO_OFF:
            continue
        cmax = _max_offset_qval(bit_depth)
        offs = [_read_uvlc_trunc_ep(dec, cmax) for _ in range(4)]
        if p.mode == SAO_BO:
            for i in range(4):
                if offs[i] and dec.decode_bin_ep():
                    offs[i] = -offs[i]
            p.band_pos = dec.decode_bins_ep(5)
        else:
            if first_of_ch:
                p.eo_class = dec.decode_bins_ep(2)
            else:
                p.eo_class = blk.comps[1].eo_class
        p.offsets = offs
    return blk


def write_sao_ctu(enc, blk: SaoBlkParam, sao_map, ctu_x, ctu_y, n_cols,
                  slice_sao, bit_depth: int, avail_left=None,
                  avail_up=None) -> None:
    """Encode one CTU's SAO parameters.

    Merge-left/up is signaled by object identity with the neighbor's params
    (mirror of parse_sao_ctu, which stores the identical object on merge).
    avail_left/avail_up override merge availability at tile boundaries."""
    idx = ctu_y * n_cols + ctu_x
    if (ctu_x > 0 if avail_left is None else avail_left):
        merge_left = blk is sao_map[idx - 1]
        enc.encode_bin(1 if merge_left else 0, ct.CTX_SETS["SaoMergeFlag"](0))
        if merge_left:
            return
    if (ctu_y > 0 if avail_up is None else avail_up):
        merge_up = blk is sao_map[idx - n_cols]
        enc.encode_bin(1 if merge_up else 0, ct.CTX_SETS["SaoMergeFlag"](0))
        if merge_up:
            return
    enabled = (slice_sao[0], slice_sao[1], slice_sao[1])
    for comp in range(3):
        p = blk.comps[comp]
        if not enabled[comp]:
            continue
        first_of_ch = comp in (0, 1)
        if first_of_ch:
            if p.mode == SAO_OFF:
                enc.encode_bin(0, ct.CTX_SETS["SaoTypeIdx"](0))
            else:
                enc.encode_bin(1, ct.CTX_SETS["SaoTypeIdx"](0))
                enc.encode_bin_ep(1 if p.mode == SAO_EO else 0)
        if p.mode == SAO_OFF:
            continue
        cmax = _max_offset_qval(bit_depth)
        for o in p.offsets:
            _write_uvlc_trunc_ep(enc, abs(o), cmax)
        if p.mode == SAO_BO:
            for o in p.offsets:
                if o:
                    enc.encode_bin_ep(1 if o < 0 else 0)
            enc.encode_bins_ep(p.band_pos, 5)
        else:
            if first_of_ch:
                enc.encode_bins_ep(p.eo_class, 2)


_EO_DIRS = {0: ((-1, 0), (1, 0)), 1: ((0, -1), (0, 1)),
            2: ((-1, -1), (1, 1)), 3: ((1, -1), (-1, 1))}
_EO_CAT_MAP = np.array([1, 2, 0, 3, 4], dtype=np.int32)


def apply_sao_picture(rec, sao_map, ctu_size: int, bit_depth: int,
                      n_cols: int, n_rows: int) -> None:
    """Apply SAO in place (classification from a pre-SAO copy)."""
    maxval = (1 << bit_depth) - 1
    src = {c: rec[c].copy() for c in range(3)}
    for ry in range(n_rows):
        for rx in range(n_cols):
            blk = sao_map[ry * n_cols + rx]
            if blk is None:
                continue
            for comp in range(3):
                p = blk.comps[comp]
                if p.mode == SAO_OFF:
                    continue
                sc = 1 if comp else 0
                cs_ = ctu_size >> sc
                x0, y0 = rx * cs_, ry * cs_
                plane = rec[comp]
                sp = src[comp]
                h, w = plane.shape
                x1, y1 = min(x0 + cs_, w), min(y0 + cs_, h)
                region = sp[y0:y1, x0:x1].astype(np.int32)
                if p.mode == SAO_BO:
                    band = region >> (bit_depth - 5)
                    off = np.zeros(NUM_BO_CLASSES, dtype=np.int32)
                    for i in range(4):
                        off[(p.band_pos + i) % NUM_BO_CLASSES] = p.offsets[i]
                    out = region + off[band]
                else:
                    (dx0, dy0), (dx1, dy1) = _EO_DIRS[p.eo_class]
                    # valid sample window: neighbors must be inside picture
                    vx0 = max(x0, -min(dx0, dx1, 0))
                    vy0 = max(y0, -min(dy0, dy1, 0))
                    vx1 = min(x1, w - max(dx0, dx1, 0))
                    vy1 = min(y1, h - max(dy0, dy1, 0))
                    out = region.copy()
                    if vx1 > vx0 and vy1 > vy0:
                        c = sp[vy0:vy1, vx0:vx1].astype(np.int32)
                        n0 = sp[vy0 + dy0:vy1 + dy0,
                                vx0 + dx0:vx1 + dx0].astype(np.int32)
                        n1 = sp[vy0 + dy1:vy1 + dy1,
                                vx0 + dx1:vx1 + dx1].astype(np.int32)
                        raw = 2 + np.sign(c - n0) + np.sign(c - n1)
                        cat = _EO_CAT_MAP[raw]
                        offv = np.zeros(5, dtype=np.int32)
                        offv[1] = p.offsets[0]
                        offv[2] = p.offsets[1]
                        offv[3] = -p.offsets[2]
                        offv[4] = -p.offsets[3]
                        out[vy0 - y0:vy1 - y0, vx0 - x0:vx1 - x0] = \
                            c + offv[cat]
                plane[y0:y1, x0:x1] = np.clip(out, 0, maxval)

"""Annex-B stream decoder for the round-1 feature set (all-intra, QT-only).

Pipeline: split_annexb -> parse SPS/PPS -> per VCL NAL parse slice header ->
CABAC-decode CTU coding trees (codec.ctu_syntax) -> reconstructed
planes.  Raises on any unsupported syntax instead of guessing.
"""

from __future__ import annotations

import numpy as np

from ..bitstream.bitwriter import BitReader
from ..bitstream.cabac import CabacDecoder
from ..bitstream.nal import split_annexb, NalUnitType, VCL_NAL_TYPES
from ..bitstream import hls
from ..codec.ctu_syntax import SyntaxCoder
from ..codec.picture import PictureState
from ..codec.qp import QpState
from ..bitstream.params import SLICE_I, SLICE_B


class DecodedFrame:
    def __init__(self, ps: PictureState, poc: int, sh, mf=None,
                 ref_pocs=None):
        self.planes = ps.rec
        self.ps = ps
        self.poc = poc
        self.slice_header = sh
        self.mf = mf                     # motion field (TMVP source)
        self.ref_pocs = ref_pocs or [[], []]


def decode_stream(data: bytes):
    """Decode an Annex-B byte stream -> list of DecodedFrame."""
    units = split_annexb(data)
    sps_map = {}
    pps_map = {}
    aps_map = {}   # ALF APS by id
    lmcs_aps_map = {}  # LMCS APS by id
    frames = []
    dpb = []  # (poc, {comp: plane}) decoded pictures in output order
    for nal_type, tid, rbsp in units:
        if nal_type == NalUnitType.SPS:
            s = hls.parse_sps(BitReader(rbsp))
            sps_map[s.sps_id] = s
        elif nal_type == NalUnitType.PPS:
            # PPS parse needs its SPS; vvenc emits SPS before PPS
            br = BitReader(rbsp)
            # peek sps id: pps_id(6) then sps_id(4)
            peek = BitReader(rbsp)
            peek.read(6)
            sps = sps_map[peek.read(4)]
            p = hls.parse_pps(br, sps)
            pps_map[p.pps_id] = p
        elif nal_type in (NalUnitType.PREFIX_APS, NalUnitType.SUFFIX_APS):
            from ..codec.alf import read_aps, ALF_APS, LMCS_APS
            aps_type, aps_id, aps_p = read_aps(BitReader(rbsp))
            if aps_type == ALF_APS:
                aps_map[aps_id] = aps_p
            elif aps_type == LMCS_APS:
                lmcs_aps_map[aps_id] = aps_p
        elif nal_type in (NalUnitType.PREFIX_SEI, NalUnitType.SUFFIX_SEI):
            from ..bitstream.sei import (parse_sei_rbsp, compute_picture_hash,
                                         SeiDecodedPictureHash,
                                         SEI_DECODED_PICTURE_HASH)
            for ptype, payload in parse_sei_rbsp(rbsp):
                if ptype == SEI_DECODED_PICTURE_HASH and frames:
                    sei = SeiDecodedPictureHash.parse(payload)
                    got = compute_picture_hash(
                        frames[-1].planes, frames[-1].ps.bit_depth,
                        sei.method)
                    assert got == sei.digests, \
                        "decoded picture hash SEI mismatch"
        elif nal_type in VCL_NAL_TYPES:
            if nal_type in (NalUnitType.IDR_N_LP, NalUnitType.IDR_W_RADL,
                            NalUnitType.CRA):
                dpb.clear()
            frame = _decode_slice(rbsp, nal_type, sps_map, pps_map, aps_map,
                                  dpb, lmcs_aps_map)
            dpb.append((frame.poc, frame.planes, frame.mf, frame.ref_pocs))
            frames.append(frame)
        elif nal_type in (NalUnitType.PREFIX_SEI, NalUnitType.SUFFIX_SEI,
                          NalUnitType.AUD, NalUnitType.EOS, NalUnitType.EOB,
                          NalUnitType.VPS, NalUnitType.DCI, NalUnitType.OPI,
                          NalUnitType.FD):
            continue
        else:
            raise NotImplementedError(f"NAL type {nal_type}")
    return frames


def _decode_slice(rbsp: bytes, nal_type, sps_map, pps_map, aps_map,
                  dpb=None, lmcs_aps_map=None) -> DecodedFrame:
    br = BitReader(rbsp)
    is_idr = nal_type in (NalUnitType.IDR_N_LP, NalUnitType.IDR_W_RADL)
    # slice header needs pps id first; with PH-in-SH the pps id comes after a
    # few flags — parse with the single known PPS/SPS (round 1: one of each)
    assert len(pps_map) == 1 and len(sps_map) == 1, "multi-PS streams TBD"
    pps = next(iter(pps_map.values()))
    sps = next(iter(sps_map.values()))
    sh = hls.parse_slice_header(br, sps, pps, is_idr)

    ps = PictureState(pps.pic_width, pps.pic_height, sps.bit_depth)
    qp = QpState(sps, pps, sh.slice_qp, sh=sh)

    ref_pics = [[], []]
    ref_pocs = [[], []]
    tmvp = None
    cur_poc = sh.ph.poc_lsb
    if sh.slice_type != SLICE_I:
        by_poc = {e[0]: e for e in (dpb or [])}
        for li in range(1 if sh.slice_type == 1 else 2):
            for delta in sh.rpls[li].delta_pocs[:max(1, sh.num_ref_idx[li])]:
                ref_poc = cur_poc + delta  # negative identifier = past pic
                assert ref_poc in by_poc, (ref_poc, sorted(by_poc))
                ref_pics[li].append(by_poc[ref_poc][1])
                ref_pocs[li].append(ref_poc)
        if sh.ph.enable_tmvp:
            from ..codec.motion import TmvpCtx
            is_b = sh.slice_type == SLICE_B
            pic_list = (1 - sh.col_from_l0) if is_b else 0
            col_poc = ref_pocs[pic_list][sh.col_ref_idx]
            col = by_poc[col_poc]
            check_ldc = all(p <= cur_poc
                            for li in range(2) for p in ref_pocs[li])
            if col[2] is not None:
                tmvp = TmvpCtx(col[2], col[3], col_poc, cur_poc, ref_pocs,
                               sh.col_from_l0 if is_b else 1, check_ldc,
                               pps.pic_width, pps.pic_height, sps.ctu_size)
    reshape = None
    if getattr(sh, "lmcs_enabled", 0):
        from ..codec.lmcs import ReshapeState
        reshape = ReshapeState(lmcs_aps_map[sh.ph.lmcs_aps_id],
                               sps.bit_depth)
    coder = SyntaxCoder(sps, pps, sh, qp, ref_pics, ref_pocs, tmvp=tmvp,
                        cur_poc=cur_poc, reshape=reshape)
    coder.attach_motion(ps)

    init_id = 2 if sh.slice_type == SLICE_I else sh.slice_type
    if pps.cabac_init_present and sh.cabac_init_flag and init_id != 2:
        init_id = 1 - init_id  # swap B <-> P tables

    ctu = sps.ctu_size
    w_ctus = (pps.pic_width + ctu - 1) // ctu
    h_ctus = (pps.pic_height + ctu - 1) // ctu

    tiles = None
    if not pps.no_pic_partition:
        cols, rows = hls.tile_grid(pps, sps)
        if len(cols) * len(rows) > 1:
            # tile raster scan: per-tile CTU ranges + pixel boundaries
            cs = np.cumsum([0] + cols)
            rs = np.cumsum([0] + rows)
            tiles = [(int(cs[i]), int(cs[i + 1]), int(rs[j]),
                      int(rs[j + 1]))
                     for j in range(len(rows)) for i in range(len(cols))]
            ps.set_tiles([int(c) * ctu for c in cs[:-1]],
                         [int(r) * ctu for r in rs[:-1]])

    def _substreams(n):
        data = rbsp[br.pos_bits // 8:]
        starts = [0]
        for off in sh.entry_point_offsets:
            starts.append(starts[-1] + off)
        subs = [data[starts[i]:(starts[i + 1] if i + 1 < len(starts)
                                else len(data))]
                for i in range(len(starts))]
        assert len(subs) == n, (len(subs), n)
        return subs

    wpp = bool(sps.entropy_coding_sync)
    if wpp:
        # per-CTU-row substreams (entry points)
        subs = _substreams(h_ctus)
        dec = CabacDecoder(BitReader(subs[0]))
        dec.init_ctx(sh.slice_qp, init_id)
    elif tiles is not None:
        subs = _substreams(len(tiles))
        dec = CabacDecoder(BitReader(subs[0]))
        dec.init_ctx(sh.slice_qp, init_id)
    else:
        dec = CabacDecoder(br)
        dec.init_ctx(sh.slice_qp, init_id)
    sao_on = bool(sps.sao_enabled and (sh.sao_luma or sh.sao_chroma))
    sao_map = [None] * (w_ctus * h_ctus)
    n_ctus = w_ctus * h_ctus
    alf_on = any(sh.alf_enabled) or any(sh.cc_alf_enabled)
    if alf_on:
        from ..codec.alf import code_alf_ctu
        alf_flags = np.zeros((3, n_ctus), np.int32)
        alf_fidx = np.zeros(n_ctus, np.int32)
        alf_alt = np.zeros((2, n_ctus), np.int32)
        cc_ctrl = np.zeros((2, n_ctus), np.int32)
        num_alts = aps_map[sh.chroma_aps_id].num_alts_chroma \
            if (sh.alf_enabled[1] or sh.alf_enabled[2]) else 1
        cc_counts = [aps_map[sh.cc_alf_aps_ids[i]].cc_filter_count[i]
                     if sh.cc_alf_enabled[i] else 0 for i in range(2)]
    trees = [None] * (w_ctus * h_ctus)
    sync_ctx = None
    from ..bitstream.cabac import CtxModels
    if tiles is not None:
        # tile raster scan; fresh context init per tile
        for ti, (tx0, tx1, ty0, ty1) in enumerate(tiles):
            if ti > 0:
                assert dec.decode_bin_trm() == 1, "end_of_tile bin"
                dec = CabacDecoder(BitReader(subs[ti]))
                dec.init_ctx(sh.slice_qp, init_id)
            ps.cur_tile = ti
            for cy in range(ty0, ty1):
                coder.new_ctu_row()
                for cx in range(tx0, tx1):
                    if sao_on:
                        from ..codec.sao import parse_sao_ctu
                        sao_map[cy * w_ctus + cx] = parse_sao_ctu(
                            dec, sao_map, cx, cy, w_ctus,
                            (sh.sao_luma, sh.sao_chroma), sps.bit_depth,
                            avail_left=cx > tx0, avail_up=cy > ty0)
                    if alf_on:
                        code_alf_ctu(dec, False, cy * w_ctus + cx, w_ctus,
                                     sh.alf_enabled, sh.num_alf_aps,
                                     num_alts, alf_flags, alf_fidx,
                                     alf_alt, sh.cc_alf_enabled, cc_counts,
                                     cc_ctrl, avail_left=cx > tx0,
                                     avail_up=cy > ty0)
                    trees[cy * w_ctus + cx] = coder.decode_ctu(
                        dec, ps, cx * ctu, cy * ctu)
    else:
        for cy in range(h_ctus):
            if wpp and cy > 0:
                # close the previous substream, open the next with the ctx
                # state synced from after the first CTU of the row above
                assert dec.decode_bin_trm() == 1, "end_of_subset bin"
                dec = CabacDecoder(BitReader(subs[cy]),
                                   ctx=CtxModels(sync_ctx))
                dec.start()
            coder.new_ctu_row()
            for cx in range(w_ctus):
                if sao_on:
                    from ..codec.sao import parse_sao_ctu
                    sao_map[cy * w_ctus + cx] = parse_sao_ctu(
                        dec, sao_map, cx, cy, w_ctus,
                        (sh.sao_luma, sh.sao_chroma), sps.bit_depth)
                if alf_on:
                    code_alf_ctu(dec, False, cy * w_ctus + cx, w_ctus,
                                 sh.alf_enabled, sh.num_alf_aps, num_alts,
                                 alf_flags, alf_fidx, alf_alt,
                                 sh.cc_alf_enabled, cc_counts, cc_ctrl)
                trees[cy * w_ctus + cx] = coder.decode_ctu(
                    dec, ps, cx * ctu, cy * ctu)
                if wpp and cx == 0:
                    sync_ctx = CtxModels(dec.ctx)
    term = dec.decode_bin_trm()
    assert term == 1, "expected end_of_slice terminating bin"

    # DMVR: the stored motion field (TMVP source for later pictures)
    # carries the refined MVs (vvenc setRefinedMotionFieldCTU)
    from ..codec.motion import refine_mf_with_dmvr
    refine_mf_with_dmvr(coder.mf, trees)

    if reshape is not None:
        # inverse luma mapping before the in-loop filters
        # (EncSlice.cpp:1016 reco.rspSignal(invLUT))
        ps.rec[0] = reshape.inv_map(ps.rec[0]).astype(ps.rec[0].dtype)

    if not pps.deblocking_filter_disabled:
        from ..codec.deblock import deblock_picture
        cus = []

        def collect(node):
            if node.cu is not None:
                cus.append(node.cu)
            for c in node.children:
                collect(c)
            if node.chroma_cu is not None:
                cus.append(node.chroma_cu)
        for t in trees:
            collect(t)
        deblock_picture(ps.rec, cus, sh.slice_qp,
                        qp.chroma_qp(1) - qp.qp_bd_offset,
                        qp.chroma_qp(2) - qp.qp_bd_offset,
                        sps.ctu_size, sps.bit_depth,
                        ref_pocs=ref_pocs, is_b=(sh.slice_type == SLICE_B),
                        qp_map=ps.qp_map,
                        chroma_qp_fn=qp.chroma_deblock_qp)
    if sao_on:
        from ..codec.sao import apply_sao_picture
        apply_sao_picture(ps.rec, sao_map, sps.ctu_size, sps.bit_depth,
                          w_ctus, h_ctus)
    if alf_on:
        from ..codec.alf import apply_alf_picture
        apply_alf_picture(ps.rec, sps.bit_depth, sps.ctu_size, w_ctus,
                          h_ctus, aps_map, sh.luma_aps_ids,
                          sh.chroma_aps_id
                          if (sh.alf_enabled[1] or sh.alf_enabled[2])
                          else None,
                          sh.alf_enabled, num_alts,
                          alf_flags, alf_fidx, alf_alt,
                          sh.cc_alf_enabled, sh.cc_alf_aps_ids, cc_ctrl)
    return DecodedFrame(ps, sh.ph.poc_lsb, sh, mf=coder.mf,
                        ref_pocs=ref_pocs)

"""High-level syntax (HLS) writers and parsers: SPS, PPS, PH, slice header.

Syntax order follows ITU-T H.266 sections 7.3.2 / 7.3.7; behavioral reference
vvenc EncoderLib/VLCWriter.cpp:708 (codeSPS), :253 (codePPS), :1307
(codePictureHeader), :1700 (codeSliceHeader).  Parsers mirror writers
one-to-one; unsupported feature branches raise so silent desync is impossible.

The writer/parser pair is validated by parse -> re-serialize -> byte-compare
against streams produced by the reference encoder (tests/test_hls.py).
"""

from __future__ import annotations

from .bitwriter import BitWriter, BitReader
from .params import (SPS, PPS, PictureHeader, SliceHeader, ProfileTierLevel,
                     RefPicList, GeneralHrd, OlsHrd, SLICE_I)


def _ceil_log2(x: int) -> int:
    return max(0, (x - 1).bit_length())


# ---------------------------------------------------------------------------
# profile / tier / level
# ---------------------------------------------------------------------------

def write_ptl(bw: BitWriter, ptl: ProfileTierLevel, profile_present: bool,
              max_sublayers_minus1: int) -> None:
    if profile_present:
        bw.write(ptl.profile_idc, 7)
        bw.write_flag(ptl.tier_flag)
    bw.write(ptl.level_idc, 8)
    bw.write_flag(ptl.frame_only_constraint)
    bw.write_flag(ptl.multilayer_enabled)
    if profile_present:
        bw.write_flag(0)  # gci_present_flag
        # byte align after constraint info
        while not bw.is_byte_aligned():
            bw.write_flag(0)
    for i in range(max_sublayers_minus1 - 1, -1, -1):
        bw.write_flag(ptl.sub_layer_level_present[i]
                      if i < len(ptl.sub_layer_level_present) else 0)
    while not bw.is_byte_aligned():
        bw.write_flag(0)
    for i in range(max_sublayers_minus1 - 1, -1, -1):
        if i < len(ptl.sub_layer_level_present) and ptl.sub_layer_level_present[i]:
            bw.write(ptl.sub_layer_level_idc[i], 8)
    if profile_present:
        bw.write(ptl.num_sub_profile, 8)
        assert ptl.num_sub_profile == 0


def parse_ptl(br: BitReader, profile_present: bool,
              max_sublayers_minus1: int) -> ProfileTierLevel:
    ptl = ProfileTierLevel()
    if profile_present:
        ptl.profile_idc = br.read(7)
        ptl.tier_flag = br.read_flag()
    ptl.level_idc = br.read(8)
    ptl.frame_only_constraint = br.read_flag()
    ptl.multilayer_enabled = br.read_flag()
    if profile_present:
        gci_present = br.read_flag()
        assert gci_present == 0, "general constraint info parsing unsupported"
        br.byte_align()
    ptl.sub_layer_level_present = [0] * max_sublayers_minus1
    for i in range(max_sublayers_minus1 - 1, -1, -1):
        ptl.sub_layer_level_present[i] = br.read_flag()
    br.byte_align()
    ptl.sub_layer_level_idc = [0] * max_sublayers_minus1
    for i in range(max_sublayers_minus1 - 1, -1, -1):
        if ptl.sub_layer_level_present[i]:
            ptl.sub_layer_level_idc[i] = br.read(8)
    if profile_present:
        ptl.num_sub_profile = br.read(8)
        assert ptl.num_sub_profile == 0
    return ptl


# ---------------------------------------------------------------------------
# ref_pic_list_struct
# ---------------------------------------------------------------------------

def write_rpl(bw: BitWriter, rpl: RefPicList, lt_present: bool,
              poc_lsb_bits: int, forbid_zero_delta: bool, rpl_idx: int) -> None:
    n = rpl.num_refs
    bw.write_uvlc(n)
    if lt_present and n > 0 and rpl_idx != -1:
        bw.write_flag(rpl.ltrp_in_slice_header)
    assert rpl.num_long_term == 0, "long-term refs unsupported"
    prev = 0
    for ii in range(n):
        ident = rpl.delta_pocs[ii]
        if lt_present:
            bw.write_flag(1)  # st_ref_pic_flag
        delta = ident if ii == 0 else ident - prev
        prev = ident
        abs_delta = abs(delta)
        if forbid_zero_delta or ii == 0:
            assert abs_delta > 0
            bw.write_uvlc(abs_delta - 1)
        else:
            bw.write_uvlc(abs_delta)
        if abs_delta > 0:
            bw.write_flag(delta < 0)


def parse_rpl(br: BitReader, lt_present: bool, poc_lsb_bits: int,
              forbid_zero_delta: bool, rpl_idx: int) -> RefPicList:
    rpl = RefPicList()
    n = br.read_uvlc()
    if lt_present and n > 0 and rpl_idx != -1:
        rpl.ltrp_in_slice_header = br.read_flag()
    prev = 0
    for ii in range(n):
        st = br.read_flag() if lt_present else 1
        assert st == 1, "long-term refs unsupported"
        if forbid_zero_delta or ii == 0:
            abs_delta = br.read_uvlc() + 1
        else:
            abs_delta = br.read_uvlc()
        sign_neg = br.read_flag() if abs_delta > 0 else 0
        delta = -abs_delta if sign_neg else abs_delta
        ident = delta if ii == 0 else prev + delta
        prev = ident
        rpl.delta_pocs.append(ident)
    rpl.num_short_term = n
    return rpl


# ---------------------------------------------------------------------------
# HRD (H.266 7.3.5: general_timing_hrd_parameters / ols_timing_hrd_parameters)
# ---------------------------------------------------------------------------

def write_general_hrd(bw: BitWriter, h: GeneralHrd) -> None:
    bw.write(h.num_units_in_tick, 32)
    bw.write(h.time_scale, 32)
    bw.write_flag(h.nal_hrd_present)
    bw.write_flag(h.vcl_hrd_present)
    if h.nal_hrd_present or h.vcl_hrd_present:
        bw.write_flag(h.same_pic_timing_in_all_ols)
        bw.write_flag(h.du_hrd_present)
        assert not h.du_hrd_present
        bw.write(h.bit_rate_scale, 4)
        bw.write(h.cpb_size_scale, 4)
        bw.write_uvlc(h.cpb_cnt_minus1)


def parse_general_hrd(br: BitReader) -> GeneralHrd:
    h = GeneralHrd()
    h.num_units_in_tick = br.read(32)
    h.time_scale = br.read(32)
    h.nal_hrd_present = br.read_flag()
    h.vcl_hrd_present = br.read_flag()
    if h.nal_hrd_present or h.vcl_hrd_present:
        h.same_pic_timing_in_all_ols = br.read_flag()
        h.du_hrd_present = br.read_flag()
        assert not h.du_hrd_present, "DU HRD unsupported"
        h.bit_rate_scale = br.read(4)
        h.cpb_size_scale = br.read(4)
        h.cpb_cnt_minus1 = br.read_uvlc()
    return h


def write_ols_hrd(bw: BitWriter, gh: GeneralHrd, ols: list,
                  first_sublayer: int, max_sublayers_minus1: int) -> None:
    for i in range(first_sublayer, max_sublayers_minus1 + 1):
        o = ols[i]
        bw.write_flag(o.fixed_pic_rate_general)
        if not o.fixed_pic_rate_general:
            bw.write_flag(o.fixed_pic_rate_within_cvs)
        if o.fixed_pic_rate_within_cvs:
            bw.write_uvlc(o.element_duration_in_tc_minus1)
        elif (gh.nal_hrd_present or gh.vcl_hrd_present) and gh.cpb_cnt_minus1 == 0:
            bw.write_flag(o.low_delay_hrd)
        for nal_or_vcl in range(2):
            if (nal_or_vcl == 0 and gh.nal_hrd_present) or \
                    (nal_or_vcl == 1 and gh.vcl_hrd_present):
                for j in range(gh.cpb_cnt_minus1 + 1):
                    br_m1, cpb_m1, cbr = o.cpb_entries[j][nal_or_vcl]
                    bw.write_uvlc(br_m1)
                    bw.write_uvlc(cpb_m1)
                    bw.write_flag(cbr)


def parse_ols_hrd(br: BitReader, gh: GeneralHrd, first_sublayer: int,
                  max_sublayers_minus1: int) -> list:
    out = [OlsHrd() for _ in range(max_sublayers_minus1 + 1)]
    for i in range(first_sublayer, max_sublayers_minus1 + 1):
        o = out[i]
        o.fixed_pic_rate_general = br.read_flag()
        o.fixed_pic_rate_within_cvs = o.fixed_pic_rate_general
        if not o.fixed_pic_rate_general:
            o.fixed_pic_rate_within_cvs = br.read_flag()
        if o.fixed_pic_rate_within_cvs:
            o.element_duration_in_tc_minus1 = br.read_uvlc()
        elif (gh.nal_hrd_present or gh.vcl_hrd_present) and gh.cpb_cnt_minus1 == 0:
            o.low_delay_hrd = br.read_flag()
        o.cpb_entries = [[None, None] for _ in range(gh.cpb_cnt_minus1 + 1)]
        for nal_or_vcl in range(2):
            if (nal_or_vcl == 0 and gh.nal_hrd_present) or \
                    (nal_or_vcl == 1 and gh.vcl_hrd_present):
                for j in range(gh.cpb_cnt_minus1 + 1):
                    o.cpb_entries[j][nal_or_vcl] = (
                        br.read_uvlc(), br.read_uvlc(), br.read_flag())
    return out


# ---------------------------------------------------------------------------
# SPS
# ---------------------------------------------------------------------------

def write_sps(bw: BitWriter, s: SPS) -> None:
    bw.write(s.sps_id, 4)
    bw.write(s.vps_id, 4)
    bw.write(s.max_tlayers - 1, 3)
    bw.write(s.chroma_format_idc, 2)
    bw.write(s.ctu_size_log2 - 5, 2)
    bw.write_flag(s.ptl_dpb_hrd_params_present)
    if s.ptl_dpb_hrd_params_present:
        write_ptl(bw, s.ptl, True, s.max_tlayers - 1)
    bw.write_flag(s.gdr_enabled)
    bw.write_flag(s.rpr_enabled)
    if s.rpr_enabled:
        bw.write_flag(s.res_change_in_clvs)
    bw.write_uvlc(s.max_width)
    bw.write_uvlc(s.max_height)
    conf_enabled = any(s.conf_win)
    bw.write_flag(conf_enabled)
    if conf_enabled:
        sx = 2 if s.chroma_format_idc in (1, 2) else 1
        sy = 2 if s.chroma_format_idc == 1 else 1
        for off, sc in zip(s.conf_win, (sx, sx, sy, sy)):
            bw.write_uvlc(off // sc)
    bw.write_flag(0)  # sps_subpic_info_present_flag
    bw.write_uvlc(s.bit_depth - 8)
    bw.write_flag(s.entropy_coding_sync)
    bw.write_flag(s.entry_points_present)
    bw.write(s.log2_max_poc_lsb - 4, 4)
    bw.write_flag(s.poc_msb_flag)
    if s.poc_msb_flag:
        bw.write_uvlc(s.poc_msb_len - 1)
    bw.write(0, 2)  # sps_num_extra_ph_bits_bytes
    bw.write(0, 2)  # sps_num_extra_sh_bits_bytes
    if s.ptl_dpb_hrd_params_present:
        if s.max_tlayers > 1:
            bw.write_flag(s.sublayer_dpb_params)
        rng = range(0 if s.sublayer_dpb_params else s.max_tlayers - 1,
                    s.max_tlayers)
        for i in rng:
            bw.write_uvlc(s.max_dec_pic_buffering[i] - 1)
            bw.write_uvlc(s.num_reorder_pics[i])
            bw.write_uvlc(s.max_latency_increase[i])
    bw.write_uvlc(s.log2_min_cb_size - 2)
    bw.write_flag(s.partition_override)
    log2_min_qt = {}
    for idx in (0, 2, 1):
        log2_min_qt[idx] = _ceil_log2(s.min_qt_size[idx])
    bw.write_uvlc(log2_min_qt[0] - s.log2_min_cb_size)
    bw.write_uvlc(s.max_mtt_depth[0])
    if s.max_mtt_depth[0] != 0:
        bw.write_uvlc(_ceil_log2(s.max_bt_size[0]) - log2_min_qt[0])
        bw.write_uvlc(_ceil_log2(s.max_tt_size[0]) - log2_min_qt[0])
    if s.chroma_format_idc != 0:
        bw.write_flag(s.dual_i_tree)
    if s.dual_i_tree:
        bw.write_uvlc(log2_min_qt[2] - s.log2_min_cb_size)
        bw.write_uvlc(s.max_mtt_depth[2])
        if s.max_mtt_depth[2] != 0:
            bw.write_uvlc(_ceil_log2(s.max_bt_size[2]) - log2_min_qt[2])
            bw.write_uvlc(_ceil_log2(s.max_tt_size[2]) - log2_min_qt[2])
    bw.write_uvlc(log2_min_qt[1] - s.log2_min_cb_size)
    bw.write_uvlc(s.max_mtt_depth[1])
    if s.max_mtt_depth[1] != 0:
        bw.write_uvlc(_ceil_log2(s.max_bt_size[1]) - log2_min_qt[1])
        bw.write_uvlc(_ceil_log2(s.max_tt_size[1]) - log2_min_qt[1])
    if s.ctu_size > 32:
        bw.write_flag(s.log2_max_tb_size - 5)
    bw.write_flag(s.transform_skip)
    if s.transform_skip:
        bw.write_uvlc(s.log2_max_ts_size - 2)
        bw.write_flag(s.bdpcm)
    bw.write_flag(s.mts)
    if s.mts:
        bw.write_flag(s.mts_intra)
        bw.write_flag(s.mts_inter)
    bw.write_flag(s.lfnst)
    if s.chroma_format_idc != 0:
        bw.write_flag(s.joint_cbcr)
        bw.write_flag(s.same_qp_table_for_chroma)
        num_tables = 1 if s.same_qp_table_for_chroma else (3 if s.joint_cbcr else 2)
        assert len(s.chroma_qp_tables) == num_tables
        for start_m26, in_deltas_m1, out_deltas in s.chroma_qp_tables:
            bw.write_svlc(start_m26)
            bw.write_uvlc(len(in_deltas_m1) - 1)
            for dj_in, dj_out in zip(in_deltas_m1, out_deltas):
                bw.write_uvlc(dj_in)
                bw.write_uvlc(dj_out ^ dj_in)
    bw.write_flag(s.sao_enabled)
    bw.write_flag(s.alf_enabled)
    if s.alf_enabled and s.chroma_format_idc != 0:
        bw.write_flag(s.ccalf_enabled)
    bw.write_flag(s.lmcs_enabled)
    bw.write_flag(s.weighted_pred)
    bw.write_flag(s.weighted_bipred)
    bw.write_flag(s.long_term_refs)
    if s.vps_id > 0:
        raise NotImplementedError("multilayer")
    bw.write_flag(s.idr_rpl_present)
    bw.write_flag(s.rpl1_copy_from_rpl0)
    forbid_zero = not s.weighted_pred and not s.weighted_bipred
    bw.write_uvlc(s.num_rpl(0))
    for i, rpl in enumerate(s.rpl_lists[0]):
        write_rpl(bw, rpl, s.long_term_refs, s.log2_max_poc_lsb, forbid_zero, i)
    if not s.rpl1_copy_from_rpl0:
        bw.write_uvlc(s.num_rpl(1))
        for i, rpl in enumerate(s.rpl_lists[1]):
            write_rpl(bw, rpl, s.long_term_refs, s.log2_max_poc_lsb, forbid_zero, i)
    bw.write_flag(s.wraparound)
    bw.write_flag(s.temporal_mvp)
    if s.temporal_mvp:
        bw.write_flag(s.sbtmvp)
    bw.write_flag(s.amvr)
    bw.write_flag(s.bdof)
    if s.bdof:
        bw.write_flag(s.bdof_present)
    bw.write_flag(s.smvd)
    bw.write_flag(s.dmvr)
    if s.dmvr:
        bw.write_flag(s.dmvr_present)
    bw.write_flag(s.mmvd)
    if s.mmvd:
        bw.write_flag(s.fpel_mmvd)
    bw.write_uvlc(6 - s.max_num_merge_cand)
    bw.write_flag(s.sbt)
    bw.write_flag(s.affine)
    if s.affine:
        bw.write_uvlc(5 - s.max_num_affine_merge_cand)
        bw.write_flag(s.affine_type)
        if s.amvr:
            bw.write_flag(s.affine_amvr)
        bw.write_flag(s.prof)
        if s.prof:
            bw.write_flag(s.prof_present)
    bw.write_flag(s.bcw)
    bw.write_flag(s.ciip)
    if s.max_num_merge_cand >= 2:
        bw.write_flag(s.geo)
        if s.geo and s.max_num_merge_cand >= 3:
            bw.write_uvlc(s.max_num_merge_cand - s.max_num_geo_cand)
    bw.write_uvlc(s.log2_parallel_merge_minus2)
    bw.write_flag(s.isp)
    bw.write_flag(s.mrl)
    bw.write_flag(s.mip)
    if s.chroma_format_idc != 0:
        bw.write_flag(s.cclm)
    if s.chroma_format_idc == 1:
        bw.write_flag(s.hor_collocated_chroma)
        bw.write_flag(s.ver_collocated_chroma)
    bw.write_flag(s.plt)
    if s.chroma_format_idc == 3:
        raise NotImplementedError("4:4:4")
    if s.transform_skip or s.plt:
        bw.write_uvlc(s.internal_minus_input_bit_depth)
    bw.write_flag(s.ibc)
    if s.ibc:
        bw.write_uvlc(6 - s.max_num_ibc_merge_cand)
    bw.write_flag(s.ladf)
    bw.write_flag(s.scaling_list_enabled)
    if s.lfnst and s.scaling_list_enabled:
        raise NotImplementedError("scaling lists")
    bw.write_flag(s.dep_quant_enabled)
    bw.write_flag(s.sign_data_hiding)
    bw.write_flag(s.virtual_boundaries)
    assert not s.virtual_boundaries
    if s.ptl_dpb_hrd_params_present:
        bw.write_flag(s.timing_hrd_present)
        if s.timing_hrd_present:
            write_general_hrd(bw, s.general_hrd)
            if s.max_tlayers - 1 > 0:
                bw.write_flag(s.sublayer_cpb_params)
            first = 0 if s.sublayer_cpb_params else s.max_tlayers - 1
            write_ols_hrd(bw, s.general_hrd, s.ols_hrd, first, s.max_tlayers - 1)
    bw.write_flag(s.field_seq)
    bw.write_flag(s.vui_present)
    if s.vui_present:
        # payload is byte-counted: build it standalone first
        # (vvenc VLCWriter.cpp:1035-1053)
        vb = BitWriter()
        write_vui(vb, s.vui)
        payload = vb.get_bytes()
        bw.write_uvlc(len(payload) - 1)   # sps_vui_payload_size_minus1
        while not bw.is_byte_aligned():
            bw.write_flag(0)              # sps_vui_alignment_zero_bit
        bw.append_bytes(payload)
    bw.write_flag(0)  # sps_extension_present_flag
    bw.write_rbsp_trailing_bits()


def write_vui(bw: BitWriter, v) -> None:
    """vui_payload (H.266 7.3.4.2; vvenc HLSWriter::codeVUI:576)."""
    bw.write_flag(v.progressive_source)
    bw.write_flag(v.interlaced_source)
    bw.write_flag(v.non_packed)
    bw.write_flag(v.non_projected)
    bw.write_flag(v.aspect_ratio_info_present)
    if v.aspect_ratio_info_present:
        bw.write_flag(v.aspect_ratio_constant)
        bw.write(v.aspect_ratio_idc, 8)
        if v.aspect_ratio_idc == 255:
            bw.write(v.sar_width, 16)
            bw.write(v.sar_height, 16)
    bw.write_flag(v.overscan_info_present)
    if v.overscan_info_present:
        bw.write_flag(v.overscan_appropriate)
    bw.write_flag(v.colour_description_present)
    if v.colour_description_present:
        bw.write(v.colour_primaries, 8)
        bw.write(v.transfer_characteristics, 8)
        bw.write(v.matrix_coefficients, 8)
        bw.write_flag(v.video_full_range)
    bw.write_flag(v.chroma_loc_info_present)
    if v.chroma_loc_info_present:
        if v.progressive_source and not v.interlaced_source:
            bw.write_uvlc(v.chroma_sample_loc_type)
        else:
            bw.write_uvlc(v.chroma_sample_loc_type_top)
            bw.write_uvlc(v.chroma_sample_loc_type_bottom)
    if not bw.is_byte_aligned():
        bw.write_flag(1)                  # vui_payload_bit_equal_to_one
        bw.align_zero()


def parse_vui(br: BitReader, payload_size: int):
    from .params import VUI
    v = VUI()
    v.progressive_source = br.read_flag()
    v.interlaced_source = br.read_flag()
    v.non_packed = br.read_flag()
    v.non_projected = br.read_flag()
    v.aspect_ratio_info_present = br.read_flag()
    if v.aspect_ratio_info_present:
        v.aspect_ratio_constant = br.read_flag()
        v.aspect_ratio_idc = br.read(8)
        if v.aspect_ratio_idc == 255:
            v.sar_width = br.read(16)
            v.sar_height = br.read(16)
    v.overscan_info_present = br.read_flag()
    if v.overscan_info_present:
        v.overscan_appropriate = br.read_flag()
    v.colour_description_present = br.read_flag()
    if v.colour_description_present:
        v.colour_primaries = br.read(8)
        v.transfer_characteristics = br.read(8)
        v.matrix_coefficients = br.read(8)
        v.video_full_range = br.read_flag()
    v.chroma_loc_info_present = br.read_flag()
    if v.chroma_loc_info_present:
        if v.progressive_source and not v.interlaced_source:
            v.chroma_sample_loc_type = br.read_uvlc()
        else:
            v.chroma_sample_loc_type_top = br.read_uvlc()
            v.chroma_sample_loc_type_bottom = br.read_uvlc()
    return v


def parse_sps(br: BitReader) -> SPS:
    s = SPS()
    s.sps_id = br.read(4)
    s.vps_id = br.read(4)
    s.max_tlayers = br.read(3) + 1
    s.chroma_format_idc = br.read(2)
    s.ctu_size_log2 = br.read(2) + 5
    s.ptl_dpb_hrd_params_present = br.read_flag()
    if s.ptl_dpb_hrd_params_present:
        s.ptl = parse_ptl(br, True, s.max_tlayers - 1)
    s.gdr_enabled = br.read_flag()
    s.rpr_enabled = br.read_flag()
    if s.rpr_enabled:
        s.res_change_in_clvs = br.read_flag()
    s.max_width = br.read_uvlc()
    s.max_height = br.read_uvlc()
    if br.read_flag():
        sx = 2 if s.chroma_format_idc in (1, 2) else 1
        sy = 2 if s.chroma_format_idc == 1 else 1
        s.conf_win = tuple(br.read_uvlc() * sc for sc in (sx, sx, sy, sy))
    assert br.read_flag() == 0, "subpics unsupported"
    s.bit_depth = br.read_uvlc() + 8
    s.entropy_coding_sync = br.read_flag()
    s.entry_points_present = br.read_flag()
    s.log2_max_poc_lsb = br.read(4) + 4
    s.poc_msb_flag = br.read_flag()
    if s.poc_msb_flag:
        s.poc_msb_len = br.read_uvlc() + 1
    assert br.read(2) == 0 and br.read(2) == 0, "extra ph/sh bits unsupported"
    if s.ptl_dpb_hrd_params_present:
        if s.max_tlayers > 1:
            s.sublayer_dpb_params = br.read_flag()
        first = 0 if s.sublayer_dpb_params else s.max_tlayers - 1
        s.max_dec_pic_buffering = [0] * s.max_tlayers
        s.num_reorder_pics = [0] * s.max_tlayers
        s.max_latency_increase = [0] * s.max_tlayers
        for i in range(first, s.max_tlayers):
            s.max_dec_pic_buffering[i] = br.read_uvlc() + 1
            s.num_reorder_pics[i] = br.read_uvlc()
            s.max_latency_increase[i] = br.read_uvlc()
    s.log2_min_cb_size = br.read_uvlc() + 2
    s.partition_override = br.read_flag()
    lmq0 = br.read_uvlc() + s.log2_min_cb_size
    s.min_qt_size[0] = 1 << lmq0
    s.max_mtt_depth[0] = br.read_uvlc()
    if s.max_mtt_depth[0]:
        s.max_bt_size[0] = 1 << (br.read_uvlc() + lmq0)
        s.max_tt_size[0] = 1 << (br.read_uvlc() + lmq0)
    else:
        s.max_bt_size[0] = s.min_qt_size[0]
        s.max_tt_size[0] = s.min_qt_size[0]
    if s.chroma_format_idc != 0:
        s.dual_i_tree = br.read_flag()
    if s.dual_i_tree:
        lmq2 = br.read_uvlc() + s.log2_min_cb_size
        s.min_qt_size[2] = 1 << lmq2
        s.max_mtt_depth[2] = br.read_uvlc()
        if s.max_mtt_depth[2]:
            s.max_bt_size[2] = 1 << (br.read_uvlc() + lmq2)
            s.max_tt_size[2] = 1 << (br.read_uvlc() + lmq2)
    lmq1 = br.read_uvlc() + s.log2_min_cb_size
    s.min_qt_size[1] = 1 << lmq1
    s.max_mtt_depth[1] = br.read_uvlc()
    if s.max_mtt_depth[1]:
        s.max_bt_size[1] = 1 << (br.read_uvlc() + lmq1)
        s.max_tt_size[1] = 1 << (br.read_uvlc() + lmq1)
    else:
        s.max_bt_size[1] = s.min_qt_size[1]
        s.max_tt_size[1] = s.min_qt_size[1]
    if s.ctu_size > 32:
        s.log2_max_tb_size = 5 + br.read_flag()
    else:
        s.log2_max_tb_size = 5
    s.transform_skip = br.read_flag()
    if s.transform_skip:
        s.log2_max_ts_size = br.read_uvlc() + 2
        s.bdpcm = br.read_flag()
    s.mts = br.read_flag()
    if s.mts:
        s.mts_intra = br.read_flag()
        s.mts_inter = br.read_flag()
    s.lfnst = br.read_flag()
    if s.chroma_format_idc != 0:
        s.joint_cbcr = br.read_flag()
        s.same_qp_table_for_chroma = br.read_flag()
        num_tables = 1 if s.same_qp_table_for_chroma else (3 if s.joint_cbcr else 2)
        s.chroma_qp_tables = []
        for _ in range(num_tables):
            start_m26 = br.read_svlc()
            npts = br.read_uvlc() + 1
            ins, outs = [], []
            for _ in range(npts):
                d_in = br.read_uvlc()
                d_diff = br.read_uvlc()
                ins.append(d_in)
                outs.append(d_diff ^ d_in)
            s.chroma_qp_tables.append((start_m26, ins, outs))
    s.sao_enabled = br.read_flag()
    s.alf_enabled = br.read_flag()
    if s.alf_enabled and s.chroma_format_idc != 0:
        s.ccalf_enabled = br.read_flag()
    s.lmcs_enabled = br.read_flag()
    s.weighted_pred = br.read_flag()
    s.weighted_bipred = br.read_flag()
    s.long_term_refs = br.read_flag()
    if s.vps_id > 0:
        raise NotImplementedError("multilayer")
    s.idr_rpl_present = br.read_flag()
    s.rpl1_copy_from_rpl0 = br.read_flag()
    forbid_zero = not s.weighted_pred and not s.weighted_bipred
    n0 = br.read_uvlc()
    s.rpl_lists[0] = [parse_rpl(br, s.long_term_refs, s.log2_max_poc_lsb,
                                forbid_zero, i) for i in range(n0)]
    if not s.rpl1_copy_from_rpl0:
        n1 = br.read_uvlc()
        s.rpl_lists[1] = [parse_rpl(br, s.long_term_refs, s.log2_max_poc_lsb,
                                    forbid_zero, i) for i in range(n1)]
    else:
        s.rpl_lists[1] = s.rpl_lists[0]
    s.wraparound = br.read_flag()
    s.temporal_mvp = br.read_flag()
    if s.temporal_mvp:
        s.sbtmvp = br.read_flag()
    s.amvr = br.read_flag()
    s.bdof = br.read_flag()
    if s.bdof:
        s.bdof_present = br.read_flag()
    s.smvd = br.read_flag()
    s.dmvr = br.read_flag()
    if s.dmvr:
        s.dmvr_present = br.read_flag()
    s.mmvd = br.read_flag()
    if s.mmvd:
        s.fpel_mmvd = br.read_flag()
    s.max_num_merge_cand = 6 - br.read_uvlc()
    s.sbt = br.read_flag()
    s.affine = br.read_flag()
    if s.affine:
        s.max_num_affine_merge_cand = 5 - br.read_uvlc()
        s.affine_type = br.read_flag()
        if s.amvr:
            s.affine_amvr = br.read_flag()
        s.prof = br.read_flag()
        if s.prof:
            s.prof_present = br.read_flag()
    s.bcw = br.read_flag()
    s.ciip = br.read_flag()
    if s.max_num_merge_cand >= 2:
        s.geo = br.read_flag()
        if s.geo and s.max_num_merge_cand >= 3:
            s.max_num_geo_cand = s.max_num_merge_cand - br.read_uvlc()
        elif s.geo:
            s.max_num_geo_cand = 2  # inferred (sps semantics)
    s.log2_parallel_merge_minus2 = br.read_uvlc()
    s.isp = br.read_flag()
    s.mrl = br.read_flag()
    s.mip = br.read_flag()
    if s.chroma_format_idc != 0:
        s.cclm = br.read_flag()
    if s.chroma_format_idc == 1:
        s.hor_collocated_chroma = br.read_flag()
        s.ver_collocated_chroma = br.read_flag()
    s.plt = br.read_flag()
    if s.chroma_format_idc == 3:
        raise NotImplementedError("4:4:4")
    if s.transform_skip or s.plt:
        s.internal_minus_input_bit_depth = br.read_uvlc()
    s.ibc = br.read_flag()
    if s.ibc:
        s.max_num_ibc_merge_cand = 6 - br.read_uvlc()
    s.ladf = br.read_flag()
    assert not s.ladf
    s.scaling_list_enabled = br.read_flag()
    assert not (s.lfnst and s.scaling_list_enabled)
    s.dep_quant_enabled = br.read_flag()
    s.sign_data_hiding = br.read_flag()
    s.virtual_boundaries = br.read_flag()
    assert not s.virtual_boundaries
    if s.ptl_dpb_hrd_params_present:
        s.timing_hrd_present = br.read_flag()
        if s.timing_hrd_present:
            s.general_hrd = parse_general_hrd(br)
            if s.max_tlayers - 1 > 0:
                s.sublayer_cpb_params = br.read_flag()
            first = 0 if s.sublayer_cpb_params else s.max_tlayers - 1
            s.ols_hrd = parse_ols_hrd(br, s.general_hrd, first, s.max_tlayers - 1)
    s.field_seq = br.read_flag()
    s.vui_present = br.read_flag()
    if s.vui_present:
        size = br.read_uvlc() + 1          # sps_vui_payload_size_minus1
        br.byte_align()                    # sps_vui_alignment_zero_bit
        p0 = br.pos_bits
        s.vui = parse_vui(br, size)
        # skip any vui_payload alignment bits up to the counted size
        while br.pos_bits < p0 + 8 * size:
            br.read(1)
    assert br.read_flag() == 0, "sps extensions unsupported"
    return s


# ---------------------------------------------------------------------------
# PPS
# ---------------------------------------------------------------------------

def write_pps(bw: BitWriter, p: PPS, sps: SPS) -> None:
    bw.write(p.pps_id, 6)
    bw.write(p.sps_id, 4)
    bw.write_flag(p.mixed_nalu_types)
    bw.write_uvlc(p.pic_width)
    bw.write_uvlc(p.pic_height)
    if p.pic_width == sps.max_width and p.pic_height == sps.max_height:
        bw.write_flag(0)
    else:
        bw.write_flag(p.conf_window_explicit)
        assert not p.conf_window_explicit
    bw.write_flag(p.scaling_window)
    assert not p.scaling_window
    bw.write_flag(p.output_flag_present)
    bw.write_flag(p.no_pic_partition)
    bw.write_flag(p.subpic_id_mapping)
    assert not p.subpic_id_mapping
    if not p.no_pic_partition:
        bw.write(p.log2_ctu_size - 5, 2)
        bw.write_uvlc(len(p.tile_col_widths) - 1)
        bw.write_uvlc(len(p.tile_row_heights) - 1)
        for w in p.tile_col_widths:
            bw.write_uvlc(w - 1)
        for h in p.tile_row_heights:
            bw.write_uvlc(h - 1)
        num_tiles = len(p.tile_col_widths) * len(p.tile_row_heights)
        if num_tiles > 1:
            bw.write_flag(p.loop_filter_across_tiles)
            bw.write_flag(p.rect_slice)
        if p.rect_slice:
            bw.write_flag(p.single_slice_per_subpic)
        if p.rect_slice and not p.single_slice_per_subpic:
            bw.write_uvlc(p.num_slices - 1)
        if p.rect_slice == 0 or p.single_slice_per_subpic or p.num_slices > 1:
            bw.write_flag(p.loop_filter_across_slices)
    bw.write_flag(p.cabac_init_present)
    bw.write_uvlc(p.num_ref_idx_default[0] - 1)
    bw.write_uvlc(p.num_ref_idx_default[1] - 1)
    bw.write_flag(p.rpl1_idx_present)
    bw.write_flag(p.weighted_pred)
    bw.write_flag(p.weighted_bipred)
    bw.write_flag(p.wraparound)
    assert not p.wraparound
    bw.write_svlc(p.init_qp - 26)
    bw.write_flag(p.cu_qp_delta_enabled)
    bw.write_flag(p.chroma_tool_offsets_present)
    if p.chroma_tool_offsets_present:
        bw.write_svlc(p.cb_qp_offset)
        bw.write_svlc(p.cr_qp_offset)
        bw.write_flag(p.joint_cbcr_qp_offset_present)
        if p.joint_cbcr_qp_offset_present:
            bw.write_svlc(p.joint_cbcr_qp_offset)
        bw.write_flag(p.slice_chroma_qp_flag)
        bw.write_flag(1 if p.chroma_qp_offset_list else 0)
        assert not p.chroma_qp_offset_list
    bw.write_flag(p.deblocking_filter_control_present)
    if p.deblocking_filter_control_present:
        bw.write_flag(p.deblocking_filter_override_enabled)
        bw.write_flag(p.deblocking_filter_disabled)
        if not p.no_pic_partition and p.deblocking_filter_override_enabled:
            bw.write_flag(p.dbf_info_in_ph)
        if not p.deblocking_filter_disabled:
            bw.write_svlc(p.beta_offset_div2)
            bw.write_svlc(p.tc_offset_div2)
            if p.chroma_tool_offsets_present:
                bw.write_svlc(p.cb_beta_offset_div2)
                bw.write_svlc(p.cb_tc_offset_div2)
                bw.write_svlc(p.cr_beta_offset_div2)
                bw.write_svlc(p.cr_tc_offset_div2)
    if not p.no_pic_partition:
        bw.write_flag(p.rpl_info_in_ph)
        bw.write_flag(p.sao_info_in_ph)
        bw.write_flag(p.alf_info_in_ph)
        if (p.weighted_pred or p.weighted_bipred) and p.rpl_info_in_ph:
            bw.write_flag(p.wp_info_in_ph)
        bw.write_flag(p.qp_delta_info_in_ph)
    bw.write_flag(p.picture_header_extension)
    bw.write_flag(p.slice_header_extension)
    bw.write_flag(0)  # pps_extension_present_flag
    bw.write_rbsp_trailing_bits()


def parse_pps(br: BitReader, sps: SPS) -> PPS:
    p = PPS()
    p.pps_id = br.read(6)
    p.sps_id = br.read(4)
    p.mixed_nalu_types = br.read_flag()
    p.pic_width = br.read_uvlc()
    p.pic_height = br.read_uvlc()
    p.conf_window_explicit = br.read_flag()
    assert not p.conf_window_explicit, "pps conformance window unsupported"
    p.scaling_window = br.read_flag()
    assert not p.scaling_window
    p.output_flag_present = br.read_flag()
    p.no_pic_partition = br.read_flag()
    p.subpic_id_mapping = br.read_flag()
    assert not p.subpic_id_mapping
    if not p.no_pic_partition:
        p.log2_ctu_size = br.read(2) + 5
        ncols = br.read_uvlc() + 1
        nrows = br.read_uvlc() + 1
        p.tile_col_widths = [br.read_uvlc() + 1 for _ in range(ncols)]
        p.tile_row_heights = [br.read_uvlc() + 1 for _ in range(nrows)]
        # NumTilesInPic uses the counts AFTER implicit repetition of the
        # last explicit size (H.266 6.5.1), not the explicit counts
        ctu = 1 << p.log2_ctu_size

        def _expand_count(sizes, total):
            out = list(sizes)
            while sum(out) < total:
                out.append(sizes[-1])
            return len(out)
        n_tc = _expand_count(p.tile_col_widths,
                             (p.pic_width + ctu - 1) // ctu)
        n_tr = _expand_count(p.tile_row_heights,
                             (p.pic_height + ctu - 1) // ctu)
        num_tiles = n_tc * n_tr
        if num_tiles > 1:
            p.loop_filter_across_tiles = br.read_flag()
            p.rect_slice = br.read_flag()
        if p.rect_slice:
            p.single_slice_per_subpic = br.read_flag()
        if p.rect_slice and not p.single_slice_per_subpic:
            p.num_slices = br.read_uvlc() + 1
            assert p.num_slices == 1, "multi-slice unsupported"
        if p.rect_slice == 0 or p.single_slice_per_subpic or p.num_slices > 1:
            p.loop_filter_across_slices = br.read_flag()
    p.cabac_init_present = br.read_flag()
    p.num_ref_idx_default = (br.read_uvlc() + 1, br.read_uvlc() + 1)
    p.rpl1_idx_present = br.read_flag()
    p.weighted_pred = br.read_flag()
    p.weighted_bipred = br.read_flag()
    p.wraparound = br.read_flag()
    assert not p.wraparound
    p.init_qp = br.read_svlc() + 26
    p.cu_qp_delta_enabled = br.read_flag()
    p.chroma_tool_offsets_present = br.read_flag()
    if p.chroma_tool_offsets_present:
        p.cb_qp_offset = br.read_svlc()
        p.cr_qp_offset = br.read_svlc()
        p.joint_cbcr_qp_offset_present = br.read_flag()
        if p.joint_cbcr_qp_offset_present:
            p.joint_cbcr_qp_offset = br.read_svlc()
        p.slice_chroma_qp_flag = br.read_flag()
        cu_chroma_qp_list = br.read_flag()
        assert not cu_chroma_qp_list, "chroma qp offset lists unsupported"
    p.deblocking_filter_control_present = br.read_flag()
    if p.deblocking_filter_control_present:
        p.deblocking_filter_override_enabled = br.read_flag()
        p.deblocking_filter_disabled = br.read_flag()
        if not p.no_pic_partition and p.deblocking_filter_override_enabled:
            p.dbf_info_in_ph = br.read_flag()
        if not p.deblocking_filter_disabled:
            p.beta_offset_div2 = br.read_svlc()
            p.tc_offset_div2 = br.read_svlc()
            if p.chroma_tool_offsets_present:
                p.cb_beta_offset_div2 = br.read_svlc()
                p.cb_tc_offset_div2 = br.read_svlc()
                p.cr_beta_offset_div2 = br.read_svlc()
                p.cr_tc_offset_div2 = br.read_svlc()
    if not p.no_pic_partition:
        p.rpl_info_in_ph = br.read_flag()
        p.sao_info_in_ph = br.read_flag()
        p.alf_info_in_ph = br.read_flag()
        if (p.weighted_pred or p.weighted_bipred) and p.rpl_info_in_ph:
            p.wp_info_in_ph = br.read_flag()
        p.qp_delta_info_in_ph = br.read_flag()
    p.picture_header_extension = br.read_flag()
    p.slice_header_extension = br.read_flag()
    assert br.read_flag() == 0, "pps extensions unsupported"
    return p


# ---------------------------------------------------------------------------
# Picture header
# ---------------------------------------------------------------------------

def write_picture_header(bw: BitWriter, ph: PictureHeader, sps: SPS, pps: PPS,
                         trailing_bits: bool) -> None:
    bw.write_flag(ph.gdr_or_irap)
    bw.write_flag(ph.non_ref_pic)
    if ph.gdr_or_irap:
        bw.write_flag(ph.gdr_pic)
    bw.write_flag(ph.inter_slice_allowed)
    if ph.inter_slice_allowed:
        bw.write_flag(ph.intra_slice_allowed)
    bw.write_uvlc(ph.pps_id)
    bw.write(ph.poc_lsb, sps.log2_max_poc_lsb)
    if ph.gdr_pic:
        bw.write_uvlc(ph.recovery_poc_cnt)
    if sps.poc_msb_flag:
        raise NotImplementedError("poc msb")
    assert not (sps.alf_enabled and pps.alf_info_in_ph), "alf-in-ph unsupported"
    if sps.lmcs_enabled:
        bw.write_flag(ph.lmcs_enabled)
        if ph.lmcs_enabled:
            bw.write(ph.lmcs_aps_id, 2)
            bw.write_flag(ph.chroma_residual_scale)  # ChromaArrayType != 0
    assert not sps.scaling_list_enabled
    if pps.output_flag_present and not ph.non_ref_pic:
        bw.write_flag(1)
    if pps.rpl_info_in_ph:
        _write_ph_rpls(bw, ph, sps, pps)
    if sps.partition_override:
        bw.write_flag(0)  # partition_constraints_override_flag
    if ph.intra_slice_allowed:
        if pps.cu_qp_delta_enabled:
            bw.write_uvlc(ph.cu_qp_delta_subdiv_intra)
        # chroma qp offset list absent
    if ph.inter_slice_allowed:
        if pps.cu_qp_delta_enabled:
            bw.write_uvlc(ph.cu_qp_delta_subdiv_inter)
        if sps.temporal_mvp:
            bw.write_flag(ph.enable_tmvp)
            if ph.enable_tmvp and pps.rpl_info_in_ph:
                raise NotImplementedError
        if sps.fpel_mmvd:
            bw.write_flag(0)
        if not pps.rpl_info_in_ph or ph.rpls[1].num_refs > 0:
            bw.write_flag(ph.mvd_l1_zero)
        if sps.bdof_present and (not pps.rpl_info_in_ph or ph.rpls[1].num_refs > 0):
            bw.write_flag(ph.dis_bdof)
        if sps.dmvr_present and (not pps.rpl_info_in_ph or ph.rpls[1].num_refs > 0):
            bw.write_flag(ph.dis_dmvr)
        if sps.prof_present:
            bw.write_flag(ph.dis_prof)
        assert not ((pps.weighted_pred or pps.weighted_bipred) and pps.wp_info_in_ph)
    if pps.qp_delta_info_in_ph:
        bw.write_svlc(ph.qp_delta)
    if sps.joint_cbcr:
        bw.write_flag(ph.joint_cbcr_sign)
    if sps.sao_enabled and pps.sao_info_in_ph:
        bw.write_flag(ph.sao_luma)
        if sps.chroma_format_idc != 0:
            bw.write_flag(ph.sao_chroma)
    # deblocking override not used
    assert not (pps.deblocking_filter_control_present
                and pps.deblocking_filter_override_enabled and pps.dbf_info_in_ph)
    if pps.picture_header_extension:
        bw.write_uvlc(0)
    if trailing_bits:
        bw.write_rbsp_trailing_bits()


def _write_ph_rpls(bw, ph, sps, pps):
    forbid_zero = not sps.weighted_pred and not sps.weighted_bipred
    for li in range(2):
        num_sps_rpl = sps.num_rpl(li)
        if num_sps_rpl > 0 and (li == 0 or pps.rpl1_idx_present):
            bw.write_flag(ph.rpl_idx[li] != -1)
        if ph.rpl_idx[li] != -1:
            if num_sps_rpl > 1 and (li == 0 or pps.rpl1_idx_present):
                bw.write(ph.rpl_idx[li], _ceil_log2(num_sps_rpl))
        else:
            write_rpl(bw, ph.rpls[li], sps.long_term_refs, sps.log2_max_poc_lsb,
                      forbid_zero, -1)


def _parse_ph_rpls(br, ph, sps, pps):
    forbid_zero = not sps.weighted_pred and not sps.weighted_bipred
    for li in range(2):
        num_sps_rpl = sps.num_rpl(li)
        sps_flag = 0
        if num_sps_rpl > 0 and (li == 0 or pps.rpl1_idx_present):
            sps_flag = br.read_flag()
        elif li == 1 and num_sps_rpl > 0:
            sps_flag = 1 if ph.rpl_idx[0] != -1 else 0
        if sps_flag:
            if num_sps_rpl > 1 and (li == 0 or pps.rpl1_idx_present):
                ph.rpl_idx[li] = br.read(_ceil_log2(num_sps_rpl))
            elif num_sps_rpl == 1:
                ph.rpl_idx[li] = 0
            else:
                ph.rpl_idx[li] = ph.rpl_idx[0]
            ph.rpls[li] = sps.rpl_lists[li][ph.rpl_idx[li]]
        else:
            ph.rpl_idx[li] = -1
            ph.rpls[li] = parse_rpl(br, sps.long_term_refs, sps.log2_max_poc_lsb,
                                    forbid_zero, -1)
        assert ph.rpls[li].num_long_term == 0


def parse_picture_header(br: BitReader, sps: SPS, pps: PPS) -> PictureHeader:
    ph = PictureHeader()
    ph.gdr_or_irap = br.read_flag()
    ph.non_ref_pic = br.read_flag()
    if ph.gdr_or_irap:
        ph.gdr_pic = br.read_flag()
        assert not ph.gdr_pic
    ph.inter_slice_allowed = br.read_flag()
    if ph.inter_slice_allowed:
        ph.intra_slice_allowed = br.read_flag()
    else:
        ph.intra_slice_allowed = 1
    ph.pps_id = br.read_uvlc()
    ph.poc_lsb = br.read(sps.log2_max_poc_lsb)
    if ph.gdr_pic:
        ph.recovery_poc_cnt = br.read_uvlc()
    assert not sps.poc_msb_flag
    assert not (sps.alf_enabled and pps.alf_info_in_ph)
    if sps.lmcs_enabled:
        ph.lmcs_enabled = br.read_flag()
        if ph.lmcs_enabled:
            ph.lmcs_aps_id = br.read(2)
            ph.chroma_residual_scale = br.read_flag()
    assert not sps.scaling_list_enabled
    if pps.output_flag_present and not ph.non_ref_pic:
        br.read_flag()
    if pps.rpl_info_in_ph:
        _parse_ph_rpls(br, ph, sps, pps)
    if sps.partition_override:
        # ph_partition_constraints_override (7.3.2.7): per-picture QTBTT
        # constraint overrides keyed like the SPS arrays (0=intra luma,
        # 1=inter, 2=intra chroma)
        if br.read_flag():
            ov = {}
            lmin = sps.log2_min_cb_size
            if ph.intra_slice_allowed:
                lmq = br.read_uvlc() + lmin
                d = br.read_uvlc()
                bt = tt = 1 << lmq
                if d:
                    bt = 1 << (br.read_uvlc() + lmq)
                    tt = 1 << (br.read_uvlc() + lmq)
                ov[0] = (1 << lmq, d, bt, tt)
                if sps.dual_i_tree:
                    lmq = br.read_uvlc() + lmin
                    d = br.read_uvlc()
                    bt = tt = 1 << lmq
                    if d:
                        bt = 1 << (br.read_uvlc() + lmq)
                        tt = 1 << (br.read_uvlc() + lmq)
                    ov[2] = (1 << lmq, d, bt, tt)
            if ph.inter_slice_allowed:
                lmq = br.read_uvlc() + lmin
                d = br.read_uvlc()
                bt = tt = 1 << lmq
                if d:
                    bt = 1 << (br.read_uvlc() + lmq)
                    tt = 1 << (br.read_uvlc() + lmq)
                ov[1] = (1 << lmq, d, bt, tt)
            ph.partition_override = ov
    if ph.intra_slice_allowed:
        if pps.cu_qp_delta_enabled:
            ph.cu_qp_delta_subdiv_intra = br.read_uvlc()
    if ph.inter_slice_allowed:
        if pps.cu_qp_delta_enabled:
            ph.cu_qp_delta_subdiv_inter = br.read_uvlc()
        if sps.temporal_mvp:
            ph.enable_tmvp = br.read_flag()
            if ph.enable_tmvp and pps.rpl_info_in_ph:
                if ph.rpls[1].num_refs > 0:
                    ph.pic_col_from_l0 = br.read(1)
                if ((ph.pic_col_from_l0 and ph.rpls[0].num_refs > 1) or
                        (not ph.pic_col_from_l0 and ph.rpls[1].num_refs > 1)):
                    ph.col_ref_idx = br.read_uvlc()
        if sps.fpel_mmvd:
            br.read_flag()
        if not pps.rpl_info_in_ph or ph.rpls[1].num_refs > 0:
            ph.mvd_l1_zero = br.read_flag()
        if sps.bdof_present and (not pps.rpl_info_in_ph or ph.rpls[1].num_refs > 0):
            ph.dis_bdof = br.read_flag()
        if sps.dmvr_present and (not pps.rpl_info_in_ph or ph.rpls[1].num_refs > 0):
            ph.dis_dmvr = br.read_flag()
        if sps.prof_present:
            ph.dis_prof = br.read_flag()
        assert not ((pps.weighted_pred or pps.weighted_bipred) and pps.wp_info_in_ph)
    if pps.qp_delta_info_in_ph:
        ph.qp_delta = br.read_svlc()
    if sps.joint_cbcr:
        ph.joint_cbcr_sign = br.read_flag()
    if sps.sao_enabled and pps.sao_info_in_ph:
        ph.sao_luma = br.read_flag()
        if sps.chroma_format_idc != 0:
            ph.sao_chroma = br.read_flag()
    assert not (pps.deblocking_filter_control_present
                and pps.deblocking_filter_override_enabled and pps.dbf_info_in_ph)
    if pps.picture_header_extension:
        ext = br.read_uvlc()
        for _ in range(ext):
            br.read(8)
    return ph


# ---------------------------------------------------------------------------
# Slice header
# ---------------------------------------------------------------------------

def write_slice_header(bw: BitWriter, sh: SliceHeader, sps: SPS, pps: PPS,
                       is_idr: bool) -> None:
    bw.write_flag(sh.picture_header_in_slice_header)
    if sh.picture_header_in_slice_header:
        write_picture_header(bw, sh.ph, sps, pps, False)
    ph = sh.ph
    # single rect slice per pic: no subpic id / no slice address
    if ph.inter_slice_allowed:
        bw.write_uvlc(sh.slice_type)
    if ph.gdr_or_irap:
        bw.write_flag(sh.no_output_of_prior_pics)
    if sps.alf_enabled and not pps.alf_info_in_ph:
        # sh_alf_* (vvenc HLSWriter::codeSliceHeader, VLCWriter.cpp:1769)
        bw.write_flag(sh.alf_enabled[0])
        if sh.alf_enabled[0]:
            bw.write(sh.num_alf_aps, 3)
            for aid in sh.luma_aps_ids:
                bw.write(aid, 3)
            if sps.chroma_format_idc != 0:
                bw.write_flag(sh.alf_enabled[1])
                bw.write_flag(sh.alf_enabled[2])
            if sh.alf_enabled[1] or sh.alf_enabled[2]:
                bw.write(sh.chroma_aps_id, 3)
            if sps.ccalf_enabled:
                bw.write_flag(sh.cc_alf_enabled[0])
                if sh.cc_alf_enabled[0]:
                    bw.write(sh.cc_alf_aps_ids[0], 3)
                bw.write_flag(sh.cc_alf_enabled[1])
                if sh.cc_alf_enabled[1]:
                    bw.write(sh.cc_alf_aps_ids[1], 3)
    if ph.lmcs_enabled and not sh.picture_header_in_slice_header:
        bw.write_flag(sh.lmcs_enabled)  # sh_lmcs_used_flag
    if not pps.rpl_info_in_ph and (not is_idr or sps.idr_rpl_present):
        _write_sh_rpls(bw, sh, sps, pps)
        rpl0_n = sh.rpls[0].num_refs if sh.rpl_idx[0] == -1 else \
            sps.rpl_lists[0][sh.rpl_idx[0]].num_refs
        rpl1_n = sh.rpls[1].num_refs if sh.rpl_idx[1] == -1 else \
            sps.rpl_lists[1][sh.rpl_idx[1]].num_refs
        if (sh.slice_type != SLICE_I and rpl0_n > 1) or \
                (sh.slice_type == 0 and rpl1_n > 1):
            default0 = min(rpl0_n, pps.num_ref_idx_default[0])
            default1 = min(rpl1_n, pps.num_ref_idx_default[1]) if sh.slice_type == 0 else 0
            override = (sh.num_ref_idx[0] != default0 or
                        (sh.slice_type == 0 and sh.num_ref_idx[1] != default1))
            bw.write_flag(override)
            if override:
                if rpl0_n > 1:
                    bw.write_uvlc(sh.num_ref_idx[0] - 1)
                if sh.slice_type == 0 and rpl1_n > 1:
                    bw.write_uvlc(sh.num_ref_idx[1] - 1)
    if sh.slice_type != SLICE_I:
        if pps.cabac_init_present:
            bw.write_flag(sh.cabac_init_flag)
        if ph.enable_tmvp and not pps.rpl_info_in_ph:
            if sh.slice_type == 0:
                bw.write_flag(sh.col_from_l0)
            if ((sh.col_from_l0 and sh.num_ref_idx[0] > 1) or
                    (not sh.col_from_l0 and sh.num_ref_idx[1] > 1)):
                bw.write_uvlc(sh.col_ref_idx)
        assert not pps.weighted_pred and not pps.weighted_bipred
    if not pps.qp_delta_info_in_ph:
        bw.write_svlc(sh.slice_qp - pps.init_qp)
    if pps.slice_chroma_qp_flag:
        bw.write_svlc(sh.cb_qp_offset)
        bw.write_svlc(sh.cr_qp_offset)
        if sps.joint_cbcr:
            bw.write_svlc(0)
    if sps.sao_enabled and not pps.sao_info_in_ph:
        bw.write_flag(sh.sao_luma)
        if sps.chroma_format_idc != 0:
            bw.write_flag(sh.sao_chroma)
    if pps.deblocking_filter_control_present and not pps.dbf_info_in_ph:
        if pps.deblocking_filter_override_enabled:
            bw.write_flag(sh.deblocking_filter_override)
        if sh.deblocking_filter_override:
            if not pps.deblocking_filter_disabled:
                bw.write_flag(sh.deblocking_filter_disable)
            if not sh.deblocking_filter_disable:
                raise NotImplementedError("slice dbf offsets")
    if sps.dep_quant_enabled:
        bw.write_flag(sh.dep_quant_used)
    if sps.sign_data_hiding and not sh.dep_quant_used:
        bw.write_flag(sh.sign_data_hiding_used)
    if sps.transform_skip and not sh.dep_quant_used and not sh.sign_data_hiding_used:
        bw.write_flag(sh.ts_residual_coding_disabled)
    if pps.slice_header_extension:
        bw.write_uvlc(0)
    if sps.entry_points_present and sh.entry_point_offsets:
        # WPP: one substream per CTU row (H.266 7.3.7.1)
        max_off = max(sh.entry_point_offsets)
        off_len = max(1, (max_off - 1).bit_length())
        bw.write_uvlc(off_len - 1)
        for off in sh.entry_point_offsets:
            bw.write(off - 1, off_len)
    # NB: byte_alignment() before slice data is done by the caller


def _write_sh_rpls(bw, sh, sps, pps):
    forbid_zero = not sps.weighted_pred and not sps.weighted_bipred
    num_rpl0 = sps.num_rpl(0)
    if num_rpl0 > 0:
        bw.write_flag(sh.rpl_idx[0] != -1)
    if sh.rpl_idx[0] != -1:
        if num_rpl0 > 1:
            bw.write(sh.rpl_idx[0], _ceil_log2(num_rpl0))
    else:
        write_rpl(bw, sh.rpls[0], sps.long_term_refs, sps.log2_max_poc_lsb,
                  forbid_zero, -1)
    num_rpl1 = sps.num_rpl(1)
    if num_rpl1 > 1 and pps.rpl1_idx_present:
        bw.write_flag(sh.rpl_idx[1] != -1)
    if sh.rpl_idx[1] != -1:
        if num_rpl1 > 1 and pps.rpl1_idx_present:
            bw.write(sh.rpl_idx[1], _ceil_log2(num_rpl1))
    else:
        if not (num_rpl1 > 0 and not pps.rpl1_idx_present and sh.rpl_idx[0] != -1):
            write_rpl(bw, sh.rpls[1], sps.long_term_refs, sps.log2_max_poc_lsb,
                      forbid_zero, -1)


def parse_slice_header(br: BitReader, sps: SPS, pps: PPS, is_idr: bool) -> SliceHeader:
    sh = SliceHeader()
    sh.picture_header_in_slice_header = br.read_flag()
    if sh.picture_header_in_slice_header:
        sh.ph = parse_picture_header(br, sps, pps)
    else:
        raise NotImplementedError("separate PH NAL")
    ph = sh.ph
    if ph.inter_slice_allowed:
        sh.slice_type = br.read_uvlc()
    else:
        sh.slice_type = SLICE_I
    if ph.gdr_or_irap:
        sh.no_output_of_prior_pics = br.read_flag()
    if sps.alf_enabled and not pps.alf_info_in_ph:
        sh.alf_enabled[0] = br.read_flag()
        if sh.alf_enabled[0]:
            sh.num_alf_aps = br.read(3)
            sh.luma_aps_ids = [br.read(3) for _ in range(sh.num_alf_aps)]
            if sps.chroma_format_idc != 0:
                sh.alf_enabled[1] = br.read_flag()
                sh.alf_enabled[2] = br.read_flag()
            if sh.alf_enabled[1] or sh.alf_enabled[2]:
                sh.chroma_aps_id = br.read(3)
            if sps.ccalf_enabled:
                sh.cc_alf_enabled[0] = br.read_flag()
                if sh.cc_alf_enabled[0]:
                    sh.cc_alf_aps_ids[0] = br.read(3)
                sh.cc_alf_enabled[1] = br.read_flag()
                if sh.cc_alf_enabled[1]:
                    sh.cc_alf_aps_ids[1] = br.read(3)
    if ph.lmcs_enabled:
        sh.lmcs_enabled = (br.read_flag()
                           if not sh.picture_header_in_slice_header else 1)
    if not pps.rpl_info_in_ph and (not is_idr or sps.idr_rpl_present):
        _parse_sh_rpls(br, sh, sps, pps)
        rpl0_n = sh.rpls[0].num_refs
        rpl1_n = sh.rpls[1].num_refs
        sh.num_ref_idx[0] = min(rpl0_n, pps.num_ref_idx_default[0]) \
            if sh.slice_type != SLICE_I else 0
        sh.num_ref_idx[1] = min(rpl1_n, pps.num_ref_idx_default[1]) \
            if sh.slice_type == 0 else 0
        if (sh.slice_type != SLICE_I and rpl0_n > 1) or \
                (sh.slice_type == 0 and rpl1_n > 1):
            if br.read_flag():
                if rpl0_n > 1:
                    sh.num_ref_idx[0] = br.read_uvlc() + 1
                if sh.slice_type == 0 and rpl1_n > 1:
                    sh.num_ref_idx[1] = br.read_uvlc() + 1
    elif pps.rpl_info_in_ph:
        sh.rpls = ph.rpls
    if sh.slice_type != SLICE_I:
        if pps.cabac_init_present:
            sh.cabac_init_flag = br.read_flag()
        if ph.enable_tmvp and not pps.rpl_info_in_ph:
            if sh.slice_type == 0:
                sh.col_from_l0 = br.read_flag()
            if ((sh.col_from_l0 and sh.num_ref_idx[0] > 1) or
                    (not sh.col_from_l0 and sh.num_ref_idx[1] > 1)):
                sh.col_ref_idx = br.read_uvlc()
        assert not pps.weighted_pred and not pps.weighted_bipred
    if not pps.qp_delta_info_in_ph:
        sh.slice_qp = br.read_svlc() + pps.init_qp
    else:
        sh.slice_qp = pps.init_qp + ph.qp_delta
    if pps.slice_chroma_qp_flag:
        sh.cb_qp_offset = br.read_svlc()
        sh.cr_qp_offset = br.read_svlc()
        if sps.joint_cbcr:
            br.read_svlc()
    if sps.sao_enabled and not pps.sao_info_in_ph:
        sh.sao_luma = br.read_flag()
        if sps.chroma_format_idc != 0:
            sh.sao_chroma = br.read_flag()
    if pps.deblocking_filter_control_present and not pps.dbf_info_in_ph:
        if pps.deblocking_filter_override_enabled:
            sh.deblocking_filter_override = br.read_flag()
        if sh.deblocking_filter_override:
            if not pps.deblocking_filter_disabled:
                sh.deblocking_filter_disable = br.read_flag()
            if not sh.deblocking_filter_disable:
                raise NotImplementedError("slice dbf offsets")
    if sps.dep_quant_enabled:
        sh.dep_quant_used = br.read_flag()
    if sps.sign_data_hiding and not sh.dep_quant_used:
        sh.sign_data_hiding_used = br.read_flag()
    if sps.transform_skip and not sh.dep_quant_used and not sh.sign_data_hiding_used:
        sh.ts_residual_coding_disabled = br.read_flag()
    if pps.slice_header_extension:
        ext = br.read_uvlc()
        for _ in range(ext):
            br.read(8)
    # entry point offsets: with a single tile and no WPP there are none
    # (H.266 7.3.7.1 sh_entry_offset_len_minus1 only if NumEntryPoints > 0)
    if sps.entry_points_present:
        num_entry_points = 0  # single slice covering the picture
        if not pps.no_pic_partition:
            cols, rows = tile_grid(pps, sps)
            assert not sps.entropy_coding_sync, "tiles+WPP TBD"
            num_entry_points = len(cols) * len(rows) - 1
        elif sps.entropy_coding_sync:
            n_rows = (sps.max_height + sps.ctu_size - 1) // sps.ctu_size
            num_entry_points = n_rows - 1
        if num_entry_points > 0:
            offset_len = br.read_uvlc() + 1
            sh.entry_point_offsets = [br.read(offset_len) + 1
                                      for _ in range(num_entry_points)]
    br.read_flag()  # byte_alignment: alignment bit = 1
    br.byte_align()
    return sh


def tile_grid(pps, sps):
    """CTU-unit tile column widths / row heights with the spec's implicit
    repetition of the last explicit size (H.266 6.5.1)."""
    ctu = sps.ctu_size
    w_ctus = (pps.pic_width + ctu - 1) // ctu
    h_ctus = (pps.pic_height + ctu - 1) // ctu

    def expand(sizes, total):
        out = list(sizes)
        while sum(out) < total:
            out.append(sizes[-1])
        if sum(out) > total:
            # trim the final entry to the picture boundary
            out[-1] -= sum(out) - total
            out = [s for s in out if s > 0]
        return out
    return (expand(pps.tile_col_widths, w_ctus),
            expand(pps.tile_row_heights, h_ctus))


def _parse_sh_rpls(br, sh, sps, pps):
    forbid_zero = not sps.weighted_pred and not sps.weighted_bipred
    num_rpl0 = sps.num_rpl(0)
    sps_flag0 = br.read_flag() if num_rpl0 > 0 else 0
    if sps_flag0:
        sh.rpl_idx[0] = br.read(_ceil_log2(num_rpl0)) if num_rpl0 > 1 else 0
        sh.rpls[0] = sps.rpl_lists[0][sh.rpl_idx[0]]
    else:
        sh.rpl_idx[0] = -1
        sh.rpls[0] = parse_rpl(br, sps.long_term_refs, sps.log2_max_poc_lsb,
                               forbid_zero, -1)
    num_rpl1 = sps.num_rpl(1)
    if num_rpl1 > 1 and pps.rpl1_idx_present:
        sps_flag1 = br.read_flag()
    elif num_rpl1 == 0:
        sps_flag1 = 0
    else:
        sps_flag1 = sps_flag0
    if sps_flag1:
        if num_rpl1 > 1 and pps.rpl1_idx_present:
            sh.rpl_idx[1] = br.read(_ceil_log2(num_rpl1))
        elif num_rpl1 == 1:
            sh.rpl_idx[1] = 0
        else:
            sh.rpl_idx[1] = sh.rpl_idx[0]
        sh.rpls[1] = sps.rpl_lists[1][sh.rpl_idx[1]]
    else:
        sh.rpl_idx[1] = -1
        sh.rpls[1] = parse_rpl(br, sps.long_term_refs, sps.log2_max_poc_lsb,
                               forbid_zero, -1)


# ---------------------------------------------------------------------------
# AUD / DCI / VPS (vvenc HLSWriter::codeAUD, codeDCI, codeVPS —
# VLCWriter.cpp; single-layer VPS scope)
# ---------------------------------------------------------------------------

def write_aud(bw: BitWriter, irap_or_gdr: bool, pic_type: int) -> None:
    """Access-unit delimiter (H.266 7.3.2.10): pic_type 0 = I only,
    1 = I/P, 2 = I/P/B."""
    bw.write_flag(1 if irap_or_gdr else 0)
    bw.write(pic_type, 3)
    bw.write_rbsp_trailing_bits()


def parse_aud(br: BitReader):
    irap_or_gdr = br.read_flag()
    pic_type = br.read(3)
    return irap_or_gdr, pic_type


def write_dci(bw: BitWriter, ptl: ProfileTierLevel,
              max_sublayers: int = 1) -> None:
    """Decoding-capability information (H.266 7.3.2.1)."""
    bw.write(0, 4)                       # dci_reserved_zero_4bits
    bw.write(0, 4)                       # dci_num_ptls_minus1
    write_ptl(bw, ptl, True, max_sublayers - 1)
    bw.write_flag(0)                     # dci_extension_flag
    bw.write_rbsp_trailing_bits()


def parse_dci(br: BitReader, max_sublayers: int = 1) -> ProfileTierLevel:
    br.read(4)
    n = br.read(4) + 1
    assert n == 1, "multi-PTL DCI unsupported"
    ptl = parse_ptl(br, True, max_sublayers - 1)
    br.read_flag()
    return ptl


def write_vps(bw: BitWriter, ptl: ProfileTierLevel, vps_id: int = 1,
              max_sublayers: int = 1) -> None:
    """Minimal single-layer VPS (H.266 7.3.2.3).  Single-layer bitstreams
    do not require a VPS (sps_video_parameter_set_id == 0); this writer
    exists for API parity with HLSWriter::codeVPS."""
    assert vps_id > 0 and max_sublayers == 1
    bw.write(vps_id, 4)                  # vps_video_parameter_set_id
    bw.write(0, 6)                       # vps_max_layers_minus1
    bw.write(0, 3)                       # vps_max_sublayers_minus1
    # single layer + single sublayer: default-ptl / all-independent /
    # OLS-mode syntax all absent (guarded by vps_max_layers_minus1 > 0)
    bw.write(0, 6)                       # vps_layer_id[0]
    bw.write(0, 8)                       # vps_num_ptls_minus1
    while not bw.is_byte_aligned():
        bw.write_flag(0)                 # vps_ptl_alignment_zero_bit
    write_ptl(bw, ptl, True, 0)
    # each layer is an OLS (inferred): no DPB/HRD blocks
    bw.write_flag(0)                     # vps_extension_flag
    bw.write_rbsp_trailing_bits()


def parse_vps(br: BitReader) -> int:
    return br.read(4)

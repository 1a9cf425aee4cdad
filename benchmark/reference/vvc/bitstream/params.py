"""High-level parameter structures: SPS / PPS / PictureHeader / SliceHeader.

Field names follow ITU-T H.266 section 7.3.2 syntax element names (shortened).
Reference analog: vvenc CommonLib/Slice.h (SPS/PPS/PicHeader/Slice state)
and EncoderLib/VLCWriter.cpp (serialization order).  Only the feature set our
encoder emits is modeled; parsers raise on unsupported branches so gaps are
loud, not silent.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class ProfileTierLevel:
    profile_idc: int = 1           # Main10
    tier_flag: int = 0
    level_idc: int = 35            # level 2.0 (value = level * 16)
    frame_only_constraint: int = 1
    multilayer_enabled: int = 0
    sub_layer_level_present: List[int] = field(default_factory=list)
    sub_layer_level_idc: List[int] = field(default_factory=list)
    num_sub_profile: int = 0


@dataclass
class VUI:
    """VUI parameters (H.266 7.3.4.2; vvenc VLCWriter codeVUI:576)."""
    progressive_source: int = 1
    interlaced_source: int = 0
    non_packed: int = 0
    non_projected: int = 0
    aspect_ratio_info_present: int = 0
    aspect_ratio_constant: int = 1
    aspect_ratio_idc: int = 0
    sar_width: int = 0
    sar_height: int = 0
    overscan_info_present: int = 0
    overscan_appropriate: int = 0
    colour_description_present: int = 0
    colour_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coefficients: int = 2
    video_full_range: int = 0
    chroma_loc_info_present: int = 0
    chroma_sample_loc_type: int = 0
    chroma_sample_loc_type_top: int = 0
    chroma_sample_loc_type_bottom: int = 0


# VVC level limits (H.266 Table A.1/A.2; vvenc ProfileLevelTier.cpp:30-60):
# level_idc -> (MaxLumaPs, MaxLumaSr) for the Main tier
LEVEL_LIMITS = (
    (16, 36864, 552960),          # 1.0
    (32, 122880, 3686400),        # 2.0
    (35, 245760, 7372800),        # 2.1
    (48, 552960, 16588800),       # 3.0
    (51, 983040, 33177600),       # 3.1
    (64, 2228224, 66846720),      # 4.0
    (67, 2228224, 133693440),     # 4.1
    (80, 8912896, 267386880),     # 5.0
    (83, 8912896, 534773760),     # 5.1
    (86, 8912896, 1069547520),    # 5.2
    (96, 35651584, 1069547520),   # 6.0
    (99, 35651584, 2139095040),   # 6.1
    (102, 35651584, 4278190080),  # 6.2
    (105, 142606336, 4812963840),  # 6.3
)


def detect_level(width: int, height: int, fps: float) -> int:
    """Smallest level whose luma picture size and sample rate fit
    (vvenc LevelTierFeatures::getLevelTierFeatures / level auto-detection,
    ProfileLevelTier.cpp:237)."""
    luma_ps = width * height
    luma_sr = luma_ps * max(1.0, fps)
    for idc, max_ps, max_sr in LEVEL_LIMITS:
        if luma_ps <= max_ps and luma_sr <= max_sr:
            return idc
    return 255  # level 15.5 (unconstrained)


@dataclass
class RefPicList:
    """One candidate reference picture list (H.266 7.3.10 ref_pic_list_struct).

    delta_poc values are stored directly (positive = past picture,
    matching the refPicIdentifier convention of the reference encoder).
    """
    num_short_term: int = 0
    num_long_term: int = 0
    delta_pocs: List[int] = field(default_factory=list)   # signed, cumulative identifiers
    ltrp_in_slice_header: int = 0

    @property
    def num_refs(self) -> int:
        return self.num_short_term + self.num_long_term


@dataclass
class GeneralHrd:
    num_units_in_tick: int = 1
    time_scale: int = 27000000
    nal_hrd_present: int = 0
    vcl_hrd_present: int = 0
    same_pic_timing_in_all_ols: int = 1
    du_hrd_present: int = 0
    bit_rate_scale: int = 0
    cpb_size_scale: int = 0
    cpb_cnt_minus1: int = 0


@dataclass
class OlsHrd:
    fixed_pic_rate_general: int = 1
    fixed_pic_rate_within_cvs: int = 1
    element_duration_in_tc_minus1: int = 0
    low_delay_hrd: int = 0
    # [cpb][nal_or_vcl] -> (bit_rate_minus1, cpb_size_minus1, cbr)
    cpb_entries: List[list] = field(default_factory=list)


@dataclass
class SPS:
    sps_id: int = 0
    vps_id: int = 0
    max_tlayers: int = 1
    chroma_format_idc: int = 1        # 4:2:0
    ctu_size_log2: int = 6            # 64
    ptl_dpb_hrd_params_present: int = 1
    ptl: ProfileTierLevel = field(default_factory=ProfileTierLevel)
    gdr_enabled: int = 0
    rpr_enabled: int = 0
    res_change_in_clvs: int = 0
    max_width: int = 0
    max_height: int = 0
    conf_win: tuple = (0, 0, 0, 0)    # left, right, top, bottom (luma samples)
    bit_depth: int = 10
    entropy_coding_sync: int = 0
    entry_points_present: int = 0
    log2_max_poc_lsb: int = 8
    poc_msb_flag: int = 0
    poc_msb_len: int = 1
    sublayer_dpb_params: int = 0
    max_dec_pic_buffering: List[int] = field(default_factory=lambda: [2])
    num_reorder_pics: List[int] = field(default_factory=lambda: [0])
    max_latency_increase: List[int] = field(default_factory=lambda: [0])
    log2_min_cb_size: int = 2
    partition_override: int = 0
    # [0]=intra luma, [1]=inter, [2]=intra chroma (dual tree)
    min_qt_size: List[int] = field(default_factory=lambda: [8, 8, 4])
    max_mtt_depth: List[int] = field(default_factory=lambda: [0, 0, 0])
    max_bt_size: List[int] = field(default_factory=lambda: [32, 128, 64])
    max_tt_size: List[int] = field(default_factory=lambda: [32, 64, 32])
    dual_i_tree: int = 0
    log2_max_tb_size: int = 6
    transform_skip: int = 0
    log2_max_ts_size: int = 2
    bdpcm: int = 0
    mts: int = 0
    mts_intra: int = 0
    mts_inter: int = 0
    lfnst: int = 0
    joint_cbcr: int = 0
    same_qp_table_for_chroma: int = 1
    # chroma QP mapping table(s): list of (start_minus26, [in_deltas_minus1], [out_deltas])
    chroma_qp_tables: List[tuple] = field(default_factory=lambda: [
        (17 - 26, [16, 4, 11, 7], [16, 5, 11, 3])])
    sao_enabled: int = 0
    alf_enabled: int = 0
    ccalf_enabled: int = 0
    lmcs_enabled: int = 0
    weighted_pred: int = 0
    weighted_bipred: int = 0
    long_term_refs: int = 0
    idr_rpl_present: int = 0
    rpl1_copy_from_rpl0: int = 1
    rpl_lists: List[List[RefPicList]] = field(default_factory=lambda: [[], []])
    wraparound: int = 0
    temporal_mvp: int = 0
    sbtmvp: int = 0
    amvr: int = 0
    bdof: int = 0
    bdof_present: int = 0
    smvd: int = 0
    dmvr: int = 0
    dmvr_present: int = 0
    mmvd: int = 0
    fpel_mmvd: int = 0
    max_num_merge_cand: int = 6
    sbt: int = 0
    affine: int = 0
    max_num_affine_merge_cand: int = 5
    affine_type: int = 0
    affine_amvr: int = 0
    prof: int = 0
    prof_present: int = 0
    bcw: int = 0
    ciip: int = 0
    geo: int = 0
    max_num_geo_cand: int = 0
    log2_parallel_merge_minus2: int = 0
    isp: int = 0
    mrl: int = 0
    mip: int = 0
    cclm: int = 0
    hor_collocated_chroma: int = 1
    ver_collocated_chroma: int = 0
    plt: int = 0
    act: int = 0
    internal_minus_input_bit_depth: int = 0
    ibc: int = 0
    max_num_ibc_merge_cand: int = 6
    ladf: int = 0
    scaling_list_enabled: int = 0
    dep_quant_enabled: int = 0
    sign_data_hiding: int = 0
    virtual_boundaries: int = 0
    timing_hrd_present: int = 0
    general_hrd: GeneralHrd = field(default_factory=GeneralHrd)
    sublayer_cpb_params: int = 0
    ols_hrd: List[OlsHrd] = field(default_factory=list)
    field_seq: int = 0
    vui_present: int = 0
    vui: "VUI" = None

    @property
    def ctu_size(self) -> int:
        return 1 << self.ctu_size_log2

    @property
    def max_tb_size(self) -> int:
        return 1 << self.log2_max_tb_size

    def num_rpl(self, list_idx: int) -> int:
        return len(self.rpl_lists[list_idx])


@dataclass
class PPS:
    pps_id: int = 0
    sps_id: int = 0
    mixed_nalu_types: int = 0
    pic_width: int = 0
    pic_height: int = 0
    conf_win: tuple = (0, 0, 0, 0)
    conf_window_explicit: int = 0     # pps conf window flag when size < sps max
    scaling_window: int = 0
    output_flag_present: int = 0
    no_pic_partition: int = 1
    subpic_id_mapping: int = 0
    # tiles (only when no_pic_partition == 0)
    log2_ctu_size: int = 6
    tile_col_widths: List[int] = field(default_factory=list)   # in CTUs
    tile_row_heights: List[int] = field(default_factory=list)
    loop_filter_across_tiles: int = 1
    rect_slice: int = 1
    single_slice_per_subpic: int = 1
    num_slices: int = 1
    loop_filter_across_slices: int = 0
    cabac_init_present: int = 0
    num_ref_idx_default: tuple = (1, 1)
    rpl1_idx_present: int = 0
    weighted_pred: int = 0
    weighted_bipred: int = 0
    wraparound: int = 0
    init_qp: int = 32                 # pps_init_qp_minus26 + 26
    cu_qp_delta_enabled: int = 0
    chroma_tool_offsets_present: int = 1
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    joint_cbcr_qp_offset_present: int = 0
    joint_cbcr_qp_offset: int = 0
    slice_chroma_qp_flag: int = 0
    chroma_qp_offset_list: List[tuple] = field(default_factory=list)
    deblocking_filter_control_present: int = 1
    deblocking_filter_override_enabled: int = 0
    deblocking_filter_disabled: int = 0
    dbf_info_in_ph: int = 0
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    cb_beta_offset_div2: int = 0
    cb_tc_offset_div2: int = 0
    cr_beta_offset_div2: int = 0
    cr_tc_offset_div2: int = 0
    rpl_info_in_ph: int = 0
    sao_info_in_ph: int = 0
    alf_info_in_ph: int = 0
    wp_info_in_ph: int = 0
    qp_delta_info_in_ph: int = 0
    picture_header_extension: int = 0
    slice_header_extension: int = 0


@dataclass
class PictureHeader:
    gdr_or_irap: int = 1
    non_ref_pic: int = 0
    gdr_pic: int = 0
    inter_slice_allowed: int = 0
    intra_slice_allowed: int = 1
    pps_id: int = 0
    poc_lsb: int = 0
    recovery_poc_cnt: int = 0
    # per-picture QTBTT constraint overrides: {set_idx: (minQT, mttDepth,
    # maxBT, maxTT)} (ph_partition_constraints_override)
    partition_override: Optional[dict] = None
    # partition overrides / dqp subdiv omitted (not used round 1)
    cu_qp_delta_subdiv_intra: int = 0
    cu_qp_delta_subdiv_inter: int = 0
    lmcs_enabled: int = 0
    lmcs_aps_id: int = 0
    chroma_residual_scale: int = 0
    enable_tmvp: int = 0
    pic_col_from_l0: int = 1
    col_ref_idx: int = 0
    mvd_l1_zero: int = 0
    qp_delta: int = 0
    joint_cbcr_sign: int = 0
    dis_bdof: int = 0
    dis_dmvr: int = 0
    dis_prof: int = 0
    sao_luma: int = 0
    sao_chroma: int = 0
    # explicit RPLs in PH (when pps.rpl_info_in_ph)
    rpl_idx: List[int] = field(default_factory=lambda: [-1, -1])
    rpls: List[RefPicList] = field(default_factory=lambda: [RefPicList(), RefPicList()])


@dataclass
class SliceHeader:
    picture_header_in_slice_header: int = 1
    ph: PictureHeader = field(default_factory=PictureHeader)
    slice_type: int = 2               # 0=B, 1=P, 2=I (H.266 Table 9)
    no_output_of_prior_pics: int = 0
    # RPL signalling (when not in PH and not IDR-without-rpl)
    rpl_idx: List[int] = field(default_factory=lambda: [-1, -1])
    rpls: List[RefPicList] = field(default_factory=lambda: [RefPicList(), RefPicList()])
    num_ref_idx: List[int] = field(default_factory=lambda: [0, 0])
    cabac_init_flag: int = 0
    lmcs_enabled: int = 0             # sh_lmcs_used_flag
    col_from_l0: int = 1
    col_ref_idx: int = 0
    slice_qp: int = 32
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    sao_luma: int = 0
    sao_chroma: int = 0
    deblocking_filter_override: int = 0
    deblocking_filter_disable: int = 0
    dep_quant_used: int = 0
    sign_data_hiding_used: int = 0
    ts_residual_coding_disabled: int = 0
    # ALF (sh_alf_*; vvenc VLCWriter.cpp:1769-1809)
    alf_enabled: List[int] = field(default_factory=lambda: [0, 0, 0])
    num_alf_aps: int = 0
    luma_aps_ids: List[int] = field(default_factory=list)
    chroma_aps_id: int = 0
    entry_point_offsets: List[int] = field(default_factory=list)
    cc_alf_enabled: List[int] = field(default_factory=lambda: [0, 0])
    cc_alf_aps_ids: List[int] = field(default_factory=lambda: [0, 0])

    @property
    def is_intra(self) -> bool:
        return self.slice_type == 2


SLICE_B, SLICE_P, SLICE_I = 0, 1, 2

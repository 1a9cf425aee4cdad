"""All-intra encoder: QT partition RD search + CABAC emission.

Decision structure (reference analog: vvenc EncCu::xCompressCU recursion,
EncCu.cpp:717, and IntraSearch mode lists, IntraSearch.cpp): depth-first QT
search comparing no-split vs split RD cost; per CU an SATD preselection over
all intra modes followed by full RD (transform/quant/bit-estimate/SSE) of
the best few candidates.  Bits are tracked with the fractional-bit estimator
seeded from the live CABAC context state so costs reflect the real stream.

The final bitstream is produced by replaying the decided trees through
SyntaxCoder with the real arithmetic coder.
"""

from __future__ import annotations

import os

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..bitstream.bitwriter import BitWriter
from ..bitstream.cabac import CabacEncoder, BitEstimator, CtxModels
from ..bitstream.nal import NalUnitType, make_nal_unit
from ..bitstream import hls
from ..bitstream.params import SPS, PPS, SliceHeader, PictureHeader
from ..codec.ctu_syntax import (SyntaxCoder, TreeNode, CuData, DM_CHROMA,
                                PartInfo, NO_SPLIT, QT_SPLIT,
                                TREE_L, CHROMA_TREE,
                                get_intra_mpms, split_options_full,
                                split_geometry, write_split_mode,
                                implicit_split,
                                predict_cu_component, reconstruct_cu)
from ..codec.motion import get_merge_candidates, get_amvp_candidates
from ..codec.ctu_syntax import inter_predict
from .gop import build_gop
from ..ops.interp import mc_block_np
from ..bitstream.params import RefPicList, SLICE_B, SLICE_P, SLICE_I
from ..bitstream import ctx_tables as ct
from ..bitstream.residual import encode_residual
from ..codec.picture import PictureState
from ..codec.qp import QpState
from ..ops import intra as I
from ..ops import intra_vec as IV
from ..utils.profiler import PROF
from ..utils.searchspace import bump as _ss_bump
from ..ops import transforms as T
from ..ops import rdcost as R


@dataclass
class EncoderConfig:
    width: int = 416
    height: int = 240
    qp: int = 37
    intra_qp_offset: int = -3      # vvenc default for intra slices
    ctu_size: int = 32
    min_qt: int = 8
    dual_tree: bool = False        # separate luma/chroma trees in I slices
    bit_depth: int = 10
    input_bit_depth: int = 8
    fps_num: int = 15
    fps_den: int = 1
    num_full_rd_modes: int = 3     # full-RD candidates after SATD preselection
    num_chroma_rd_modes: int = 0   # chroma full-RD modes (0 = all)
    drap_period: int = 0           # dependent-RAP period (frames; 0 off)
    lead_frames: int = 0           # segment mode: MCTF-only context
    trail_frames: int = 0          # frames around the coded range
    start_offset: int = 0          # global index of the first CODED frame
                                   # (CLI --skip): keeps the MCTF filter
                                   # period phase aligned with the
                                   # one-shot encode for any skip value
    device: str = "cuda"           # where the device kernels run: "cuda"
                                   # (raises without a card) or "cpu"
                                   # (their plain PyTorch versions)
    device_rd: str = "auto"        # device-batched RD planning (the GPU
                                   # decides the coding tree; the native
                                   # driver codes it exactly): on/off/
                                   # auto = on when device is "cuda"
    me_mode: str = "auto"          # integer-ME coarse stage: "device" =
                                   # frame-level batched full search on
                                   # the card (ops/me.py frame_me),
                                   # "host" = numpy hierarchical grids;
                                   # auto = host
    alf_nonlinear: bool = False    # clipped ALF derivation (slower preset)
    mode_cache: bool = True        # EncModeCtrl save/load: reuse an area's
                                   # winning intra modes across partitioning
                                   # paths (skips the 67-mode re-sweep)
    deblocking: bool = False       # in-loop deblocking filter
    intra_period: int = 1          # 1 = all-intra; N>1 = IDR every N, P between
    gop_size: int = 1              # >1: hierarchical-B random access GOPs
    decoding_refresh_type: str = "idr"  # vvenc DecodingRefreshType: "idr"
                                   # = an IDR segment every intra period;
                                   # "cra" = one GOP hierarchy whose intra
                                   # period pictures are CRAs, the
                                   # pictures before each RASL
    num_refs: int = 2              # active references per list (GOPCfg
                                   # numRefPicsActive analog; dyadic lists
                                   # support up to 4 past / 2 future)
    search_range: int = 64         # integer ME range around the predictors
                                   # (hierarchical: 1/4-res coarse grid over
                                   # the full range + full-res refine)
    tmvp: bool = True              # temporal MVP (collocated-picture MVs)
    bdof: bool = False             # bi-directional optical flow
    dmvr: bool = False             # decoder-side MV refinement
    mmvd: bool = False             # merge with MVD
    smvd: bool = False             # symmetric MVD (B slices)
    bcw: bool = False              # bi-prediction with CU weights
    ciip: bool = False             # combined inter/intra prediction
    amvr: bool = False             # adaptive MV resolution (IMV)
    geo: bool = False              # geometric partitioning merge
    sbtmvp: bool = False           # subblock temporal MVP merge
    affine: bool = False           # affine motion (merge candidates)
    prof: bool = False             # prediction refinement w/ optical flow
    sbt: bool = False              # sub-block transform for inter residual
    max_mtt_depth: int = 0         # BT/TT depth for intra slices
    max_bt_size: int = 32
    max_tt_size: int = 32
    rdoq: bool = True              # rate-distortion optimized quantization
    dep_quant: bool = False        # trellis (dependent) quantization
    sign_data_hiding: bool = False # SDH (excludes dep_quant)
    qpa: bool = False              # perceptual QP adaptation (XPSNR model)
    cclm: bool = False             # cross-component linear model chroma
    jccr: bool = False             # joint Cb-Cr residual coding
    isp: bool = False              # intra sub-partitions
    transform_skip: bool = False   # transform skip (SCC)
    bdpcm: bool = False            # block DPCM (SCC)
    ibc: bool = False              # intra block copy (SCC)
    scc_auto: bool = False         # auto-enable SCC tools on detection
    mip: bool = False              # matrix intra prediction
    mrl: bool = False              # multi-reference-line intra
    lfnst: bool = False            # low-frequency non-separable transform
    mts: bool = False              # explicit intra MTS (DST7/DCT8)
    mts_implicit: bool = False     # implicit MTS (DST7 on small intra TBs)
    lmcs: int = 0                  # luma mapping w/ chroma scaling (LMCS)
    lmcs_update_ctrl: int = 0      # model update: 0 RA, 1 AI, 2 LDB/LDP
    lmcs_offset: int = 6           # chroma residual scaling offset
                                   # (vvenc preset baseline, vvencCfg:2601)
    sao: bool = False              # sample adaptive offset (encoder RD)
    alf: bool = False              # adaptive loop filter (encoder-derived)
    ccalf: bool = False            # cross-component ALF (needs alf)
    mctf: bool = False             # motion-compensated temporal filtering
    bim: bool = False              # block importance mapping (MCTF-based
                                   # per-CTU QP offsets + noise tracking)
    wpp: bool = False              # WPP: per-CTU-row substreams + entry
    wpp_search_workers: int = 0    # wavefront CTU-search threads
                                   # (0 = auto, -1 = serial search)
                                   # points (entropy_coding_sync)
    tile_cols: int = 1             # tile columns (spatial sharding axis)
    tile_rows: int = 1             # tile rows
    parallel_gops: int = 0         # GOP/segment-parallel encode workers
                                   # (segments split at the intra period)
    max_parallel_frames: int = 0   # frame-parallel all-intra encode
    ifp: bool = False              # inter-frame parallelism w/ CTU-line
                                   # sync (vvenc --ifp: restricted ME,
                                   # worker-count-independent bitstream)
    ifp_lines: int = 2             # reference row lead (vvenc m_ifpLines)
    picture_hash: int = 0          # decoded-picture-hash SEI: 0 off,
                                   # 1 MD5, 2 CRC, 3 checksum
    hrd_timing_sei: bool = False   # buffering-period + pic-timing SEIs
    film_grain: bool = False       # film grain analysis -> FGC SEI
    bitrate: int = 0               # target bps (0 = fixed QP)
    max_bitrate: int = 0           # rate cap in bps (0 = uncapped)
    lookahead: bool = True         # RC lookahead pre-analysis (vvenc
                                   # m_LookAhead; single-pass ABR only)
    rc_stats_in: str = ""          # two-pass: pass-1 stats file to read
    rc_stats_out: str = ""         # pass-1: stats file to write
                                   # ("collect:" = in-memory, parent merges)
    rc_stats_data: Optional[list] = None  # two-pass: stats records passed
                                   # directly (segment workers)
    intra_presel: str = "auto"     # "exact": per-CU 67-mode sweep on true
                                   # refs; "source": frame-level batched
                                   # device preselection (source refs);
                                   # "auto": see resolve_intra_presel


def build_parameter_sets(cfg: EncoderConfig):
    sps = SPS()
    sps.max_width = cfg.width
    sps.max_height = cfg.height
    sps.bit_depth = cfg.bit_depth
    sps.ctu_size_log2 = cfg.ctu_size.bit_length() - 1
    sps.min_qt_size = [cfg.min_qt, cfg.min_qt, cfg.min_qt]
    sps.max_mtt_depth = [cfg.max_mtt_depth, cfg.max_mtt_depth,
                         cfg.max_mtt_depth]
    sps.max_bt_size = [cfg.max_bt_size, cfg.ctu_size, cfg.max_bt_size]
    sps.max_tt_size = [cfg.max_tt_size, cfg.ctu_size, cfg.max_tt_size]
    # keep min CB at 8 when MTT is on: chroma stays >= 4x4, so the
    # local-dual-tree machinery (spec modeTypeCondition) never triggers
    sps.log2_min_cb_size = 3 if cfg.max_mtt_depth else 2
    if cfg.ctu_size >= 128:
        # CTU 128: intra CUs are capped at 64 (no 128 intra pred/TB), so
        # I-slices need the dual tree's implicit 64-unit QT — exactly why
        # the reference keeps m_dualITree on in every preset
        cfg.dual_tree = True
    if cfg.dual_tree:
        # dual-tree intra: chroma-tree constraint set (index 2); the
        # reference emits chroma minQT = luma/2 (vvencCfg m_MinQT[2]),
        # floored at the min CB size
        sps.dual_i_tree = 1
        sps.min_qt_size[2] = max(1 << sps.log2_min_cb_size,
                                 cfg.min_qt >> 1)
    sps.log2_max_tb_size = min(6, sps.ctu_size_log2)
    # level auto-detection from size + rate (ProfileLevelTier.cpp:237)
    from ..bitstream.params import detect_level, VUI
    sps.ptl.level_idc = detect_level(cfg.width, cfg.height,
                                     cfg.fps_num / max(1, cfg.fps_den))
    # VUI: signal progressive source + SDR colour description
    sps.vui_present = 1
    sps.vui = VUI(progressive_source=1, colour_description_present=1,
                  colour_primaries=1, transfer_characteristics=1,
                  matrix_coefficients=1)
    # DPB parameters derived from the GOP structure (GOPCfg getMaxDpbSize
    # analog, simulated rather than tabled — encoder/gop.py)
    from .gop import derive_dpb_params
    mdpb, reorder = derive_dpb_params(
        cfg.gop_size if cfg.intra_period != 1 else 1, cfg.num_refs)
    sps.max_dec_pic_buffering = [mdpb]
    sps.num_reorder_pics = [reorder]
    sps.max_latency_increase = [0]
    sps.rpl_lists = [[], []]
    pps = PPS()
    pps.pic_width = cfg.width
    pps.pic_height = cfg.height
    pps.init_qp = 26
    pps.deblocking_filter_control_present = 1
    pps.deblocking_filter_disabled = 0 if cfg.deblocking else 1
    sps.dep_quant_enabled = 1 if cfg.dep_quant else 0
    sps.sign_data_hiding = 1 if (cfg.sign_data_hiding
                                 and not cfg.dep_quant) else 0
    sps.mip = 1 if cfg.mip else 0
    sps.cclm = 1 if cfg.cclm else 0
    sps.joint_cbcr = 1 if cfg.jccr else 0
    sps.isp = 1 if cfg.isp else 0
    sps.transform_skip = 1 if cfg.transform_skip else 0
    if cfg.transform_skip:
        sps.log2_max_ts_size = 5  # allow TS up to 32x32
    sps.bdpcm = 1 if (cfg.bdpcm and cfg.transform_skip) else 0
    sps.ibc = 1 if cfg.ibc else 0
    sps.internal_minus_input_bit_depth = cfg.bit_depth - cfg.input_bit_depth
    sps.mrl = 1 if cfg.mrl else 0
    sps.lfnst = 1 if cfg.lfnst else 0
    if cfg.mts:
        sps.mts = 1
        sps.mts_intra = 1
    elif cfg.mts_implicit:
        sps.mts = 1  # implicit MTS: DST-7 on 4..16 intra luma dims
    sps.alf_enabled = 1 if cfg.alf else 0
    sps.ccalf_enabled = 1 if (cfg.ccalf and cfg.alf) else 0
    sps.sao_enabled = 1 if cfg.sao else 0
    sps.lmcs_enabled = 1 if cfg.lmcs else 0
    sps.temporal_mvp = 1 if cfg.tmvp else 0
    if cfg.wpp:
        sps.entropy_coding_sync = 1
        sps.entry_points_present = 1
    if cfg.tile_cols > 1 or cfg.tile_rows > 1:
        assert not cfg.wpp, "tiles+WPP combination TBD"
        ctus_w = (cfg.width + cfg.ctu_size - 1) // cfg.ctu_size
        ctus_h = (cfg.height + cfg.ctu_size - 1) // cfg.ctu_size
        nc = max(1, min(cfg.tile_cols, ctus_w))
        nr = max(1, min(cfg.tile_rows, ctus_h))

        def split(total, n):
            base, rem = divmod(total, n)
            return [base + (1 if i < rem else 0) for i in range(n)]
        pps.no_pic_partition = 0
        pps.log2_ctu_size = cfg.ctu_size.bit_length() - 1
        pps.tile_col_widths = split(ctus_w, nc)
        pps.tile_row_heights = split(ctus_h, nr)
        pps.loop_filter_across_tiles = 1
        pps.loop_filter_across_slices = 1
        sps.entry_points_present = 1
    if cfg.bdof:
        sps.bdof = sps.bdof_present = 1
    if cfg.dmvr:
        sps.dmvr = sps.dmvr_present = 1
    sps.mmvd = 1 if cfg.mmvd else 0
    sps.smvd = 1 if cfg.smvd else 0
    sps.bcw = 1 if cfg.bcw else 0
    sps.ciip = 1 if cfg.ciip else 0
    sps.amvr = 1 if cfg.amvr else 0
    sps.sbt = 1 if cfg.sbt else 0
    if cfg.sbtmvp and cfg.tmvp:
        sps.sbtmvp = 1
    if cfg.affine:
        sps.affine = 1
        sps.affine_type = 1
        sps.prof = 1 if cfg.prof else 0
    if cfg.geo:
        sps.geo = 1
        sps.max_num_geo_cand = 3
    # cu_qp_delta only when a per-CTU QP source can actually fire: QPA,
    # or BIM (which needs the MCTF stage, i.e. gop_size > 1).  Leaving
    # it on for all-intra/BIM-less configs wasted syntax and blocked the
    # native CTU search driver (its scope excludes DQP).
    bim_active = cfg.bim and cfg.mctf and cfg.gop_size > 1
    if cfg.qpa or bim_active:
        pps.cu_qp_delta_enabled = 1
        pps.slice_chroma_qp_flag = 1
    return sps, pps


class _SliceWriter:
    """Slice-data writer with optional WPP substreams.

    Non-WPP: one CABAC stream.  WPP (entropy_coding_sync): one byte-aligned
    substream per CTU row, contexts synced from after the first CTU of the
    row above (H.266 9.3.1 storage/synchronization process); finish()
    returns (payload, entry_point_offsets)."""

    def __init__(self, slice_qp: int, init_id: int, wpp: bool):
        self.wpp = wpp
        self.slice_qp = slice_qp
        self.init_id = init_id
        self.subs = []
        self.bw = BitWriter()
        self.enc = CabacEncoder(self.bw)
        self.enc.init_ctx(slice_qp, init_id)
        self.sync_ctx = None

    def new_row(self, row: int) -> None:
        if not self.wpp or row == 0:
            return
        # end_of_subset_one_bit + flush + byte alignment, then a fresh
        # arithmetic engine seeded with the synced contexts
        self.enc.encode_bin_trm(1)
        self.enc.finish()
        self.bw.write_rbsp_trailing_bits()
        self.subs.append(self.bw.get_bytes())
        self.bw = BitWriter()
        self.enc = CabacEncoder(self.bw, ctx=CtxModels(self.sync_ctx))

    def new_tile(self, tile_idx: int) -> None:
        """Tile boundary: end_of_tile_one_bit + byte alignment, then a
        fresh CABAC engine with re-initialized contexts (H.266 9.3.1)."""
        if tile_idx == 0:
            return
        self.enc.encode_bin_trm(1)
        self.enc.finish()
        self.bw.write_rbsp_trailing_bits()
        self.subs.append(self.bw.get_bytes())
        self.bw = BitWriter()
        self.enc = CabacEncoder(self.bw)
        self.enc.init_ctx(self.slice_qp, self.init_id)

    def after_first_ctu(self) -> None:
        if self.wpp:
            self.sync_ctx = CtxModels(self.enc.ctx)

    def finish(self):
        self.enc.encode_bin_trm(1)
        self.enc.finish()
        self.bw.write_rbsp_trailing_bits()
        self.subs.append(self.bw.get_bytes())
        payload = b"".join(self.subs)
        return payload, [len(s) for s in self.subs[:-1]]


def lambda_for_qp(qp: int, bit_depth: int) -> float:
    """RD lambda (SSE domain at internal bit depth)."""
    return 0.57 * (2.0 ** ((qp - 12) / 3.0)) * (1 << (2 * (bit_depth - 8)))


def resolve_intra_presel(cfg) -> str:
    """What intra_presel="auto" resolves to: "source" (the frame-level
    device preselection) for all-intra streams of >= 832x480 on the
    card, where the per-frame batch amortizes the launches and the fetch
    (sparse RA I-slices cannot), else "exact" (the per-CU host sweep).
    On device "cpu" it resolves as the JAX package does on its CPU
    backend."""
    big = cfg.width * cfg.height >= 832 * 480
    return "source" if (big and cfg.intra_period == 1
                        and cfg.device == "cuda") else "exact"


from .sequence import SequenceOrchestratorMixin


class IntraEncoder(SequenceOrchestratorMixin):
    """Encodes frames as all-intra IDR pictures (round-1 configuration)."""

    def __init__(self, cfg: EncoderConfig):
        from ..device import resolve_device
        self.device = resolve_device(cfg.device)
        if cfg.device == "cuda" and cfg.device_rd == "on":
            from .. import native
            if not native.available():
                from .sequence import native_missing
                raise native_missing()
        self.cfg = cfg
        self.sps, self.pps = build_parameter_sets(cfg)
        self.slice_qp = max(0, min(63, cfg.qp + cfg.intra_qp_offset))
        self.lmbda = lambda_for_qp(self.slice_qp, cfg.bit_depth)
        self.lmbda_sad = self.lmbda ** 0.5
        self._headers = None
        self.frames_done = 0
        self.dpb = []
        self.dpb_protect = set()
        self._drap_floor = 0       # POC of the last DRAP picture
        self.recs_by_poc = {}
        self.bits_by_poc = {}
        self.slice_type_by_poc = {}
        self.qp_by_poc = {}
        self._orig_by_poc = {}         # display-order originals for QPA
        self._plan_bank = {}           # poc -> device RD plan tables
                                       # (frame-batched prefill)
        self._force_idr_pocs = set()   # scene cuts (PreProcess STA)
        self.analysis = None           # per-frame PreProcess results
        self.scc_detected = False
        self.rc = None
        # test/debug hook: restrict the inter mode competition (forces a
        # specific tool's coded path; None = full competition)
        self.trial_filter = None
        # sequence-shared minimum noise levels (PicShared m_minNoiseLevels)
        from .qpa import new_min_noise_levels
        self.min_noise = new_min_noise_levels()
        self._bim_map = {}
        if cfg.bitrate > 0 or cfg.rc_stats_out:
            from .ratectrl import RateCtrl
            stats = cfg.rc_stats_data if cfg.rc_stats_data is not None \
                else (RateCtrl.read_stats(cfg.rc_stats_in)
                      if cfg.rc_stats_in else None)
            self.rc = RateCtrl(cfg.bitrate, cfg.fps_num / cfg.fps_den,
                               cfg.qp, cfg.gop_size, stats,
                               max_bps=cfg.max_bitrate)
        self.lmcs = None
        if cfg.lmcs:
            from .lmcs_enc import LmcsEncoder
            fps = (cfg.fps_num + cfg.fps_den - 1) // cfg.fps_den
            self.lmcs = LmcsEncoder(
                cfg.bit_depth, cfg.qp, cfg.width * cfg.height,
                update_ctrl=cfg.lmcs_update_ctrl, crs_offset=cfg.lmcs_offset,
                fps_to_ip=max(16, 16 * int(round(fps / 16.0))))

    # ------------------------------------------------------------------
    def headers(self) -> bytes:
        if self._headers is None:
            bw = BitWriter()
            hls.write_sps(bw, self.sps)
            sps_nal = make_nal_unit(NalUnitType.SPS, bw.get_bytes())
            bw = BitWriter()
            hls.write_pps(bw, self.pps, self.sps)
            pps_nal = make_nal_unit(NalUnitType.PPS, bw.get_bytes())
            self._headers = sps_nal + pps_nal
        return self._headers


    def _trim_dpb(self) -> None:
        """Bound the DPB, evicting oldest-first but never a picture that a
        not-yet-coded GOP entry still references (vvenc keeps such
        pictures via the full RPL lists; here the protection set computed
        by _protect_refs plays that role)."""
        while len(self.dpb) > 16:
            for i, d in enumerate(self.dpb):
                if d[0] not in self.dpb_protect:
                    self.dpb.pop(i)
                    break
            else:
                break

    def _protect_refs(self, entries, base: int, gop: int) -> None:
        """Mark every POC the current and next GOP will reference."""
        need = set()
        for e in entries:
            for r in list(e.refs_past) + list(e.refs_future):
                need.add(base + r)
                need.add(base + gop + r)
        if self.cfg.drap_period > 0:
            # DRAP pictures reference the associated IRAP (POC 0) and
            # trailing pictures may reference the most recent DRAP; keep
            # both alive permanently (the reference retains the
            # associated IRAP for m_drapPeriod via its RPL tables) —
            # they also land in the keep-alive inactive RPL entries so a
            # spec decoder's DPB marking retains them
            need.add(0)
            need.add(self._drap_floor)
        self.dpb_protect = {p for p in need if p >= 0}

    def encode_frame(self, planes8) -> bytes:
        """Encode one frame (display order == coding order modes: all-intra
        or IPPP) -> Annex-B AU bytes (headers prepended on first frame)."""
        poc = self.frames_done
        cfg = self.cfg
        # intra_period semantics follow vvenc: 1 = all-intra, 0/-1 = only
        # the first picture is intra, N>1 = IDR every N pictures
        if cfg.intra_period == 1:
            is_idr = True
        elif cfg.intra_period <= 0:
            is_idr = poc == 0
        else:
            is_idr = (poc % cfg.intra_period == 0)
        is_idr = is_idr or poc in self._force_idr_pocs
        if is_idr:
            au = self._encode_picture(poc, planes8, SLICE_I, [], [])
        else:
            au = self._encode_picture(poc, planes8, SLICE_P,
                                      [self.dpb[-1][0]], [])
        return au


    def _wavefront_search(self, searcher, scan, qpa_res, n_cols, n_rows,
                          slice_qp, init_id, workers):
        """Phase-1 WPP wavefront search (vvenc EncSlice WPP threading
        analog): every CTU's native search runs as a dependency-ordered
        task — (r, c) after (r, c-1) and (r-1, c+1) — with row-chained
        CABAC-estimator contexts seeded per the H.266 entropy-sync
        storage process (after the first CTU of the row above), row-local
        HMVP and dqp chains, and per-CTU QPA lambdas.  The estimator's
        context transitions equal the real arithmetic coder's, so the
        chained states match what the serial replay produces.  Commits
        recon + marks natively; on return the attribute maps and motion
        arrays are restored so the serial replay re-marks them
        progressively.  Deterministic for any worker count (pure
        dependencies).  Returns {ctu_addr: TreeNode}."""
        import threading
        from collections import deque
        from .. import native
        from ..bitstream.cabac import CabacEncoder, CtxModels
        from ..bitstream.bitwriter import BitWriter
        cfg = self.cfg
        ps = searcher.ps
        coder = searcher.coder
        qp_state = searcher.qp
        ctu = cfg.ctu_size

        # snapshot the attribute maps + motion arrays (phase 2 replays
        # them progressively from the pre-picture state)
        maps = [ps.coded_luma, ps.intra_mode, ps.is_intra, ps.is_mip,
                ps.cu_w, ps.cu_h, ps.qt_depth, ps.qp_map,
                ps.coded_chroma, ps.ccu_w, ps.ccu_h, ps.cqt_depth]
        snap_maps = [m.copy() for m in maps]
        mf_arrays = []
        if not coder.is_intra_slice:
            mf = coder.mf
            mf_arrays = [mf.valid, mf.mv, mf.ref, mf.bcw, mf.alt,
                         mf.skipf, mf.isaff, mf.aff_valid, mf.aff_data]
        snap_mf = [a.copy() for a in mf_arrays]

        # per-CTU QP tuples (QPA varies the CTU QP; derive each distinct
        # QP's luma/chroma/joint values once, single-threaded)
        saved_q = coder.cur_qp
        qp_of = {}

        def qp_tuple(q):
            t = qp_of.get(q)
            if t is None:
                qp_state.set_cu_qp(q)
                t = (qp_state.luma_qp(), qp_state.chroma_qp(1),
                     qp_state.chroma_qp(2), qp_state.qp_y,
                     qp_state.joint_qp())
                qp_of[q] = t
            return t

        tasks = {}
        for _, cx, cy, _rs in scan:
            addr = cy * n_cols + cx
            if qpa_res is not None:
                q = int(qpa_res.ctu_qps[addr])
                lmb = float(qpa_res.ctu_lambdas[addr])
            else:
                q = coder.cur_qp
                lmb = searcher.lmbda
            tasks[(cy, cx)] = (addr, qp_tuple(q), lmb)
        qp_state.set_cu_qp(saved_q)
        coder.cur_qp = saved_q

        # per-row chained state
        def fresh_ctx():
            enc = CabacEncoder(BitWriter())
            enc.init_ctx(slice_qp, init_id)
            return enc.ctx

        row_ctx = {0: fresh_ctx()}
        row_sync = {}                      # r -> ctx copy after (r, 0)
        row_hmvp = {r: np.zeros((8, 12), np.int32) for r in range(n_rows)}
        row_hmvp_n = {r: 0 for r in range(n_rows)}
        row_dqp = {r: False for r in range(n_rows)}

        trees = {}
        lock = threading.Lock()
        cv = threading.Condition(lock)
        deps = {}
        for (cy, cx) in tasks:
            d = (1 if cx > 0 else 0) + (1 if cy > 0 else 0)
            deps[(cy, cx)] = d
        ready = deque(k for k, d in deps.items() if d == 0)
        done = set()
        err = []
        tls = threading.local()

        def release(k):
            cy, cx = k
            done.add(k)
            if cx == 0 and cy + 1 < n_rows:
                # H.266 WPP sync point: contexts after the first CTU
                row_sync[cy] = CtxModels(row_ctx[cy])
            rel = [(cy, cx + 1)]
            if cx > 0:
                rel.append((cy + 1, cx - 1))
            if cx == n_cols - 1:
                # last column: there is no (r, c+1) above the row below's
                # last CTU — its above-dependency is this CTU itself
                rel.append((cy + 1, cx))
            for dep_k in rel:
                if dep_k in deps:
                    deps[dep_k] -= 1
                    if deps[dep_k] == 0:
                        ready.append(dep_k)
            # row r's first CTU additionally waits for row r-1's second
            # CTU (handled via the (r-1, c+1) rule: (r, 0) depends on
            # (r-1, 1)); seed its ctx lazily when it becomes ready
            cv.notify_all()

        def run_one(k):
            cy, cx = k
            addr, qpt, lmb = tasks[k]
            with lock:
                if cy > 0 and cy not in row_ctx:
                    row_ctx[cy] = CtxModels(row_sync[cy - 1]) \
                        if (cy - 1) in row_sync else fresh_ctx()
            bufs = getattr(tls, "bufs", None)
            if bufs is None:
                bufs = (np.empty(1 << 16, np.int32),
                        np.empty(1 << 16, np.int32),
                        np.empty(4, np.int32))
                tls.bufs = bufs
            wf = {"ctx": row_ctx[cy], "hmvp": row_hmvp[cy],
                  "hmvp_n": row_hmvp_n[cy], "dqp_coded": row_dqp[cy],
                  "lmbda": lmb, "lmbda_sad": lmb ** 0.5, "qp": qpt,
                  "bufs": bufs}
            res = native.search_ctu(searcher, cx * ctu, cy * ctu, None,
                                    commit=True, wavefront=wf)
            if res is None:
                raise RuntimeError("native wavefront search failed")
            node, hn, dqp = res
            trees[addr] = node
            row_hmvp_n[cy] = hn
            row_dqp[cy] = dqp

        def worker():
            while True:
                with cv:
                    while not ready and len(done) < len(tasks) and not err:
                        cv.wait()
                    if err or len(done) >= len(tasks):
                        return
                    k = ready.popleft()
                try:
                    run_one(k)
                except BaseException as e:   # noqa: BLE001
                    with cv:
                        err.append(e)
                        cv.notify_all()
                    return
                with cv:
                    release(k)

        # run (0, 0) synchronously first: it builds the per-picture
        # native prep (and the inter context) without races
        with cv:
            k0 = ready.popleft()
        run_one(k0)
        with cv:
            release(k0)
        nthreads = max(1, min(workers, n_rows))
        ths = [threading.Thread(target=worker) for _ in range(nthreads)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        if err:
            raise err[0]
        assert len(done) == len(tasks)

        # phase 2 precondition: restore maps + motion to the pre-picture
        # state (the serial replay re-marks them progressively)
        for m, sn in zip(maps, snap_maps):
            m[...] = sn
        for a, sn in zip(mf_arrays, snap_mf):
            a[...] = sn
        if not coder.is_intra_slice:
            # object-typed AffineInfo grid: only the replay populates it
            # (the native search uses the int mirror arrays), reset it
            # alongside the mirrors
            coder.mf.aff[...] = None
        return trees

    def _encode_picture(self, poc, planes8, slice_type, refs_l0, refs_l1,
                        qp_offset=0, tlayer=0, ifp=None,
                        keep_pocs=None, nal=None) -> bytes:
        """nal: NalUnitType.CRA (an intra picture that keeps the DPB and
        signals the pictures still needed as inactive list-0 entries) or
        NalUnitType.RASL, as decoding_refresh_type="cra" places them
        (SequenceOrchestratorMixin._refresh_nal); None: IDR for an intra
        picture, else TRAIL or STSA."""
        cfg = self.cfg
        shift = cfg.bit_depth - cfg.input_bit_depth
        src = {c: planes8[c].astype(np.int32) << shift for c in range(3)}
        ps = PictureState(cfg.width, cfg.height, cfg.bit_depth)

        is_cra = nal == NalUnitType.CRA
        is_intra = slice_type == SLICE_I
        is_idr = is_intra and not is_cra
        slice_qp = self.slice_qp if is_intra else \
            max(0, min(63, cfg.qp + qp_offset))
        qp_frac = None
        if self.rc is not None and cfg.bitrate > 0:
            # per-picture lambda from the RC model's FRACTIONAL QP (the
            # reference's picInitialQP/picInitialLambda split,
            # RateCtrl.cpp:1175): the signalled QP rounds, lambda tracks
            # the model exactly
            slice_qp, qp_frac = self.rc.pic_qp_lambda(poc, slice_qp, 0)
        # lmbda stays picture-local: IFP encodes pictures concurrently in
        # threads of this object (encoder/ifp.py)
        lmbda = lambda_for_qp(qp_frac if qp_frac is not None else slice_qp,
                              cfg.bit_depth)
        lmbda_sad = lmbda ** 0.5
        if ifp is None:
            self.lmbda, self.lmbda_sad = lmbda, lmbda_sad

        from ..utils.dtrace import DTRACE
        if DTRACE.enabled:
            DTRACE.update_ctx(poc=poc, final=1)
        qpa_res = None
        if cfg.qpa:
            from .qpa import apply_qpa_slice
            self._orig_by_poc[poc] = src
            from ..codec.qp import derive_chroma_qp_table
            start, ins, outs = self.sps.chroma_qp_tables[0]
            ctab = derive_chroma_qp_table(start + 26, ins, outs, 0)
            qpa_res = apply_qpa_slice(
                src, self._orig_by_poc.get(poc - 1),
                self._orig_by_poc.get(poc - 2), slice_qp, lmbda,
                cfg.ctu_size, cfg.bit_depth,
                (cfg.fps_num + cfg.fps_den - 1) // cfg.fps_den, is_intra,
                chroma_table=lambda q: ctab[max(0, min(63, q))],
                min_noise=self.min_noise, tl=tlayer,
                intra_qp_offset=cfg.intra_qp_offset,
                bim_offsets=getattr(self, "_bim_map", {}).get(poc))
        elif cfg.bim and getattr(self, "_bim_map", {}).get(poc) is not None \
                and np.any(self._bim_map[poc]):
            # BIM without QPA: per-CTU QP = slice QP + importance offset
            from .qpa import QpaResult, MAX_QP
            bim = self._bim_map[poc]
            qpa_res = QpaResult()
            qpa_res.ctu_qps = np.clip(slice_qp + bim, 0, MAX_QP) \
                .astype(np.int32)
            qpa_res.ctu_lambdas = lmbda * np.exp2(
                (qpa_res.ctu_qps - slice_qp) / 3.0)
            qpa_res.avg_qp = int(round(qpa_res.ctu_qps.mean()))
            qpa_res.chroma_qp_offsets = (0, 0)

        sh = SliceHeader()
        sh.slice_qp = slice_qp
        sh.dep_quant_used = 1 if self.cfg.dep_quant else 0
        sh.sign_data_hiding_used = 1 if (self.cfg.sign_data_hiding and
                                         not self.cfg.dep_quant) else 0
        sh.ph = PictureHeader()
        sh.ph.poc_lsb = poc & ((1 << self.sps.log2_max_poc_lsb) - 1)

        # LMCS (EncGOP::xInitLMCS analog): derive/select the reshaper
        # model, code the slice in the mapped luma domain
        reshape = None
        lmcs_aps_bytes = b""
        if self.lmcs is not None:
            use_lmcs = not (cfg.lmcs == 2 and self.scc_detected)
            lmcs_en, model_present, chroma_scale = self.lmcs.init_picture(
                (src[0], src[1], src[2]), poc,
                slice_type == SLICE_I, tlayer, use_lmcs)
            if model_present:
                from ..codec.lmcs import write_lmcs_aps
                aps_bw = BitWriter()
                write_lmcs_aps(aps_bw, 0, self.lmcs.cur_param)
                lmcs_aps_bytes = make_nal_unit(NalUnitType.PREFIX_APS,
                                               aps_bw.get_bytes())
            if lmcs_en:
                reshape = self.lmcs.cur_state
                sh.ph.lmcs_enabled = 1
                sh.ph.lmcs_aps_id = 0
                sh.ph.chroma_residual_scale = 1 if chroma_scale else 0
                sh.lmcs_enabled = 1
        src_coding = src
        if reshape is not None:
            src_coding = dict(src)
            src_coding[0] = reshape.fwd_map(src[0]).astype(np.int32)
        if cfg.jccr:
            # picture-level joint Cb-Cr sign from source chroma high-pass
            # correlation (vvenc derives it from collected residual stats;
            # the high-pass of the source is the available proxy)
            hcb = np.diff(src[1].astype(np.int64), axis=1)
            hcr = np.diff(src[2].astype(np.int64), axis=1)
            sh.ph.joint_cbcr_sign = 1 if int((hcb * hcr).sum()) < 0 else 0
        ref_pics = [[], []]
        ref_pocs = [[], []]
        tmvp = None
        sh.slice_type = slice_type
        if is_cra:
            # the pictures a RASL picture still needs stay in the DPB as
            # inactive list-0 entries of the CRA (an I slice: no active
            # reference)
            if keep_pocs is None:
                keep_pocs = sorted((d[0] for d in self.dpb
                                    if d[0] in self.dpb_protect
                                    and d[0] != poc),
                                   key=lambda p: abs(p - poc))
            sh.rpls[0] = RefPicList(num_short_term=len(keep_pocs),
                                    delta_pocs=[p - poc for p in keep_pocs])
            sh.rpls[1] = RefPicList()
            sh.num_ref_idx = [0, 0]
        elif not is_intra:
            sh.ph.gdr_or_irap = 0
            sh.ph.inter_slice_allowed = 1
            sh.ph.intra_slice_allowed = 1
            by_poc = {e[0]: e for e in self.dpb}
            for li, refs in ((0, refs_l0), (1, refs_l1)):
                if not refs:
                    continue
                sh.rpls[li] = RefPicList(
                    num_short_term=len(refs),
                    delta_pocs=[r - poc for r in refs])
                ref_pics[li] = [by_poc[r][1] for r in refs]
                ref_pocs[li] = list(refs)
            sh.num_ref_idx = [len(refs_l0), len(refs_l1)]
            # keep-alive entries: pictures a later GOP entry still needs
            # are signaled as INACTIVE list-0 references so a spec
            # decoder's RPL-based DPB marking retains them (the role of
            # the long inactive tails in vvenc's default RPL tables,
            # vvencCfg.cpp:1659+); prediction uses only the active prefix
            if refs_l0 and (self.dpb_protect or keep_pocs):
                if keep_pocs is not None:
                    # frame-parallel worker: the keep list is computed by
                    # the orchestrator from ITS full DPB view (the worker
                    # only holds the reference subset) so the coded RPLs
                    # are byte-identical to the serial encode
                    keep = list(keep_pocs)
                else:
                    keep = sorted((p for p in by_poc
                                   if p in self.dpb_protect and p != poc
                                   and p not in refs_l0
                                   and p not in refs_l1),
                                  key=lambda p: abs(p - poc))
                if keep:
                    rl = sh.rpls[0]
                    rl.num_short_term += len(keep)
                    rl.delta_pocs = list(rl.delta_pocs) + \
                        [p - poc for p in keep]
            if not refs_l1:
                sh.rpls[1] = RefPicList()
            if cfg.tmvp:
                from ..codec.motion import TmvpCtx
                is_b_sl = slice_type == SLICE_B
                sh.ph.enable_tmvp = 1
                # collocated picture choice (EncGOP::xInitSliceColFromL0Flag,
                # EncGOP.cpp:2219): for B slices pick the reference with
                # the HIGHER slice QP (= higher temporal layer = nearer
                # picture whose motion field carries usable TMVP
                # candidates); an I-picture collocate has no motion at all
                sh.col_from_l0 = 1
                if is_b_sl and refs_l1:
                    e0 = by_poc[refs_l0[0]]
                    e1 = by_poc[refs_l1[0]]
                    qp0 = e0[4] if len(e0) > 4 else 0
                    qp1 = e1[4] if len(e1) > 4 else 0
                    sh.col_from_l0 = 1 if qp0 > qp1 else 0
                sh.col_ref_idx = 0
                pic_list = (1 - sh.col_from_l0) if is_b_sl else 0
                col = by_poc[ref_pocs[pic_list][sh.col_ref_idx]]
                if col[2] is not None:
                    check_ldc = all(p <= poc for li in range(2)
                                    for p in ref_pocs[li])
                    tmvp = TmvpCtx(col[2], col[3], col[0], poc, ref_pocs,
                                   sh.col_from_l0 if is_b_sl else 1,
                                   check_ldc, cfg.width, cfg.height,
                                   cfg.ctu_size)
        if qpa_res is not None:
            sh.cb_qp_offset, sh.cr_qp_offset = qpa_res.chroma_qp_offsets
        qp_state = QpState(self.sps, self.pps, slice_qp, sh=sh)

        coder = SyntaxCoder(self.sps, self.pps, sh, qp_state, ref_pics,
                            ref_pocs, tmvp=tmvp, cur_poc=poc,
                            reshape=reshape)
        if ifp is not None:
            # pre-created motion field: TMVP source for dependent frames
            # of the same IFP wave (gated by coded-row progress)
            coder.mf = ifp.mf
        coder.attach_motion(ps)
        searcher = _CtuSearcher(self, ps, qp_state, src_coding, coder,
                                src_me_y=src[0], lmbda=lmbda,
                                lmbda_sad=lmbda_sad)

        # slice data is written first (WPP needs the per-row substream
        # sizes to write the entry points in the header)
        init_id = 2 if is_intra else sh.slice_type
        sw = _SliceWriter(slice_qp, init_id, bool(cfg.wpp))
        ctu = cfg.ctu_size
        n_cols = (cfg.width + ctu - 1) // ctu
        n_rows = (cfg.height + ctu - 1) // ctu

        tiles_enc = None
        if not self.pps.no_pic_partition:
            cols, rows_ = hls.tile_grid(self.pps, self.sps)
            if len(cols) * len(rows_) > 1:
                cs_ = np.cumsum([0] + cols)
                rs_ = np.cumsum([0] + rows_)
                tiles_enc = [(int(cs_[i]), int(cs_[i + 1]), int(rs_[j]),
                              int(rs_[j + 1]))
                             for j in range(len(rows_))
                             for i in range(len(cols))]
                ps.set_tiles([int(c) * ctu for c in cs_[:-1]],
                             [int(r) * ctu for r in rs_[:-1]])
        # tile-scan CTU traversal (single tile = plain raster)
        scan = []
        if tiles_enc is not None:
            for ti, (tx0, tx1, ty0, ty1) in enumerate(tiles_enc):
                for cy in range(ty0, ty1):
                    for cx in range(tx0, tx1):
                        scan.append((ti, cx, cy, cx == tx0))
        else:
            for cy in range(n_rows):
                for cx in range(n_cols):
                    scan.append((0, cx, cy, cx == 0))

        trees = [None] * (n_cols * n_rows)

        # IFP: CTU-row pipeline hooks (encoder/ifp.py).  Banded mode
        # (deblock-only filters) finalizes + publishes the filtered rows
        # as coding progresses; otherwise progress publishes on frame
        # completion only (SAO/ALF derivations are whole-picture).
        ifp_banded = (ifp is not None and cfg.deblocking
                      and not cfg.sao and not cfg.alf)
        ifp_nofilter = (ifp is not None and not cfg.deblocking
                        and not cfg.sao and not cfg.alf)
        if ifp is not None:
            # QPA is IFP-safe: per-CTU lambdas/QPs come from display-order
            # originals fixed before the threads start, and the CTU loop
            # keeps lambda picture-local
            assert tiles_enc is None and not cfg.wpp \
                and reshape is None, "IFP v1: raster scan, no LMCS"

        def _tree_cus(node, out):
            if node.cu is not None:
                out.append(node.cu)
            for c_ in node.children:
                _tree_cus(c_, out)
            if node.chroma_cu is not None:
                out.append(node.chroma_cu)

        def _ifp_row_done(r):
            """CTU row r fully coded: refine its motion field rows, band-
            filter into the shared filtered recon, publish progress."""
            if cfg.dmvr:
                from ..codec.motion import refine_mf_with_dmvr
                refine_mf_with_dmvr(
                    coder.mf,
                    [t for t in trees[r * n_cols:(r + 1) * n_cols]
                     if t is not None])
            if not (ifp_banded or ifp_nofilter):
                return
            y0b, y1b = r * ctu, min(ps.h, (r + 1) * ctu)
            for c_ in (0, 1, 2):
                sc_ = 1 if c_ else 0
                ifp.frec[c_][y0b >> sc_:y1b >> sc_] = \
                    ps.rec[c_][y0b >> sc_:y1b >> sc_]
            if ifp_banded:
                from ..native.deblock import deblock_picture
                with PROF.section("stage.deblock"):
                    cus_ = []
                    for t_ in trees:
                        if t_ is not None:
                            _tree_cus(t_, cus_)
                    deblock_picture(
                        ifp.frec, cus_, slice_qp,
                        qp_state.chroma_qp(1) - qp_state.qp_bd_offset,
                        qp_state.chroma_qp(2) - qp_state.qp_bd_offset,
                        cfg.ctu_size, cfg.bit_depth, ref_pocs=ref_pocs,
                        is_b=(slice_type == SLICE_B), qp_map=ps.qp_map,
                        chroma_qp_fn=qp_state.chroma_deblock_qp,
                        y_band=(y0b, y0b + ctu))
            # progress = bands processed; in banded-deblock mode the last
            # 7 pixel rows of band r may still change when band r+1's
            # horizontal edges filter across the row boundary — the IFP
            # motion bound subtracts that strip (see the CTU loop)
            ifp.publish(r + 1)

        # WPP wavefront CTU search (phase 1): all trees are decided by
        # dependency-ordered parallel native searches; the loop below
        # then replays them serially (byte-identical for any worker
        # count — the chains are pure functions of the dependencies)
        wf_trees = None
        if ifp is None and tiles_enc is None and cfg.wpp \
                and cfg.wpp_search_workers >= 0 \
                and os.environ.get("VVENC_TPU_NATIVE_SEARCH", "1") == "1":
            from .. import native as _nat
            if _nat.available() and _nat.search_eligible(searcher):
                wf_workers = cfg.wpp_search_workers or 2
                with PROF.section("slice.ctu_search"):
                    wf_trees = self._wavefront_search(
                        searcher, scan, qpa_res, n_cols, n_rows,
                        slice_qp, init_id, wf_workers)

        prev_tile, prev_cy = -1, -1
        for ti, cx, cy, row_start in scan:
            if tiles_enc is not None and ti != prev_tile:
                sw.new_tile(ti)
                ps.cur_tile = ti
                prev_tile = ti
            if row_start or cy != prev_cy:
                if ifp is not None:
                    if prev_cy >= 0:
                        _ifp_row_done(prev_cy)
                    ifp.wait_refs(cy)
                    # -8: bands published as "processed" leave a 7-row
                    # strip that the next band's horizontal deblock edges
                    # may still modify
                    bot = (cy + ifp.lines) * ctu - 8
                    searcher.ifp_bottom = bot if bot < ps.h else None
                if tiles_enc is None:
                    sw.new_row(cy)
                coder.new_ctu_row()
                prev_cy = cy
            saved_cur_qp = None
            if qpa_res is not None:
                addr = cy * n_cols + cx
                ctu_qp = int(qpa_res.ctu_qps[addr])
                qp_state.set_cu_qp(ctu_qp)
                # pin the QG state to this CTU's QP FOR THE SEARCH ONLY:
                # finish_cu consults coder.cur_qp during the search too,
                # and a stale value from the previous CTU's replay would
                # make the search dequantize at the wrong QP, corrupting
                # the staged reconstruction at every per-CTU QP change
                # (15 dB loss at QPA/BIM transitions before this fix).
                # The writer's running predictor state is restored before
                # the replay — the dqp delta coding depends on it.
                saved_cur_qp = coder.cur_qp
                coder.cur_qp = ctu_qp
                searcher.lmbda = float(qpa_res.ctu_lambdas[addr])
                searcher.lmbda_sad = searcher.lmbda ** 0.5
                if ifp is None:
                    # encoder-level lambda only outside IFP: IFP threads
                    # share this object, lambda must stay picture-local
                    self.lmbda = searcher.lmbda
                    self.lmbda_sad = searcher.lmbda_sad
            with PROF.section("slice.ctu_search"):
                tree = wf_trees[cy * n_cols + cx] \
                    if wf_trees is not None \
                    else searcher.search_ctu(cx * ctu, cy * ctu,
                                             sw.enc.ctx)
            if saved_cur_qp is not None:
                coder.cur_qp = saved_cur_qp
            if qpa_res is not None:
                _set_tree_qp(tree, ctu_qp)
            with PROF.section("slice.ctu_encode"):
                coder.encode_ctu(sw.enc, ps, tree)
            if tiles_enc is None and cx == 0:
                sw.after_first_ctu()
            trees[cy * n_cols + cx] = tree
        if ifp is not None and prev_cy >= 0:
            _ifp_row_done(prev_cy)
        # end_of_slice: terminating bin + arithmetic flush + rbsp trailing
        # bits.  The stop '1' bit completes the terminator code interval
        # (the flush drops the low byte; '1000...' padding lands the decoded
        # point inside [low, low+256) — vvenc writeByteAlignment semantics).
        with PROF.section("slice.write"):
            payload, sh.entry_point_offsets = sw.finish()
            bw = BitWriter()
            hls.write_slice_header(bw, sh, self.sps, self.pps,
                                   is_idr=is_idr)
            bw.write_byte_alignment()
            bw.append_bytes(payload)

        if cfg.dmvr and ifp is None:
            # refined MVs land in the stored motion field (TMVP source),
            # mirroring the decoder (vvenc setRefinedMotionFieldCTU);
            # under IFP this ran per CTU row (_ifp_row_done)
            from ..codec.motion import refine_mf_with_dmvr
            refine_mf_with_dmvr(coder.mf, trees)

        if reshape is not None:
            # inverse luma mapping before the in-loop filters
            # (EncSlice.cpp:1016)
            ps.rec[0] = reshape.inv_map(ps.rec[0]).astype(ps.rec[0].dtype)

        if ifp_banded:
            # the per-row banded deblock already produced the filtered
            # picture in ifp.frec; adopt it as this picture's recon
            for c in (0, 1, 2):
                ps.rec[c][:] = ifp.frec[c]
        elif cfg.deblocking:
            from ..native.deblock import deblock_picture
            with PROF.section("stage.deblock"):
                cus = []
                for t in trees:
                    _tree_cus(t, cus)
                deblock_picture(ps.rec, cus, slice_qp,
                                qp_state.chroma_qp(1) - qp_state.qp_bd_offset,
                                qp_state.chroma_qp(2) - qp_state.qp_bd_offset,
                                cfg.ctu_size, cfg.bit_depth,
                                ref_pocs=ref_pocs,
                                is_b=(slice_type == SLICE_B),
                                qp_map=ps.qp_map,
                                chroma_qp_fn=qp_state.chroma_deblock_qp)

        aps_bytes = b""
        sao_map = None
        if cfg.sao:
            from .sao_enc import derive_sao
            from ..codec.sao import apply_sao_picture
            tile_of = None
            if tiles_enc is not None:
                tile_of = [0] * (n_cols * n_rows)
                for ti_, (tx0, tx1, ty0, ty1) in enumerate(tiles_enc):
                    for cy_ in range(ty0, ty1):
                        for cx_ in range(tx0, tx1):
                            tile_of[cy_ * n_cols + cx_] = ti_
            with PROF.section("stage.sao"):
                res = derive_sao(src, ps.rec, cfg.bit_depth, cfg.ctu_size,
                                 lmbda, n_cols, n_rows, tile_of=tile_of)
                if res is not None:
                    sao_map, (sh.sao_luma, sh.sao_chroma) = res
                    apply_sao_picture(ps.rec, sao_map, cfg.ctu_size,
                                      cfg.bit_depth, n_cols, n_rows)
        alf_info = None
        cc_ctrl = np.zeros((2, n_rows * n_cols), np.int32)
        cc_counts = [0, 0]
        if cfg.alf:
            from .alf_enc import derive_alf, derive_ccalf
            from ..codec.alf import write_alf_aps, apply_alf_picture
            with PROF.section("stage.alf"):
                res = derive_alf(src, ps.rec, cfg.bit_depth, cfg.ctu_size,
                                 lmbda, nonlinear=cfg.alf_nonlinear)
                if res is not None:
                    alf_p, enabled, alf_flags, alf_fidx, alf_alt, filt = res
                    sh.alf_enabled = enabled if enabled[0] else [0, 0, 0]
                    if not enabled[0]:
                        alf_p.new_filter[0] = 0
                    if sh.alf_enabled[0]:
                        sh.num_alf_aps = 1
                        sh.luma_aps_ids = [0]
                        sh.chroma_aps_id = 0
                        if cfg.ccalf:
                            # CC-ALF derivation needs the ALF-applied chroma
                            # and the pre-ALF luma (the filter's input)
                            applied = {c: ps.rec[c].copy() for c in range(3)}
                            apply_alf_picture(
                                applied, cfg.bit_depth, cfg.ctu_size, n_cols,
                                n_rows, {0: alf_p}, sh.luma_aps_ids,
                                sh.chroma_aps_id, sh.alf_enabled, 1, alf_flags,
                                alf_fidx, alf_alt, [0, 0], [0, 0], cc_ctrl)
                            ccres = derive_ccalf(
                                src, {1: applied[1], 2: applied[2]}, ps.rec[0],
                                cfg.bit_depth, cfg.ctu_size, lmbda)
                            if ccres is not None:
                                cc_coeff, cc_counts, cc_en, cc_ctrl = ccres
                                alf_p.cc_coeff = cc_coeff
                                alf_p.cc_filter_signal = list(cc_counts)
                                alf_p.cc_filter_count = [max(1, c)
                                                         for c in cc_counts]
                                sh.cc_alf_enabled = list(cc_en)
                                sh.cc_alf_aps_ids = [0, 0]
                        aps_bw = BitWriter()
                        write_alf_aps(aps_bw, 0, alf_p)
                        aps_bytes = make_nal_unit(NalUnitType.PREFIX_APS,
                                                  aps_bw.get_bytes())
                        alf_info = (alf_flags, alf_fidx, alf_alt, alf_p)
        if sao_map is not None or alf_info is not None:
            # replay the slice entropy with SAO/ALF CTU syntax prepended
            from ..codec.sao import write_sao_ctu
            from ..codec.alf import code_alf_ctu
            ps2 = PictureState(cfg.width, cfg.height, cfg.bit_depth)
            if tiles_enc is not None:
                ps2.tile_map = ps.tile_map
            qp2 = QpState(self.sps, self.pps, slice_qp, sh=sh)
            coder2 = SyntaxCoder(self.sps, self.pps, sh, qp2,
                                 ref_pics, ref_pocs, tmvp=tmvp, cur_poc=poc,
                                 reshape=reshape)
            coder2.attach_motion(ps2)
            sw = _SliceWriter(slice_qp, 2 if is_intra else sh.slice_type,
                              bool(cfg.wpp))
            prev_tile, prev_cy = -1, -1
            for ti, cx, cy, row_start in scan:
                if tiles_enc is not None and ti != prev_tile:
                    sw.new_tile(ti)
                    ps2.cur_tile = ti
                    prev_tile = ti
                if row_start or cy != prev_cy:
                    if tiles_enc is None:
                        sw.new_row(cy)
                    coder2.new_ctu_row()
                    prev_cy = cy
                addr = cy * n_cols + cx
                al = au_ = None
                if tiles_enc is not None:
                    tx0, _, ty0, _ = tiles_enc[ti]
                    al, au_ = cx > tx0, cy > ty0
                if qpa_res is not None:
                    qp2.set_cu_qp(int(qpa_res.ctu_qps[addr]))
                with PROF.section("slice.ctu_encode"):
                    if sao_map is not None:
                        write_sao_ctu(sw.enc, sao_map[addr], sao_map, cx,
                                      cy, n_cols,
                                      (sh.sao_luma, sh.sao_chroma),
                                      cfg.bit_depth, avail_left=al,
                                      avail_up=au_)
                    if alf_info is not None:
                        code_alf_ctu(sw.enc, True, addr, n_cols,
                                     sh.alf_enabled, sh.num_alf_aps, 1,
                                     alf_info[0], alf_info[1], alf_info[2],
                                     sh.cc_alf_enabled, cc_counts, cc_ctrl,
                                     avail_left=al, avail_up=au_)
                    coder2.encode_ctu(sw.enc, ps2, trees[addr])
                if tiles_enc is None and cx == 0:
                    sw.after_first_ctu()
            with PROF.section("slice.write"):
                payload, sh.entry_point_offsets = sw.finish()
                bw = BitWriter()
                hls.write_slice_header(bw, sh, self.sps, self.pps,
                                       is_idr=is_idr)
                bw.write_byte_alignment()
                bw.append_bytes(payload)
        if alf_info is not None:
            # apply ALF + CC-ALF exactly as the decoder will
            from ..codec.alf import apply_alf_picture
            alf_flags, alf_fidx, alf_alt, alf_p = alf_info
            with PROF.section("stage.alf"):
                apply_alf_picture(
                    ps.rec, cfg.bit_depth, cfg.ctu_size, n_cols, n_rows,
                    {0: alf_p}, sh.luma_aps_ids,
                    sh.chroma_aps_id
                    if (sh.alf_enabled[1] or sh.alf_enabled[2]) else None,
                    sh.alf_enabled, 1, alf_flags, alf_fidx, alf_alt,
                    sh.cc_alf_enabled, sh.cc_alf_aps_ids, cc_ctrl)
        with PROF.section("slice.write"):
            if nal is not None:
                nal_type = nal
            elif is_idr:
                nal_type = NalUnitType.IDR_N_LP if self.frames_done == 0 \
                    else NalUnitType.IDR_W_RADL
            elif tlayer > 0 and \
                    tlayer >= max(1, cfg.gop_size.bit_length() - 1):
                # top-temporal-layer pictures are never referenced in the
                # dyadic hierarchy -> stepwise temporal sublayer access
                # (vvenc GOPCfg STSA marking, GOPCfg.cpp xSetSTSA)
                nal_type = NalUnitType.STSA
            else:
                nal_type = NalUnitType.TRAIL
            PROF.count("gop.pictures", nal_type.name)
            au = make_nal_unit(nal_type, bw.get_bytes(),
                               temporal_id=max(0, tlayer))
            au = lmcs_aps_bytes + aps_bytes + au
            if cfg.hrd_timing_sei:
                from ..bitstream.sei import (
                    write_sei_nal, SeiBufferingPeriod, SeiPicTiming,
                    SEI_BUFFERING_PERIOD, SEI_PIC_TIMING)
                msgs = []
                if is_intra:
                    msgs.append((SEI_BUFFERING_PERIOD,
                                 SeiBufferingPeriod().payload()))
                msgs.append((SEI_PIC_TIMING, SeiPicTiming(
                    cpb_removal_delay=self.frames_done,
                    dpb_output_delay=1).payload()))
                au = write_sei_nal(msgs, prefix=True) + au
            if getattr(self, "_fgc_sei", None) and is_idr:
                au = self._fgc_sei + au
            if cfg.picture_hash:
                from ..bitstream.sei import (
                    write_sei_nal, compute_picture_hash,
                    SeiDecodedPictureHash, SEI_DECODED_PICTURE_HASH)
                sei = SeiDecodedPictureHash(
                    cfg.picture_hash - 1,
                    compute_picture_hash(ps.rec, cfg.bit_depth,
                                         cfg.picture_hash - 1))
                au = au + write_sei_nal(
                    [(SEI_DECODED_PICTURE_HASH, sei.payload())], prefix=False)
        if ifp is not None:
            # barrier modes (SAO/ALF) fill the filtered recon only now;
            # publish full progress and leave shared encoder state to the
            # wave scheduler (threads share this object)
            if not (ifp_banded or ifp_nofilter):
                for c in (0, 1, 2):
                    ifp.frec[c][:] = ps.rec[c]
            ifp.publish(ifp.n_rows)
            self.qp_by_poc[poc] = slice_qp
            self.slice_type_by_poc[poc] = slice_type
            return au
        out = (self.headers() + au) if self.frames_done == 0 else au
        self.frames_done += 1
        self.last_rec = ps
        self.bits_by_poc[poc] = len(out) * 8
        if self.rc is not None:
            if cfg.bitrate > 0:
                self.rc.update(poc, len(out) * 8)
            self.rc.add_stat(poc, slice_qp, len(out) * 8, slice_type)
        self.slice_type_by_poc[poc] = slice_type
        self.qp_by_poc[poc] = slice_qp
        if is_idr:
            self.dpb = []
        self.dpb.append((poc, dict(ps.rec), coder.mf,
                         [list(ref_pocs[0]), list(ref_pocs[1])], slice_qp))
        self._trim_dpb()
        return out


def _set_tree_qp(node, qp: int) -> None:
    """Stamp the QPA-decided CTU QP on every CU of a search tree (the
    syntax writer codes the cu_qp_delta from these)."""
    if node.native_rec is not None:
        node.native_rec.qp = qp
    if node.cu is not None:
        node.cu.qp = qp
    if getattr(node, "chroma_cu", None) is not None:
        node.chroma_cu.qp = qp
    for c in node.children:
        _set_tree_qp(c, qp)


def _assert_trees_equal(a, b, path="ctu"):
    """Debug helper (VVENC_TPU_NATIVE_SEARCH=check): native search tree
    must equal the Python searcher's tree exactly."""
    assert (a.x, a.y, a.w, a.h, a.split_mode) == \
        (b.x, b.y, b.w, b.h, b.split_mode), \
        (path, (a.x, a.y, a.w, a.h, a.split_mode),
         (b.x, b.y, b.w, b.h, b.split_mode))
    assert len(a.children) == len(b.children), path
    for i, (ca, cb) in enumerate(zip(a.children, b.children)):
        _assert_trees_equal(ca, cb, f"{path}.{i}")
    if (a.cu is None) != (b.cu is None):
        raise AssertionError(f"{path}: cu presence differs")
    if a.cu is not None:
        ca, cb = a.cu, b.cu
        assert ca.luma_mode == cb.luma_mode, \
            (path, "mode", ca.luma_mode, cb.luma_mode)
        assert ca.chroma_dir == cb.chroma_dir, \
            (path, "chroma", ca.chroma_dir, cb.chroma_dir)
        for f in ("is_inter", "skip", "merge", "merge_idx", "mv",
                  "ref_idx", "mvd", "mvp_idx", "mvd_l1", "mvp_idx_l1",
                  "bcw_idx", "alt_hpel", "imv", "smvd", "root_cbf",
                  "mmvd_flag", "mmvd_base", "mmvd_step", "mmvd_pos",
                  "geo", "geo_split_dir", "geo_idx0", "geo_idx1",
                  "affine", "affine_type", "sbtmvp", "aff_mvds",
                  "dmvr_deltas"):
            va, vb = getattr(ca, f), getattr(cb, f)
            assert va == vb, (path, f, va, vb)
        for f in ("coeff_y", "coeff_cb", "coeff_cr"):
            va, vb = getattr(ca, f), getattr(cb, f)
            if va is None and vb is None:
                continue
            assert va is not None and vb is not None, (path, f)
            assert np.array_equal(va, vb), (path, f)


from .inter_search import InterSearchMixin


class _CtuSearcher(InterSearchMixin):
    """Depth-first QT RD search for one picture."""

    def __init__(self, enc: IntraEncoder, ps: PictureState, qp: QpState,
                 src, coder: SyntaxCoder, src_me_y=None, lmbda=None,
                 lmbda_sad=None):
        self.enc = enc
        self.cfg = enc.cfg
        self.ps = ps
        self.qp = qp
        self.src = src                 # coding-domain source (LMCS: mapped)
        # original-domain luma for motion estimation (refs are unmapped)
        self.src_me_y = src[0] if src_me_y is None else src_me_y
        self.coder = coder
        self.lmbda = enc.lmbda if lmbda is None else lmbda
        self.lmbda_sad = enc.lmbda_sad if lmbda_sad is None else lmbda_sad
        # IFP motion restriction: no reference read at or below this
        # picture row (None = unrestricted); set per CTU row by the
        # encode loop (encoder/ifp.py)
        self.ifp_bottom = None
        self._native_tq_ok = None
        # EncModeCtrl save/load: winning intra modes per revisited area
        self.mode_cache = {}
        # chroma distortion weights (EncCu::setUpLambda: w =
        # 2^((qpY - qpC)/3) from the SLICE qp + the dep-quant chroma
        # boost); chroma RDOQ runs at lmbda/w, chroma SSE enters costs
        # multiplied by w
        boost = 1.0
        if self.cfg.dep_quant:
            boost = 2.0 ** ((0.1 if self.cfg.gop_size >= 8 else 0.2) / 3.0)
        self.cw = {
            0: 1.0,
            1: boost * 2.0 ** ((qp.luma_qp() - qp.chroma_qp(1)) / 3.0),
            2: boost * 2.0 ** ((qp.luma_qp() - qp.chroma_qp(2)) / 3.0)}

    def _use_presel(self) -> bool:
        """Resolve the intra_presel mode (resolve_intra_presel) and say
        whether the frame-level device preselection runs."""
        if self.cfg.intra_presel == "auto":
            self.cfg.intra_presel = resolve_intra_presel(self.cfg)
        return self.cfg.intra_presel == "source"

    def _get_presel(self):
        """Per-picture frame-level device preselection tables (lazy)."""
        if getattr(self, "_presel_tab", None) is None:
            from ..ops.intra_presel import FramePresel, shapes_for_config
            with PROF.section("device.frame_presel"):
                self._presel_tab = FramePresel(
                    self.src[0], self.cfg.bit_depth,
                    shapes_for_config(self.cfg.ctu_size,
                                      self.cfg.max_mtt_depth),
                    device=self.cfg.device)
        return self._presel_tab

    def _use_plan(self) -> bool:
        """Device RD planning (ops/intra_plan.py): the batched device
        trial kernel decides the luma coding tree + a 2-mode shortlist
        per leaf; the native driver codes the plan exactly.  Scope: the
        QT-only dual-tree intra path with one lambda per picture (the
        faster/firstpass presets; QPA varies lambda per CTU and falls
        back to the exact search)."""
        import os
        if os.environ.get("VVENC_TPU_NATIVE_SEARCH") == "check":
            return False     # check mode compares native vs the exact
                             # Python golden search — plan would diverge
        mode = self.cfg.device_rd
        if mode == "auto":
            # sparse RA I-slices cannot amortize the plan program's
            # launches; device planning resolves on for intra-heavy
            # streams only
            mode = "on" if (self.cfg.device == "cuda"
                            and self.cfg.intra_period == 1) else "off"
            self.cfg.device_rd = mode
        return (mode == "on"
                and self.enc.sps.max_mtt_depth[0] == 0
                and bool(self.coder.dual_tree_intra)
                and not self.coder.use_dqp
                and self.coder.is_intra_slice)

    def _get_plan(self):
        """Per-picture device RD plan (lazy; see _use_plan).  The
        frame-batched prefill bank (d2h latency amortized over many
        frames) is consulted first."""
        if getattr(self, "_plan_tab", None) is None:
            ready = getattr(self.enc, "_plan_ready", None)
            if ready is not None:
                ev = ready.get(self.coder.cur_poc)
                if ev is not None and not ev.is_set():
                    with PROF.section("device.plan_wait"):
                        ev.wait()
                err = getattr(self.enc, "_plan_error", None)
                if err is not None:
                    raise RuntimeError(
                        "device RD plan prefill failed") from err
            banked = self.enc._plan_bank.pop(self.coder.cur_poc, None)
            if banked is not None:
                from ..ops.intra_plan import _PlanView
                self._plan_tab = _PlanView(banked)
                return self._plan_tab
            from ..ops.intra_plan import FramePlan
            sps = self.enc.sps
            with PROF.section("device.frame_plan"):
                self._plan_tab = FramePlan(
                    self.src[0], self.cfg.bit_depth, self.cfg.ctu_size,
                    int(sps.min_qt_size[0]), self.qp.luma_qp(),
                    float(self.lmbda), float(self.lmbda_sad),
                    implicit_mts=bool(self.coder.implicit_mts),
                    device=self.cfg.device)
        return self._plan_tab

    def _chroma_scale(self, x: int, y: int, tw: int, th: int):
        """LMCS chroma residual scale for a TU at luma pos (x, y), or None
        (gates per DecCu.cpp:161-205: slice chroma-scaling on, > 4 chroma
        samples)."""
        c = self.coder
        if c.reshape is None or not c.lmcs_chroma_scale or tw * th <= 4:
            return None
        from ..codec.lmcs import chroma_adj_vpdu_nei
        return chroma_adj_vpdu_nei(self.ps, c.reshape, x, y,
                                   self.cfg.ctu_size.bit_length() - 1)

    def search_ctu(self, x: int, y: int, live_ctx: CtxModels) -> TreeNode:
        """RD-decide the coding tree of one CTU.

        Works on a scratch copy of the picture/motion state region; the
        caller replays the returned tree through the real coder (which
        reconstructs into the same state deterministically).

        When the picture's tool set is covered by the native C++ CTU
        search driver (native.search_eligible — the faster/firstpass
        intra path), the whole search runs as one native call
        (EncCu::xCompressCtu as a native driver, bit-exact vs this
        Python implementation; tests/test_native_search.py)."""
        import os
        nmode = os.environ.get("VVENC_TPU_NATIVE_SEARCH", "1")
        if nmode != "0":
            from .. import native
            if native.available() and native.search_eligible(self):
                # check mode: the Python golden searcher re-runs on the
                # same state, so the native call must NOT commit its
                # recon/marks (the replay reconstructs instead)
                node = native.search_ctu(self, x, y, live_ctx,
                                         commit=nmode != "check")
                if node is not None:
                    if nmode == "check":
                        ref = self._search_ctu_py(x, y, live_ctx)
                        _assert_trees_equal(ref, node)
                    return node
        return self._search_ctu_py(x, y, live_ctx)

    def _search_ctu_py(self, x: int, y: int, live_ctx: CtxModels
                       ) -> TreeNode:
        """Pure-Python golden search (the native driver's reference)."""
        self.est = BitEstimator(CtxModels(live_ctx))
        snap = self._save(x, y, self.cfg.ctu_size)
        if self.coder.dual_tree_intra:
            # dual-tree intra: search the luma tree of each 64-unit first
            # (leaving its reconstruction staged so the chroma search sees
            # the luma the decoder will), then the chroma tree
            # (vvenc EncCu::xCompressCtu dual-tree dispatch)
            def tree_fn(ux, uy, u, pl):
                tnode, _ = self._rd_node(ux, uy, u, u, pl)
                if pl.tree_type == TREE_L:
                    # 64-unit luma record for the chroma CCLM gate
                    self.coder.luma64[(ux, uy)] = [
                        tnode.split_mode,
                        bool(tnode.cu.isp_mode)
                        if tnode.cu is not None else False]
                return tnode
            node = self.coder._dual_tree_units(self.ps, x, y, tree_fn)
        else:
            node, _cost = self._rd_node(x, y, self.cfg.ctu_size,
                                        self.cfg.ctu_size, PartInfo())
        self._restore(snap)
        return node

    def _save(self, x, y, size):
        coder = self.coder
        mf_snap = coder.mf.save_region(x, y, size) if coder.mf else None
        hm_snap = list(coder.hmvp.lut)
        hm_ibc_snap = list(coder.hmvp_ibc.lut)
        return (self.ps.save_region(x, y, size), self.est.snapshot(),
                mf_snap, hm_snap, hm_ibc_snap)

    def _restore(self, snap):
        self.ps.restore_region(snap[0])
        self.est.restore(snap[1])
        if snap[2] is not None:
            self.coder.mf.restore_region(snap[2])
        self.coder.hmvp.lut = list(snap[3])
        self.coder.hmvp_ibc.lut = list(snap[4])

    def _native_tq(self) -> bool:
        """True when the fused native transform/quant/recon trial
        (native.tq_trial) matches this config's quantizer: RDOQ or the
        dependent-quantization trellis (both native)."""
        v = self._native_tq_ok
        if v is None:
            from .. import native
            v = self._native_tq_ok = (native.available()
                                      and bool(self.cfg.rdoq
                                               or self.cfg.dep_quant))
        return v

    def _tq(self, resi, qp, is_luma, cbf_ctx=None, trh=0, trv=0,
            intra_slice=True, lmbda=None):
        """Forward transform + quantize one TU; returns the levels [h, w]
        or None when the TU quantizes to all-zero.  Dispatches to the
        fused native kernel (native.tq_quant: one crossing for transform
        + RDOQ + SDH) when the config matches, else the Python pair."""
        h, w = resi.shape
        if w >= 4 and h >= 4 and self._native_tq():
            from .. import native
            dq = bool(self.cfg.dep_quant)
            return native.tq_quant(resi, trh, trv, qp, self.cfg.bit_depth,
                                   is_luma,
                                   self.lmbda if lmbda is None else lmbda,
                                   self.est.ctx, cbf_ctx,
                                   self.cfg.sign_data_hiding and not dq,
                                   dq=dq)
        c = self._q(T.fwd_transform_np(resi, self.cfg.bit_depth, trh, trv),
                    qp, is_luma, cbf_ctx, intra_slice=intra_slice,
                    lmbda=lmbda)
        return c if np.any(c) else None

    def _q(self, tcoef, qp, is_luma, cbf_ctx=None, intra_slice=True,
           lmbda=None):
        if lmbda is None:
            lmbda = self.lmbda
        """Quantize one TU: trellis (dependent) quantization when enabled
        (ops/depquant.py), else RDOQ against the live estimator contexts
        (ops/rdoq.py), else scalar deadzone quant."""
        if self.cfg.dep_quant:
            from .. import native
            if native.available():
                return native.depquant(tcoef, qp, self.cfg.bit_depth,
                                       is_luma, lmbda, self.est.ctx,
                                       cbf_ctx)
            from ..ops.depquant import depquant_np
            return depquant_np(tcoef, qp, self.cfg.bit_depth, is_luma,
                               lmbda, self.est.ctx, cbf_ctx)
        if self.cfg.rdoq:
            from ..ops.rdoq import rdoq_np
            out = rdoq_np(tcoef, qp, self.cfg.bit_depth, is_luma,
                          lmbda, self.est.ctx, cbf_ctx)
        else:
            out = T.quant_np(tcoef, qp, self.cfg.bit_depth,
                             is_intra_slice=intra_slice)
        if self.cfg.sign_data_hiding and not self.cfg.dep_quant \
                and np.any(out):
            out = T.sdh_adjust(out, tcoef, qp, self.cfg.bit_depth)
        return out

    def _dq(self, coeff, qp):
        return (T.dequant_dq_np(coeff, qp, self.cfg.bit_depth)
                if self.cfg.dep_quant
                else T.dequant_np(coeff, qp, self.cfg.bit_depth))

    # -- recursive tree search -------------------------------------------
    def _rd_node(self, x: int, y: int, w: int, h: int, part: PartInfo,
                 budget: float = float("inf")):
        ps = self.ps
        sps = self.enc.sps
        tidx = 2 if part.tree_type == CHROMA_TREE else self.coder.tree_idx
        can_spl = split_options_full(ps, x, y, w, h, part, sps, tidx)

        best_node = None
        best_cost = float("inf")
        state0 = self._save(x, y, max(w, h))

        # round-1 searcher: never choose a split that would open a SCIPU
        # region (mode_cons signalling / local dual tree); the shared syntax
        # layer decodes them, the search just avoids producing them.  Legal:
        # an encoder may restrict its split choices arbitrarily.
        from ..codec.ctu_syntax import signal_mode_cons, LDT_INHERIT
        tries = [s for s, ok in enumerate(can_spl) if ok and (
            s == NO_SPLIT or signal_mode_cons(
                w, h, s, part.mode_type,
                self.coder.is_intra_slice) == LDT_INHERIT)]
        if not tries:
            # every legal split triggers SCIPU (forced boundary split on a
            # tiny block) — should be unreachable with our configs
            raise AssertionError(
                f"no SCIPU-free split at ({x},{y}) {w}x{h}")
        # EncModeCtrl split-cost bound (EncCu::xCheckModeSplit analog):
        # a ternary split in direction X is skipped when the binary
        # split in the same direction was evaluated and did not become
        # the best — TT practically never wins where same-direction BT
        # lost (the reference's fast QTBTT scheduling)
        from ..codec.ctu_syntax import BT_H, BT_V, TT_H, TT_V
        bt_improved = {BT_H: False, BT_V: False}
        bt_tried = {BT_H: False, BT_V: False}
        tt_gate = self.coder.is_intra_slice   # B-slice TT still pays off
        for trial_i, split in enumerate(tries):
            if tt_gate and split == TT_H and bt_tried[BT_H] \
                    and not bt_improved[BT_H]:
                continue
            if tt_gate and split == TT_V and bt_tried[BT_V] \
                    and not bt_improved[BT_V]:
                continue
            _ss_bump("split_trial" if split else "no_split_trial")
            if trial_i > 0:
                self._restore(state0)
            node = TreeNode(x, y, max(w, h), part.qt_depth, w=w, h=h,
                            part=part, split_mode=split,
                            split=split != NO_SPLIT)
            b0 = self.est.frac_bits
            write_split_mode(self.est, ps, x, y, w, h, part, sps, split,
                             tidx)
            cost = self.lmbda * (self.est.frac_bits - b0) / (1 << 15)
            if split == NO_SPLIT:
                cu, cu_cost = self._rd_cu(x, y, w, h, part)
                node.cu = cu
                cost += cu_cost
                # EncModeCtrl early termination (EncModeCtrl.cpp
                # earlySkip): a SKIP winner (merge, zero residual) at this
                # level makes deeper partitions near-certain losers —
                # don't descend
                if getattr(cu, "skip", False) and cost < best_cost:
                    best_node, best_cost = node, cost
                    best_after = self._save(x, y, max(w, h))
                    break
            else:
                impl = implicit_split(ps, x, y, w, h, part, sps, tidx)
                is_impl = split == impl
                aborted = False
                # recursive split-cost bound (EncCu::xCheckModeSplit
                # analog): the child search inherits the remaining
                # budget and gives up as soon as it can't beat it
                limit = min(best_cost, budget)
                for idx, (cx, cy, cw, chh) in enumerate(
                        split_geometry(split, x, y, w, h)):
                    if cx >= ps.w or cy >= ps.h:
                        continue
                    child, ccost = self._rd_node(
                        cx, cy, cw, chh, part.child(split, idx, is_impl),
                        budget=limit - cost)
                    node.children.append(child)
                    cost += ccost
                    if cost >= limit:
                        aborted = True
                        break
                if aborted:
                    if split in bt_tried:
                        bt_tried[split] = True
                    continue
            if split in bt_tried:
                bt_tried[split] = True
                bt_improved[split] = cost < best_cost
            if cost < best_cost:
                best_node, best_cost = node, cost
                best_after = self._save(x, y, max(w, h))
        if best_node is None:
            # every candidate hit the inherited budget: the parent will
            # abort and discard; roll back and report an infinite cost
            self._restore(state0)
            return None, float("inf")
        self._restore(best_after)
        return best_node, best_cost

    # -- per-CU mode decision ---------------------------------------------
    def _rd_cu(self, x: int, y: int, w: int, h: int, part: PartInfo):
        if part.tree_type == CHROMA_TREE:
            return self._rd_cu_chroma(x, y, w, h, part)
        if self.coder.is_intra_slice:
            return self._rd_cu_intra(x, y, w, h, part)
        return self._rd_cu_inter(x, y, w, h, part)

    def _rd_cu_chroma(self, x: int, y: int, w: int, h: int, part: PartInfo):
        """CHROMA_TREE leaf (dual-tree intra): chroma mode + JCCR RD for
        the (x>>1, y>>1) chroma block of the luma-coordinate region; the
        winner is coded/reconstructed through the real chroma-CU writer
        (vvenc IntraSearch::estIntraPredChromaQT on the chroma pass)."""
        ps = self.ps
        cu = CuData(x, y, w, h)
        cu.chroma_only = True
        # DM derives from the co-located CENTER luma mode (VVC 8.4.3)
        cu.luma_mode = int(ps.intra_mode[(y + (h >> 1)) >> 2,
                                         (x + (w >> 1)) >> 2])
        cu.cclm_allowed = self.coder._cclm_allowed(ps, cu, part)
        self._rd_chroma(cu)
        b0 = self.est.frac_bits
        self.coder._enc_chroma_cu(self.est, ps, cu, part)
        bits = (self.est.frac_bits - b0) / (1 << 15)
        cx, cy2, cw, chh = x >> 1, y >> 1, w >> 1, h >> 1
        dist = 0.0
        for comp in (1, 2):
            dist += self.cw[comp] * R.sse_np(
                self.src[comp][cy2:cy2 + chh, cx:cx + cw],
                ps.rec[comp][cy2:cy2 + chh, cx:cx + cw])
        return cu, dist + self.lmbda * bits

    def _rd_cu_intra(self, x: int, y: int, w: int, h: int, part: PartInfo):
        ps = self.ps
        src_y = self.src[0][y:y + h, x:x + w]
        bit_depth = self.cfg.bit_depth
        lo = part.tree_type == TREE_L   # dual-tree luma pass: no chroma
        entry_snap = self._save(x, y, max(w, h))  # pre-CU state (ISP trials)

        top, left = I.build_reference_samples(
            ps.rec[0], x, y, w, h, ps.avail_luma(), PictureState.LUMA_UNIT,
            bit_depth)
        mpm = get_intra_mpms(ps, x, y, w, h, self.cfg.ctu_size)

        # EncModeCtrl save/load cache (vvenc BestEncInfoCache / saveLoadTag,
        # EncModeCtrl.h): a CU area revisited under a different parent
        # split order reuses the previous visit's winning modes instead of
        # re-running the full SATD preselection; the winners are re-RD'd
        # against the CURRENT context, so the result stays exact for the
        # chosen mode while skipping the wide sweep.
        ck = (x, y, w, h, part.tree_type)
        cached = self.mode_cache.get(ck) if self.cfg.mode_cache else None
        if cached is not None:
            full_modes = []
            for mode, mip_f, mip_t, ref_line in cached:
                if mip_f:
                    from ..ops import mip as MIPO
                    pred = MIPO.predict_mip(top[1:w + 1], left[1:h + 1],
                                            w, h, mode, mip_t, bit_depth)
                elif ref_line:
                    rt, rl = I.build_reference_samples(
                        ps.rec[0], x, y, w, h, ps.avail_luma(),
                        PictureState.LUMA_UNIT, bit_depth,
                        ref_idx=ref_line)
                    pred = I.predict_intra(rt, rl, mode, w, h, bit_depth,
                                           True, ref_idx=ref_line)
                else:
                    pred = I.predict_intra(top, left, mode, w, h,
                                           bit_depth, True)
                full_modes.append((0.0, mode, pred, mip_f, mip_t,
                                   ref_line))
        else:
            # SATD preselection over all modes (entry: cost, mode, pred,
            # mip_flag, mip_transposed) — either the frame-level device
            # table (source refs, ops/intra_presel.py) or one vectorized
            # host sweep (ops/intra_vec.py, bit-identical to the per-mode
            # scalar loop); predictions of device-ranked candidates are
            # materialized from the true references after ranking
            cand = []
            satds67 = preds67 = None
            if self._use_presel():
                satds67 = self._get_presel().lookup(x, y, w, h)

            def _mode_cost(mode, satd):
                mb = (1.5 + mpm.index(mode) if mode in mpm else 7.0)
                return float(satd) + self.lmbda_sad * mb
            if satds67 is not None:
                for mode in range(I.NUM_LUMA_MODE):
                    cand.append((_mode_cost(mode, int(satds67[mode])),
                                 mode, None, False, False, 0))
            else:
                from .. import native
                if native.available():
                    # decimated sweep + two refinement passes (vvenc
                    # xEstimateLumaRdModeList with IntraEstDecBit=2,
                    # IntraSearch.cpp:230-300: planar/DC + every 4th
                    # angular mode, then +-2 and +-1 around the
                    # strongest candidates) — ~18+4+4 fused native
                    # predict+SATD calls instead of 67
                    ent0 = []
                    seen = set()

                    def _sweep(modes):
                        sat = native.presel_satd(top, left, src_y,
                                                 modes, w, h, bit_depth)
                        ent0.extend((_mode_cost(m, int(sat[i])), m)
                                    for i, m in enumerate(modes))
                        seen.update(modes)
                    _sweep([0, 1] + list(range(4, I.NUM_LUMA_MODE, 4)))
                    top_k = self.cfg.num_full_rd_modes + 1
                    for step in (2, 1):
                        order0 = sorted(ent0, key=lambda t: t[0])
                        refine = []
                        for _, m in order0[:top_k]:
                            # VTM guard: no refinement around the
                            # planar/DC/edge-angular parents
                            if m <= 2 or m >= I.NUM_LUMA_MODE - 1:
                                continue
                            for nb in (m - step, m + step):
                                if 2 <= nb <= I.NUM_LUMA_MODE - 1 \
                                        and nb not in seen \
                                        and nb not in refine:
                                    refine.append(nb)
                        if refine:
                            _sweep(refine)
                    cand = [(c, m, None, False, False, 0) for c, m in ent0]
                else:
                    preds67 = IV.predict_intra_modes(
                        top, left, range(I.NUM_LUMA_MODE), w, h, bit_depth)
                    satds67 = IV.satd_modes(src_y, preds67)
                    for mode in range(I.NUM_LUMA_MODE):
                        cand.append((_mode_cost(mode, int(satds67[mode])),
                                     mode, preds67[mode], False, False, 0))
            if self.enc.sps.mip:
                from ..ops import mip as MIPO
                n_mip = MIPO.num_mip_modes(w, h)
                mip_bits = 2.0 + n_mip.bit_length() - 1
                mip_preds = MIPO.predict_mip_all_modes(
                    top[1:w + 1], left[1:h + 1], w, h, bit_depth)
                mip_satds = IV.satd_modes(
                    src_y, mip_preds.reshape(-1, h, w)).reshape(n_mip, 2)
                for m in range(n_mip):
                    for t in (False, True):
                        cand.append((int(mip_satds[m, int(t)])
                                     + self.lmbda_sad * mip_bits, m,
                                     mip_preds[m, int(t)], True, t, 0))
            if self.enc.sps.mrl and (y % self.cfg.ctu_size) != 0:
                for line in (1, 2):
                    rt, rl = I.build_reference_samples(
                        ps.rec[0], x, y, w, h, ps.avail_luma(),
                        PictureState.LUMA_UNIT, bit_depth, ref_idx=line)
                    mrl_modes = [(mi, mpm[mi]) for mi in range(1, 6)
                                 if mpm[mi] != I.PLANAR_IDX]
                    mrl_preds = IV.predict_intra_modes(
                        rt, rl, [m for _, m in mrl_modes], w, h, bit_depth,
                        ref_idx=line)
                    mrl_satds = IV.satd_modes(src_y, mrl_preds)
                    for i, (mi, mode) in enumerate(mrl_modes):
                        cand.append((int(mrl_satds[i])
                                     + self.lmbda_sad * (2.5 + mi),
                                     mode, mrl_preds[i], False, False, line))
            cand.sort(key=lambda t: t[0])
            n_full = self.cfg.num_full_rd_modes
            full_modes = cand[:n_full]
            # ensure planar is tested (cheap DC of list)
            if all(m != I.PLANAR_IDX or mf or rl
                   for _, m, _, mf, _, rl in full_modes):
                full_modes.append(next(t for t in cand
                                       if t[1] == I.PLANAR_IDX and not t[3]
                                       and not t[5]))
            # device-ranked entries carry no prediction: materialize the
            # chosen few from the true reconstructed references
            miss = [i for i, t in enumerate(full_modes) if t[2] is None]
            if miss:
                mp = IV.predict_intra_modes(
                    top, left, [full_modes[i][1] for i in miss], w, h,
                    bit_depth)
                for j, i in enumerate(miss):
                    c_, m_, _, mf_, mt_, rl_ = full_modes[i]
                    full_modes[i] = (c_, m_, mp[j], mf_, mt_, rl_)

        qy = self.qp.luma_qp()
        est_snap = self.est.snapshot()
        best = None
        sps = self.enc.sps

        def trial_tail(cu, rec, dist, ts_ok):
            """Estimate the CU's luma bits and keep the best trial."""
            nonlocal best
            self.est.restore(est_snap)
            b0 = self.est.frac_bits
            self._est_cu_luma_syntax(cu, mpm)
            self.est.encode_bin(1 if cu.coeff_y is not None else 0,
                                ct.CTX_SETS["QtCbfLuma"](0))
            if cu.coeff_y is not None:
                if ts_ok:
                    self.est.encode_bin(
                        1 if cu.ts_y else 0,
                        ct.CTX_SETS["TransformSkipFlag"](0))
                if cu.ts_y:
                    from ..bitstream.residual import encode_residual_ts
                    encode_residual_ts(self.est, cu.coeff_y, True)
                else:
                    encode_residual(self.est, cu.coeff_y, True,
                                    dep_quant=self.cfg.dep_quant,
                                    sign_hiding=self.cfg.sign_data_hiding)
                self.coder._code_lfnst_mts(self.est, cu, encode=True)
            bits = (self.est.frac_bits - b0) / (1 << 15)
            cost = dist + self.lmbda * bits
            if best is None or cost < best[0]:
                best = (cost, cu, rec)
        for cand_i, (_, mode, pred, mip_f, mip_t, ref_line) in \
                enumerate(full_modes):
            resi = src_y - pred
            # transform variants: (lfnst_idx, mts_idx, ts); extra variants
            # only for the strongest SATD candidate to bound the search
            variants = [(0, 0, False)]
            if cand_i == 0 and sps.lfnst and w >= 4 and h >= 4 \
                    and not (mip_f and not (w >= 16 and h >= 16)):
                variants += [(1, 0, False), (2, 0, False)]
            if cand_i == 0 and getattr(sps, "mts_intra", 0) \
                    and w <= 32 and h <= 32 and not mip_f:
                variants += [(0, m, False) for m in (1, 2, 3, 4)]
            ts_ok = (getattr(sps, "transform_skip", 0)
                     and w <= self.coder.max_ts_size
                     and h <= self.coder.max_ts_size)
            if ts_ok:
                variants.append((0, 0, True))
            impl_on = self.coder.implicit_mts and not mip_f
            th_i, tv_i = T.implicit_mts_types(w, h, True, impl_on)
            use_ntq = self._native_tq()
            prim_dct2 = prim_main = None
            if not use_ntq or any(v[0] for v in variants):
                prim_dct2 = T.fwd_transform_np(resi, bit_depth)
            if not use_ntq:
                prim_main = prim_dct2 if (th_i, tv_i) == (T.DCT2, T.DCT2) \
                    else T.fwd_transform_np(resi, bit_depth, th_i, tv_i)
            for lfnst_i, mts_i, ts_f in variants:
                _ss_bump("intra_luma_trial")
                if use_ntq and not ts_f and not lfnst_i:
                    # fused native trial: fwd transform + RDOQ(+SDH) +
                    # dequant + inverse + recon + SSE in one call
                    from .. import native
                    trh_v, trv_v = T.mts_tr_types(mts_i) if mts_i \
                        else (th_i, tv_i)
                    dq_f = bool(self.cfg.dep_quant)
                    coeff_n, rec, dist = native.tq_trial(
                        resi, pred, src_y, trh_v, trv_v, qy, bit_depth,
                        True, self.lmbda, self.est.ctx,
                        ct.CTX_SETS["QtCbfLuma"](0),
                        self.cfg.sign_data_hiding and not dq_f, dq=dq_f)
                    cu = CuData(x, y, w, h, luma_mode=mode, mip_flag=mip_f,
                                mip_transposed=mip_t, ref_line=ref_line,
                                lfnst_idx=0, mts_idx=mts_i, luma_only=lo,
                                ts_y=False)
                    cu.coeff_y = coeff_n
                    if coeff_n is None:
                        cu.mts_idx = 0
                    if cu.mts_idx:
                        _, _, mts_last, mts_viol = \
                            self.coder._residual_tool_stats(cu)
                        if mts_viol or not mts_last:
                            continue
                    trial_tail(cu, rec, dist, ts_ok)
                    continue
                if ts_f:
                    tcoef = None
                    coeff = T.quant_ts_np(resi, qy, self.coder.min_qp_ts)
                elif mts_i:
                    tcoef = T.fwd_transform_np(resi, bit_depth,
                                               *T.mts_tr_types(mts_i))
                elif lfnst_i:
                    from ..ops.lfnst import fwd_lfnst
                    lmode = I.PLANAR_IDX if mip_f else mode
                    tcoef = prim_dct2.copy()
                    tcoef[:min(h, 8), :] = tcoef[:min(h, 8), :]
                    # coefficients outside the LFNST region must be zero
                    tcoef2 = np.zeros_like(tcoef)
                    tcoef2[:min(h, 8), :min(w, 8)] = tcoef[:min(h, 8),
                                                           :min(w, 8)]
                    tcoef = fwd_lfnst(tcoef2, w, h, lmode, lfnst_i)
                else:
                    tcoef = prim_main
                if not ts_f:
                    coeff = self._q(tcoef, qy, True,
                                    ct.CTX_SETS["QtCbfLuma"](0))
                cu = CuData(x, y, w, h, luma_mode=mode, mip_flag=mip_f,
                            mip_transposed=mip_t, ref_line=ref_line,
                            lfnst_idx=lfnst_i, mts_idx=mts_i,
                            luma_only=lo,
                            ts_y=ts_f and bool(np.any(coeff)))
                if np.any(coeff):
                    cu.coeff_y = coeff
                else:
                    cu.lfnst_idx = cu.mts_idx = 0
                # drop variants whose signaling constraints fail
                if cu.lfnst_idx or cu.mts_idx:
                    viol, lf_last, mts_last, mts_viol = \
                        self.coder._residual_tool_stats(cu)
                    if cu.lfnst_idx and (viol or not lf_last):
                        continue
                    if cu.mts_idx and (mts_viol or not mts_last):
                        continue
                if cu.coeff_y is not None:
                    if cu.ts_y:
                        rec = np.clip(
                            pred + T.dequant_ts_np(cu.coeff_y, qy,
                                                   self.coder.min_qp_ts),
                            0, (1 << bit_depth) - 1)
                    else:
                        d = self._dq(cu.coeff_y, qy)
                        if cu.lfnst_idx:
                            from ..ops.lfnst import inv_lfnst
                            lmode = I.PLANAR_IDX if mip_f else mode
                            d = inv_lfnst(d, w, h, lmode, cu.lfnst_idx)
                        if cu.mts_idx:
                            trh, trv = T.mts_tr_types(cu.mts_idx)
                        elif cu.lfnst_idx:
                            trh = trv = T.DCT2
                        else:
                            trh, trv = th_i, tv_i
                        rec = np.clip(
                            pred + T.inv_transform_np(d, bit_depth, trh,
                                                      trv), 0,
                            (1 << bit_depth) - 1)
                else:
                    rec = pred
                dist = R.sse_np(src_y, rec)
                trial_tail(cu, rec, dist, ts_ok)
        cost, cu, rec_y = best
        if cached is None and self.cfg.mode_cache:
            ent = [(cu.luma_mode, cu.mip_flag, cu.mip_transposed,
                    cu.ref_line)]
            for _, m_, _, mf_, mt_, rl_ in full_modes:
                t_ = (m_, mf_, mt_, rl_)
                if t_ not in ent:
                    ent.append(t_)
                if len(ent) >= 3:
                    break
            self.mode_cache[ck] = ent

        # chroma mode decision: DM + CCLM modes (+ candidate-list modes).
        # CCLM reads the co-located reconstructed luma, so stage the luma
        # reconstruction of this CU into the picture state first (finish_cu
        # redoes it identically later).
        ps.rec[0][y:y + h, x:x + w] = rec_y
        if not lo:
            self._rd_chroma(cu)

        # chroma residuals can retract LFNST signalability (corner
        # violation / DC-only): fall back to the primary-only transform
        if cu.lfnst_idx and not lo:
            viol, lf_last, _, _ = self.coder._residual_tool_stats(cu)
            if viol or not lf_last:
                cu.lfnst_idx = 0
                pred0 = next(p_ for _, m_, p_, mf_, mt_, rl_ in full_modes
                             if m_ == cu.luma_mode and mf_ == cu.mip_flag
                             and mt_ == cu.mip_transposed
                             and rl_ == cu.ref_line)
                th0, tv0 = T.implicit_mts_types(
                    w, h, True, self.coder.implicit_mts and not cu.mip_flag)
                cu.coeff_y = self._tq(src_y - pred0, qy, True,
                                      ct.CTX_SETS["QtCbfLuma"](0),
                                      th0, tv0)
                if cu.coeff_y is not None:
                    d = self._dq(cu.coeff_y, qy)
                    ps.rec[0][y:y + h, x:x + w] = np.clip(
                        pred0 + T.inv_transform_np(d, bit_depth, th0, tv0),
                        0, (1 << bit_depth) - 1)
                else:
                    ps.rec[0][y:y + h, x:x + w] = pred0
                # the luma reconstruction changed: redo the chroma decision
                # so CCLM predicts from what the decoder will see
                self._rd_chroma(cu)

        # re-encode the full chosen CU syntax into the running estimator
        self.est.restore(est_snap)
        b0 = self.est.frac_bits
        self._est_cu_luma_syntax(cu, mpm)
        if not lo:
            self.coder._enc_intra_chroma_mode(self.est, cu)
            if cu.joint_cbcr:
                cbf_cb = bool(cu.joint_cbcr & 2)
                cbf_cr = bool(cu.joint_cbcr & 1)
            else:
                cbf_cb = cu.coeff_cb is not None
                cbf_cr = cu.coeff_cr is not None
            self.est.encode_bin(1 if cbf_cb else 0,
                                ct.CTX_SETS["QtCbfCb"](0))
            self.est.encode_bin(1 if cbf_cr else 0,
                                ct.CTX_SETS["QtCbfCr"](1 if cbf_cb else 0))
            mask_ = (2 if cbf_cb else 0) + (1 if cbf_cr else 0)
            if self.enc.sps.joint_cbcr and mask_:
                self.est.encode_bin(1 if cu.joint_cbcr else 0,
                                    ct.CTX_SETS["JointCbCrFlag"](mask_ - 1))
        self.est.encode_bin(1 if cu.coeff_y is not None else 0,
                            ct.CTX_SETS["QtCbfLuma"](0))
        if cu.coeff_y is not None:
            if cu.ts_y:
                from ..bitstream.residual import encode_residual_ts
                encode_residual_ts(self.est, cu.coeff_y, True)
            else:
                encode_residual(self.est, cu.coeff_y, True,
                                dep_quant=self.cfg.dep_quant,
                                sign_hiding=self.cfg.sign_data_hiding)
        if not lo:
            if cu.joint_cbcr:
                coded = cu.coeff_cb if cu.joint_cbcr in (2, 3) \
                    else cu.coeff_cr
                encode_residual(self.est, coded, False,
                                dep_quant=self.cfg.dep_quant,
                                sign_hiding=self.cfg.sign_data_hiding)
            else:
                for comp, coeff in ((1, cu.coeff_cb), (2, cu.coeff_cr)):
                    if coeff is not None:
                        encode_residual(
                            self.est, coeff, False,
                            dep_quant=self.cfg.dep_quant,
                            sign_hiding=self.cfg.sign_data_hiding)
        self.coder._code_lfnst_mts(self.est, cu, encode=True)
        total_bits = (self.est.frac_bits - b0) / (1 << 15)

        # reconstruct CU into scratch state (also computes chroma rec + SSE)
        self.coder.finish_cu(ps, cu, part.qt_depth,
                             comps=(0,) if lo else (0, 1, 2))
        dist = R.sse_np(src_y, ps.rec[0][y:y + h, x:x + w])
        for comp in () if lo else (1, 2):
            cx, cy2, cw, chh = x >> 1, y >> 1, w >> 1, h >> 1
            dist += self.cw[comp] * R.sse_np(
                self.src[comp][cy2:cy2 + chh, cx:cx + cw],
                ps.rec[comp][cy2:cy2 + chh, cx:cx + cw])
        total_cost = dist + self.lmbda * total_bits

        # IBC competition (SCC tool: block copy from the coded area of the
        # current picture; trials evaluated through the real writer)
        if self.coder.ibc_en and w < 128 and h < 128 \
                and self.coder.is_intra_slice:
            cur_state = self._save(x, y, max(w, h))
            ibc_cu, ibc_cost = self._rd_ibc(x, y, w, h, part, entry_snap)
            if ibc_cu is not None and ibc_cost < total_cost:
                cu, total_cost = ibc_cu, ibc_cost
            else:
                self._restore(cur_state)

        # BDPCM competition (SCC tool: DPCM-coded transform-skip residual
        # on a pure horizontal/vertical fill prediction)
        if self.coder.bdpcm_en and self.coder.is_intra_slice \
                and w <= self.coder.max_ts_size \
                and h <= self.coder.max_ts_size:
            cur_state = self._save(x, y, max(w, h))
            bd_cu, bd_cost = self._rd_bdpcm(x, y, w, h, part, entry_snap)
            if bd_cu is not None and bd_cost < total_cost:
                cu, total_cost = bd_cu, bd_cost
            else:
                self._restore(cur_state)

        # ISP competition on the winning mode (vvenc IntraSearch ISP loop)
        isp_probe = CuData(x, y, w, h, luma_mode=cu.luma_mode)
        if getattr(self.enc.sps, "isp", 0) and self.coder.is_intra_slice \
                and not cu.mip_flag and not cu.ref_line \
                and self.coder._isp_coded(isp_probe):
            best_state = self._save(x, y, max(w, h))
            isp_cu, isp_cost = self._rd_isp(x, y, w, h, cu.luma_mode, mpm,
                                            part, entry_snap,
                                            best_in=total_cost)
            if isp_cu is not None and isp_cost < total_cost:
                cu, total_cost = isp_cu, isp_cost  # state already staged
            else:
                self._restore(best_state)
        return cu, total_cost

    def _rd_ibc(self, x, y, w, h, part, entry_snap):
        """IBC trial: BV candidates from the IBC merge list + a causal-area
        scanline search (current + left CTU, vvenc's reference window);
        skip / merge / AMVP variants evaluated through the real writer.
        Leaves the winner staged; returns (cu, cost) or (None, inf)."""
        from ..codec.motion import (get_ibc_merge_candidates,
                                    get_ibc_amvp_candidates)
        coder, ps, cfg = self.coder, self.ps, self.cfg
        ctu = cfg.ctu_size
        src_y = self.src[0][y:y + h, x:x + w]

        def bv_valid(bx, by):
            tx, ty = x + bx, y + by
            if tx < 0 or ty < 0 or tx + w > ps.w or ty + h > ps.h:
                return False
            if ty + h > y and tx + w > x and ty < y + h and tx < x + w:
                return False  # overlaps the current block
            # reference window: current + left CTU, same CTU row
            if ty < (y // ctu) * ctu or ty + h > min(ps.h,
                                                     (y // ctu + 1) * ctu):
                return False
            if tx < max(0, (x // ctu - 1) * ctu):
                return False
            # fully reconstructed
            m = ps.avail_luma()[ty >> 2:(ty + h) >> 2,
                                tx >> 2:(tx + w) >> 2]
            return bool(m.all())

        merge_cands = get_ibc_merge_candidates(ps, coder.mf,
                                               coder.hmvp_ibc, x, y, w, h,
                                               coder.max_ibc_merge)
        cand = []
        for i, bv in enumerate(merge_cands):
            if bv is None:
                continue
            bx, by = bv[0] >> 4, bv[1] >> 4
            if (bx or by) and bv_valid(bx, by):
                cand.append((bx, by, i))
        # scanline search left / above (integer pel)
        for bx in range(-w, -min(2 * ctu, x + w) - 1, -4):
            if bv_valid(bx, 0):
                cand.append((bx, 0, -1))
        for by in range(-h, -min(ctu, y + h) - 1, -4):
            if bv_valid(0, by):
                cand.append((0, by, -1))
        if not cand:
            return None, float("inf")
        best_bv = min(cand, key=lambda c: R.sse_np(
            src_y, ps.rec[0][y + c[1]:y + c[1] + h,
                             x + c[0]:x + c[0] + w]))

        trials = []
        bx, by, midx = best_bv
        if midx >= 0:
            # skip + merge trials reuse the candidate list index
            trials.append(CuData(x, y, w, h, is_inter=True, is_ibc=True,
                                 skip=True, merge=True, merge_idx=midx,
                                 mv=((bx << 4, by << 4), (0, 0)),
                                 ref_idx=(-1, -1), root_cbf=False))
        # AMVP trial: BVD against the IBC AMVP list
        imv = 1 if coder.amvr else 0
        amvp = get_ibc_amvp_candidates(ps, coder.mf, coder.hmvp_ibc,
                                       x, y, w, h, imv)
        sh = 4
        mvp_idx = 0
        mvd = ((bx << 4) - amvp[0][0] >> sh, (by << 4) - amvp[0][1] >> sh)
        mv0 = (amvp[0][0] + (mvd[0] << sh), amvp[0][1] + (mvd[1] << sh))
        if mvd != (0, 0) and bv_valid(mv0[0] >> 4, mv0[1] >> 4):
            cu = CuData(x, y, w, h, is_inter=True, is_ibc=True,
                        merge=False, mv=(mv0, (0, 0)), ref_idx=(-1, -1),
                        mvd=mvd, mvp_idx=mvp_idx,
                        imv=imv if coder.amvr else 0)
            # residual against the block-copy prediction
            pred = ps.rec[0][y + (mv0[1] >> 4):y + (mv0[1] >> 4) + h,
                             x + (mv0[0] >> 4):x + (mv0[0] >> 4) + w]
            qy = self.qp.luma_qp()
            cu.coeff_y = self._tq(src_y - pred, qy, True, None,
                                  intra_slice=False)
            cu.root_cbf = cu.coeff_y is not None
            trials.append(cu)
        if not trials:
            return None, float("inf")

        best = (None, float("inf"))
        best_state = None
        node = TreeNode(x, y, max(w, h), part.qt_depth, w=w, h=h,
                        part=part)
        for cu in trials:
            self._restore(entry_snap)
            b0 = self.est.frac_bits
            node.cu = cu
            try:
                coder._enc_cu(self.est, ps, node)
            except AssertionError:
                continue
            bits = (self.est.frac_bits - b0) / (1 << 15)
            dist = R.sse_np(src_y, ps.rec[0][y:y + h, x:x + w])
            cx, cy2, cw, chh = x >> 1, y >> 1, w >> 1, h >> 1
            for comp in () if part.tree_type == TREE_L else (1, 2):
                dist += R.sse_np(self.src[comp][cy2:cy2 + chh,
                                                cx:cx + cw],
                                 ps.rec[comp][cy2:cy2 + chh, cx:cx + cw])
            cost = dist + self.lmbda * bits
            if cost < best[1]:
                best = (cu, cost)
                best_state = self._save(x, y, max(w, h))
        if best[0] is not None:
            self._restore(best_state)
        return best

    def _rd_bdpcm(self, x, y, w, h, part, entry_snap):
        """BDPCM trial (modes 1=horizontal, 2=vertical): TS-quantized
        residual of the directional fill prediction, DPCM-coded levels.
        Leaves the winner staged; returns (cu, cost) or (None, inf)."""
        from ..bitstream.residual import encode_residual_ts
        from ..codec.ctu_syntax import HOR, VER
        ps, bd = self.ps, self.cfg.bit_depth
        qy = self.qp.luma_qp()
        maxval = (1 << bd) - 1
        src_y = self.src[0][y:y + h, x:x + w]
        best = (None, float("inf"))
        best_state = None
        lo = part.tree_type == TREE_L
        for m in (1, 2):
            self._restore(entry_snap)
            cu = CuData(x, y, w, h, bdpcm_y=m, luma_only=lo,
                        luma_mode=(VER if m == 2 else HOR), ts_y=True)
            pred = predict_cu_component(ps, cu, 0, bd, self.cfg.ctu_size)
            levels = T.quant_ts_np(src_y - pred, qy, self.coder.min_qp_ts)
            coded = T.fwd_res_dpcm(levels, m)
            cu.coeff_y = coded if np.any(coded) else None
            if cu.coeff_y is not None:
                rec = np.clip(pred + T.dequant_ts_np(
                    T.inv_res_dpcm(coded, m), qy, self.coder.min_qp_ts),
                    0, maxval)
            else:
                rec = pred
            ps.rec[0][y:y + h, x:x + w] = rec
            if not lo:
                self._rd_chroma(cu)
            b0 = self.est.frac_bits
            self.est.encode_bin(1, ct.CTX_SETS["BDPCMMode"](0))
            self.est.encode_bin(1 if m > 1 else 0,
                                ct.CTX_SETS["BDPCMMode"](1))
            if not lo:
                self.coder._enc_intra_chroma_mode(self.est, cu)
            self.est.encode_bin(1 if cu.coeff_y is not None else 0,
                                ct.CTX_SETS["QtCbfLuma"](1))
            if cu.coeff_y is not None:
                encode_residual_ts(self.est, cu.coeff_y, True, bdpcm=m)
            bits = (self.est.frac_bits - b0) / (1 << 15)
            self.coder.finish_cu(ps, cu, part.qt_depth,
                                 comps=(0,) if lo else (0, 1, 2))
            dist = R.sse_np(src_y, ps.rec[0][y:y + h, x:x + w])
            cx, cy2, cw, chh = x >> 1, y >> 1, w >> 1, h >> 1
            for comp in () if lo else (1, 2):
                dist += R.sse_np(self.src[comp][cy2:cy2 + chh, cx:cx + cw],
                                 ps.rec[comp][cy2:cy2 + chh, cx:cx + cw])
            cost = dist + self.lmbda * bits
            if cost < best[1]:
                best = (cu, cost)
                best_state = self._save(x, y, max(w, h))
        if best[0] is not None:
            self._restore(best_state)
        return best

    def _rd_isp(self, x, y, w, h, mode, mpm, part, entry_snap,
                best_in=float("inf")):
        """ISP (intra sub-partition) trial for one luma mode: sequential
        per-part predict/transform/quant/reconstruct (mirror of
        _reconstruct_isp_luma), chroma decision on the staged luma, cost
        via the real ISP TU syntax.  Leaves the winning trial's state
        staged and returns (cu, cost), or (None, inf)."""
        from ..codec.ctu_syntax import isp_partitions, isp_predict_part
        cfg = self.cfg
        ps = self.ps
        bd = cfg.bit_depth
        qy = self.qp.luma_qp()
        maxval = (1 << bd) - 1
        best = (None, float("inf"))
        best_state = None
        lo = part.tree_type == TREE_L
        for m in (1, 2):
            self._restore(entry_snap)
            parts = isp_partitions(w, h, m)
            coeffs = []
            region_cache = {}
            # per-direction LOWER-BOUND abort (vvenc ISP sub-partition
            # early termination): accumulated luma distortion alone
            # already exceeding the best total cost makes this direction
            # unwinnable (bits >= 0) — decision-identical pruning
            bound = min(best_in, best[1])
            dist_part = 0.0
            aborted = False
            for px, py_, pw, ph in parts:
                ax, ay = x + px, y + py_
                pred = isp_predict_part(ps, x, y, w, h, m, mode, bd,
                                        px, py_, pw, ph, region_cache)
                resi = self.src[0][ay:ay + ph, ax:ax + pw] - pred
                trh, trv = T.isp_tr_types(pw, ph, 0,
                                          bool(self.enc.sps.mts))
                c = self._tq(resi, qy, True, None, trh, trv)
                coeffs.append(c)
                if c is not None:
                    d = self._dq(c, qy)
                    rec = np.clip(pred + T.inv_transform_np(d, bd, trh,
                                                            trv),
                                  0, maxval)
                else:
                    rec = pred
                ps.rec[0][ay:ay + ph, ax:ax + pw] = rec
                dist_part += R.sse_np(
                    self.src[0][ay:ay + ph, ax:ax + pw], rec)
                if dist_part > bound:
                    aborted = True
                    break
            if aborted:
                continue
            # invalid if the (inferred-1) last cbf has no coefficients
            if all(c is None for c in coeffs[:-1]) and coeffs[-1] is None:
                continue
            cu2 = CuData(x, y, w, h, luma_mode=mode, isp_mode=m,
                         isp_coeffs=coeffs, luma_only=lo)
            if not lo:
                self._rd_chroma(cu2)
            b0 = self.est.frac_bits
            self._est_cu_luma_syntax(cu2, mpm)
            self.est.encode_bin(1, ct.CTX_SETS["ISPMode"](0))
            self.est.encode_bin(m - 1, ct.CTX_SETS["ISPMode"](1))
            if not lo:
                self.coder._enc_intra_chroma_mode(self.est, cu2)
            self.coder._code_isp_tus(self.est, cu2, encode=True)
            self.coder._code_lfnst_mts(self.est, cu2, encode=True)
            bits = (self.est.frac_bits - b0) / (1 << 15)
            self.coder.finish_cu(ps, cu2, part.qt_depth,
                                 comps=(0,) if lo else (0, 1, 2))
            dist = R.sse_np(self.src[0][y:y + h, x:x + w],
                            ps.rec[0][y:y + h, x:x + w])
            cx, cy2, cw, chh = x >> 1, y >> 1, w >> 1, h >> 1
            for comp in () if lo else (1, 2):
                dist += self.cw[comp] * R.sse_np(
                    self.src[comp][cy2:cy2 + chh, cx:cx + cw],
                    ps.rec[comp][cy2:cy2 + chh, cx:cx + cw])
            cost = dist + self.lmbda * bits
            if cost < best[1]:
                best = (cu2, cost)
                best_state = self._save(x, y, max(w, h))
        if best[0] is not None:
            self._restore(best_state)
        return best

    def _rd_chroma(self, cu: CuData) -> None:
        """Chroma mode RD: DM + CCLM/MDLM (+ the 4-entry candidate list when
        it differs from DM), plus joint Cb-Cr (JCCR) trials on the winner.
        Sets cu.chroma_dir/coeff_cb/coeff_cr/joint_cbcr.

        vvenc IntraSearch::estIntraPredChromaQT analog (IntraSearch.h:178):
        per candidate mode, full transform/quant + SSE + estimated bits."""
        from ..codec.ctu_syntax import chroma_cand_modes, dm_luma_mode
        from ..codec.cclm import (LM_CHROMA_IDX, MDLM_L_IDX, MDLM_T_IDX,
                                  CCLM_MODES)
        ps, bit_depth = self.ps, self.cfg.bit_depth
        x, y, w, h = cu.x, cu.y, cu.w, cu.h
        cx, cy2, cw, chh = x >> 1, y >> 1, w >> 1, h >> 1
        srcs = {c: self.src[c][cy2:cy2 + chh, cx:cx + cw] for c in (1, 2)}
        jccr_on = bool(self.enc.sps.joint_cbcr)
        cands = [DM_CHROMA]
        if self.enc.sps.cclm:
            cands += [LM_CHROMA_IDX, MDLM_L_IDX, MDLM_T_IDX]
            dm = dm_luma_mode(cu)
            cands += [m for m in chroma_cand_modes(dm) if m != dm]
        snap = self.est.snapshot()

        def chroma_bits(coded, mask):
            """Estimated chroma syntax bits for one trial.
            mask: JCCR cbf mask (0 = separate coding, coded = {1: cb, 2: cr}
            or single coded residual)."""
            self.est.restore(snap)
            b0 = self.est.frac_bits
            self.coder._enc_intra_chroma_mode(self.est, cu)
            if mask:
                cbf_cb, cbf_cr = bool(mask & 2), bool(mask & 1)
            else:
                cbf_cb = coded[1] is not None
                cbf_cr = coded[2] is not None
            self.est.encode_bin(1 if cbf_cb else 0,
                                ct.CTX_SETS["QtCbfCb"](0))
            self.est.encode_bin(1 if cbf_cr else 0,
                                ct.CTX_SETS["QtCbfCr"](1 if cbf_cb else 0))
            cm = (2 if cbf_cb else 0) + (1 if cbf_cr else 0)
            if jccr_on and cm:
                self.est.encode_bin(1 if mask else 0,
                                    ct.CTX_SETS["JointCbCrFlag"](cm - 1))
            if mask:
                encode_residual(self.est, coded, False,
                                dep_quant=self.cfg.dep_quant)
            else:
                for comp in (1, 2):
                    if coded[comp] is not None:
                        encode_residual(self.est, coded[comp], False,
                                        dep_quant=self.cfg.dep_quant,
                                        sign_hiding=self.cfg.sign_data_hiding)
            return (self.est.frac_bits - b0) / (1 << 15)

        cscale = self._chroma_scale(x, y, cw, chh)

        def _fwd_scale(resi):
            if cscale is None:
                return resi
            from ..codec.lmcs import scale_chroma_resi_fwd
            return scale_chroma_resi_fwd(np.asarray(resi, np.int64),
                                         cscale, bit_depth)

        def _inv_scale(resi):
            if cscale is None:
                return resi
            from ..codec.lmcs import scale_chroma_resi_inv
            return scale_chroma_resi_inv(np.asarray(resi, np.int64),
                                         cscale, bit_depth)

        # batch the candidate predictions per component: one vectorized
        # angular sweep over shared references, and one shared-downsample
        # CCLM pass for all LM modes x components (BDPCM stays on the
        # scalar model)
        pred_cache = {}
        if not cu.bdpcm_c:
            ang = []
            for cdir_ in cands:
                if cdir_ not in CCLM_MODES:
                    m_ = dm_luma_mode(cu) if cdir_ == DM_CHROMA else cdir_
                    if m_ not in ang:
                        ang.append(m_)
            if ang:
                for comp in (1, 2):
                    rt, rl = I.build_reference_samples(
                        ps.rec[comp], cx, cy2, cw, chh, ps.avail_chroma(),
                        PictureState.CHROMA_UNIT, bit_depth)
                    cpreds = IV.predict_intra_modes(rt, rl, ang, cw, chh,
                                                    bit_depth, is_luma=False)
                    for m_, p_ in zip(ang, cpreds):
                        pred_cache[(comp, m_)] = p_
            lm_modes = [m for m in cands if m in CCLM_MODES]
            if lm_modes:
                from ..codec.cclm import cclm_predict_many
                for (m_, comp), p_ in cclm_predict_many(
                        ps, cu, bit_depth, self.cfg.ctu_size,
                        lm_modes).items():
                    pred_cache[(comp, ("lm", m_))] = p_

        def _pred_for(cdir_, comp):
            if cu.bdpcm_c:
                return predict_cu_component(ps, cu, comp, bit_depth,
                                            self.cfg.ctu_size)
            if cdir_ in CCLM_MODES:
                return pred_cache[(comp, ("lm", cdir_))]
            m_ = dm_luma_mode(cu) if cdir_ == DM_CHROMA else cdir_
            return pred_cache[(comp, m_)]

        def _pred_comp(comp):
            return _pred_for(cu.chroma_dir, comp)

        # SATD preselection: full-RD only the strongest K candidates
        # (vvenc estIntraPredChromaQT mode reduction; DM always kept)
        n_ch = self.cfg.num_chroma_rd_modes
        if not cu.bdpcm_c and n_ch and len(cands) > n_ch:
            use_satd = (cw % 4 == 0) and (chh % 4 == 0)
            tot = np.zeros(len(cands), np.int64)
            for comp in (1, 2):
                preds = np.stack([_pred_for(c_, comp) for c_ in cands])
                if use_satd:
                    tot += IV.satd_modes(srcs[comp], preds)
                else:
                    tot += np.abs(srcs[comp].astype(np.int64)
                                  - preds).sum(axis=(1, 2))
            scored = sorted(zip(tot.tolist(), cands))
            kept = [m for _, m in scored[:n_ch]]
            if DM_CHROMA not in kept:
                kept.append(DM_CHROMA)
            cands = kept

        best = None
        preds_best = None
        for cdir in cands:
            _ss_bump("intra_chroma_trial")
            cu.chroma_dir = cdir
            dist = 0.0
            coeffs, preds = {}, {}
            for comp in (1, 2):
                pred = _pred_comp(comp)
                preds[comp] = pred
                qc = self.qp.chroma_qp(comp)
                cbf_ctx = ct.CTX_SETS["QtCbfCb"](0) if comp == 1 else \
                    ct.CTX_SETS["QtCbfCr"](1 if coeffs[1] is not None else 0)
                w_ = self.cw[comp]
                if cscale is None and self._native_tq():
                    from .. import native
                    dq_f = bool(self.cfg.dep_quant)
                    coeffs[comp], rec, d_ = native.tq_trial(
                        srcs[comp].astype(np.int64) - pred, pred,
                        srcs[comp], T.DCT2, T.DCT2, qc, bit_depth, False,
                        self.lmbda / w_, self.est.ctx, cbf_ctx,
                        self.cfg.sign_data_hiding and not dq_f, dq=dq_f)
                    dist += w_ * d_
                    continue
                coeff = self._q(
                    T.fwd_transform_np(_fwd_scale(srcs[comp] - pred),
                                       bit_depth), qc,
                    False, cbf_ctx, lmbda=self.lmbda / w_)
                if np.any(coeff):
                    coeffs[comp] = coeff
                    rec = np.clip(pred + _inv_scale(T.inv_transform_np(
                        self._dq(coeff, qc), bit_depth)), 0,
                        (1 << bit_depth) - 1)
                else:
                    coeffs[comp] = None
                    rec = pred
                dist += w_ * R.sse_np(srcs[comp], rec)
            cost = dist + self.lmbda * chroma_bits(coeffs, 0)
            if best is None or cost < best[0]:
                best = (cost, cdir, coeffs[1], coeffs[2], 0)
                preds_best = preds

        # JCCR trials on the winning mode (vvenc tests joint modes in the
        # chroma RD loop; we bound it to the best separate mode)
        if jccr_on:
            from ..codec.ctu_syntax import _ict_derive
            cu.chroma_dir = best[1]
            sign_flag = self.coder.jccr_sign
            s = -1 if sign_flag else 1
            res = {c: _fwd_scale(srcs[c].astype(np.int64) - preds_best[c])
                   for c in (1, 2)}
            for mask in (3, 2, 1):
                if mask == 3:
                    coded_res = (res[1] + s * res[2]) >> 1
                    qc = self.qp.joint_qp()
                elif mask == 2:
                    coded_res = (4 * res[1] + 2 * s * res[2]) // 5
                    qc = self.qp.chroma_qp(1)
                else:
                    coded_res = (4 * res[2] + 2 * s * res[1]) // 5
                    qc = self.qp.chroma_qp(2)
                cbf_ctx = ct.CTX_SETS["QtCbfCb"](0) if mask & 2 else \
                    ct.CTX_SETS["QtCbfCr"](0)
                wj = self.cw[1] if mask & 2 else self.cw[2]
                coeff = self._tq(coded_res, qc, False, cbf_ctx,
                                 lmbda=self.lmbda / wj)
                if coeff is None:
                    continue
                r = T.inv_transform_np(self._dq(coeff, qc), bit_depth)
                rcb, rcr = _ict_derive(r.astype(np.int64), mask, sign_flag)
                dist = 0.0
                for comp, rr in ((1, _inv_scale(rcb)), (2, _inv_scale(rcr))):
                    rec = np.clip(preds_best[comp] + rr, 0,
                                  (1 << bit_depth) - 1)
                    dist += self.cw[comp] * R.sse_np(srcs[comp], rec)
                cost = dist + self.lmbda * chroma_bits(coeff, mask)
                if cost < best[0]:
                    cb = coeff if mask in (2, 3) else None
                    cr = coeff if mask == 1 else None
                    best = (cost, best[1], cb, cr, mask)

        self.est.restore(snap)
        _, cu.chroma_dir, cu.coeff_cb, cu.coeff_cr, cu.joint_cbcr = best

    def _est_cu_luma_syntax(self, cu: CuData, mpm) -> None:
        est = self.est
        if self.enc.sps.mip:
            from ..codec.ctu_syntax import mip_flag_ctx
            from ..ops.mip import num_mip_modes
            ctx = mip_flag_ctx(self.ps, cu.x, cu.y, cu.w, cu.h)
            est.encode_bin(1 if cu.mip_flag else 0,
                           ct.CTX_SETS["MipFlag"](ctx))
            if cu.mip_flag:
                est.encode_bin_ep(1 if cu.mip_transposed else 0)
                n = num_mip_modes(cu.w, cu.h)
                est.encode_bins_ep(0, n.bit_length() - 1)  # truncbin approx
                return
        if self.enc.sps.mrl and (cu.y % self.cfg.ctu_size) != 0:
            est.encode_bin(1 if cu.ref_line else 0,
                           ct.CTX_SETS["MultiRefLineIdx"](0))
            if cu.ref_line:
                est.encode_bin(1 if cu.ref_line != 1 else 0,
                               ct.CTX_SETS["MultiRefLineIdx"](1))
        mode = cu.luma_mode
        mpm_idx = mpm.index(mode) if mode in mpm else 6
        if cu.ref_line == 0:
            est.encode_bin(1 if mpm_idx < 6 else 0,
                           ct.CTX_SETS["IntraLumaMpmFlag"](0))
        if mpm_idx < 6:
            if cu.ref_line == 0:
                est.encode_bin(1 if mpm_idx > 0 else 0,
                               ct.CTX_SETS["IntraLumaPlanarFlag"](1))
            for t in range(1, 5):
                if mpm_idx >= t:
                    est.encode_bin_ep(1 if mpm_idx > t else 0)
        else:
            est.encode_bins_ep(0, 6)  # truncated-binary payload approx

    # -- inter CU search ---------------------------------------------------
def _encode_inter_frame_job(args):
    """Process-pool worker: encode one picture of a GOP wave against a DPB
    subset (FPP worker): an inter picture, or the intra CRA that `nal`
    names.  Returns (au, rec, motion_field, ref_pocs, qp)."""
    (cfg, poc, frame, st, refs_l0, refs_l1, qp_off, tlayer, dpb_sub,
     lmcs, keep_pocs, qpa_prev1, qpa_prev2, min_noise, bim_off, nal) = args
    with PROF.picture(poc):
        with PROF.section("pic.setup"):
            enc = IntraEncoder(cfg)
            enc.frames_done = 1      # no headers; TRAIL unless `nal`
            enc.dpb = list(dpb_sub)
            enc.lmcs = lmcs
            if cfg.qpa:
                # perceptual QPA inputs, fixed per POC (wave-
                # deterministic); stored at internal bit depth exactly
                # as the serial path does
                shift = cfg.bit_depth - cfg.input_bit_depth
                if qpa_prev1 is not None:
                    enc._orig_by_poc[poc - 1] = {
                        c: qpa_prev1[c].astype(np.int32) << shift
                        for c in range(3)}
                if qpa_prev2 is not None:
                    enc._orig_by_poc[poc - 2] = {
                        c: qpa_prev2[c].astype(np.int32) << shift
                        for c in range(3)}
                if min_noise is not None:
                    enc.min_noise = min_noise
            if bim_off is not None:
                enc._bim_map = {poc: bim_off}
        au = enc._encode_picture(poc, frame, st, refs_l0, refs_l1, qp_off,
                                 tlayer=tlayer, keep_pocs=keep_pocs,
                                 nal=nal)
    rec = dict(enc.last_rec.rec)
    mf = enc.dpb[-1][2]
    ref_pocs = enc.dpb[-1][3]
    return au, rec, mf, ref_pocs, enc.qp_by_poc[poc]


def _encode_gop_segment_job(args):
    """Process-pool worker: encode one IDR segment standalone.

    Headers are emitted by the first segment only; each segment's POC
    restarts at 0 (IDR semantics), so segments are fully independent."""
    cfg, seg_idx, frames_seg, fgc, bim_seg = args
    enc = IntraEncoder(cfg)
    enc._fgc_sei = fgc if seg_idx == 0 else None
    enc._bim_map = dict(bim_seg)
    if seg_idx > 0:
        enc._headers = b""
    au = enc.encode_sequence(list(frames_seg))
    stats = enc.rc.collected if enc.rc is not None else []
    return (au, enc.recs_by_poc, enc.bits_by_poc, enc.qp_by_poc,
            enc.slice_type_by_poc, stats)


def _encode_intra_frame_job(args):
    """Process-pool worker: encode one all-intra picture standalone.

    Reproduces exactly what the sequential encoder would emit for this
    POC (headers only on POC 0, IDR_W_RADL after, QPA fed with the same
    neighbouring originals)."""
    cfg, poc, frame, prev, prev2, fgc, plan_tables = args
    # the parent already resolved device planning: either it prefilled
    # this picture's plan (use it, no device access here) or planning is
    # off — never probe the backend from a pool worker
    cfg.device_rd = "on" if plan_tables is not None else "off"
    with PROF.picture(poc):
        with PROF.section("pic.setup"):
            enc = IntraEncoder(cfg)
            if plan_tables is not None:
                enc._plan_bank[poc] = plan_tables
            enc._fgc_sei = fgc
            enc.frames_done = poc
            shift = cfg.bit_depth - cfg.input_bit_depth
            if prev is not None:
                enc._orig_by_poc[poc - 1] = {
                    c: prev[c].astype(np.int32) << shift for c in range(3)}
            if prev2 is not None:
                enc._orig_by_poc[poc - 2] = {
                    c: prev2[c].astype(np.int32) << shift for c in range(3)}
        au = enc.encode_frame(frame)
    return au, dict(enc.last_rec.rec), len(au) * 8, enc.qp_by_poc[poc]

"""VVEncImpl — the library-facing encoder object with the reference's
lifecycle state machine (vvenc source/Lib/vvenc/vvencimpl.cpp).

The reference API is streaming: open with a config, feed pictures one
at a time, receive access units as they complete, pass NULL to flush,
close.  Errors are returned as codes (vvenc.h VVENC_OK / VVENC_ERR_*),
and calls are validated against the internal state
(VVEncImpl::m_eState: UNINITIALIZED -> INITIALIZED -> FLUSHING).

This impl wraps IntraEncoder with the same contract.  The encoder runs
its device work where VvencTpuConfig.device says: "cuda" (the default;
the card's kernels) unless the caller asks for "cpu" (their plain
PyTorch versions); there is no fallback from one to the other.

  impl = VVEncImpl()
  impl.init(cfg)                      # -> VVENC_OK or error code
  au, done = impl.encode(planes)      # may return b"" while buffering
  au, done = impl.encode(None)        # flush: drains the GOP buffer
  impl.close()

Hierarchical-B needs gop_size+1 pictures before the first GOP can be
coded, so access units are emitted in bursts exactly like the
reference's DPB-delayed output.  Whole-sequence stages of the batch
path (MCTF, scene-cut IDR placement, RC lookahead over all frames) are
not available in streaming mode — matching vvenc, where those run on
a bounded future window only.
"""

from __future__ import annotations

from enum import IntEnum
from typing import Optional, Tuple

from .bitstream.params import SLICE_B, SLICE_I, SLICE_P
from .config.config import VvencTpuConfig, apply_derived, check_config
from .encoder.gop import build_gop
from .encoder.intra_encoder import IntraEncoder

# vvenc.h error codes
VVENC_OK = 0
VVENC_ERR_UNSPECIFIED = -1
VVENC_ERR_INITIALIZE = -2
VVENC_ERR_ALLOCATE = -3
VVENC_NOT_ENOUGH_MEM = -5
VVENC_ERR_PARAMETER = -7
VVENC_ERR_NOT_SUPPORTED = -10
VVENC_ERR_RESTART_REQUIRED = -11


class State(IntEnum):
    UNINITIALIZED = 0
    INITIALIZED = 1
    FLUSHED = 2


class VVEncImpl:
    """Streaming encoder with lifecycle validation."""

    def __init__(self):
        self._state = State.UNINITIALIZED
        self._err = ""
        self._enc: Optional[IntraEncoder] = None
        self._cfg: Optional[VvencTpuConfig] = None

    # -- lifecycle -----------------------------------------------------------
    def init(self, cfg: VvencTpuConfig) -> int:
        if self._state != State.UNINITIALIZED:
            return self._fail(VVENC_ERR_INITIALIZE,
                              "encoder already initialized")
        try:
            # derive auto settings (threads=-1, mtProfile boost,
            # refresh_sec -> intra_period) before validating — the
            # reference does this in vvenc_init_config for every entry
            # point, not just the CLI (vvencCfg.cpp vvenc_init_config)
            apply_derived(cfg)
            check_config(cfg)
        except Exception as e:              # noqa: BLE001
            return self._fail(VVENC_ERR_PARAMETER, str(e))
        from .__main__ import encoder_config_from
        try:
            self._enc = IntraEncoder(encoder_config_from(cfg, None))
        except Exception as e:              # noqa: BLE001
            return self._fail(VVENC_ERR_INITIALIZE, str(e))
        self._cfg = cfg
        self._frames = {}          # poc -> planes
        self._filt = {}            # poc -> MCTF-filtered planes
        self._in_poc = 0
        self._base = 0             # first POC of the next GOP
        self._started = False
        # rec-callback dedup restarts with the encoder: a new pass /
        # re-init restarts at POC 0 and must deliver those pictures again
        self._recs_taken = set()
        self._entries = build_gop(max(1, cfg.gop_size))
        self._state = State.INITIALIZED
        return VVENC_OK

    def close(self) -> int:
        self._state = State.UNINITIALIZED
        self._enc = None
        self._frames = {}
        self._recs_taken = set()
        return VVENC_OK

    # -- header extraction / reconfig / 2-pass (vvenc.h.in:286-365) ----------
    def get_headers(self) -> bytes:
        """Parameter-set NALs (SPS+PPS) without encoding a picture
        (vvenc_get_headers analog, vvenc.h.in:365)."""
        if self._enc is None:
            return b""
        return self._enc.headers()

    # fields reconfigurable without an encoder restart (the reference
    # returns VVENC_ERR_RESTART_REQUIRED for anything structural,
    # vvenc.h.in:347 + vvencimpl checkReconfig)
    _RECONFIG_OK = ("qp",)

    def reconfig(self, cfg: VvencTpuConfig) -> int:
        """Adopt a changed configuration mid-stream when legal; returns
        VVENC_OK or VVENC_ERR_RESTART_REQUIRED (vvenc_reconfig analog)."""
        if self._state != State.INITIALIZED or self._cfg is None:
            return self._fail(VVENC_ERR_INITIALIZE, "not initialized")
        from dataclasses import fields as _fields
        changed = [f.name for f in _fields(self._cfg)
                   if getattr(self._cfg, f.name) != getattr(cfg, f.name)]
        if any(k not in self._RECONFIG_OK for k in changed):
            bad = [k for k in changed if k not in self._RECONFIG_OK]
            return self._fail(VVENC_ERR_RESTART_REQUIRED,
                              f"structural change requires restart: {bad}")
        for k in changed:
            setattr(self._cfg, k, getattr(cfg, k))
        if "qp" in changed and self._enc is not None:
            from .encoder.intra_encoder import lambda_for_qp
            e = self._enc
            e.cfg.qp = cfg.qp
            e.slice_qp = max(0, min(63,
                                    cfg.qp + e.cfg.intra_qp_offset))
            e.lmbda = lambda_for_qp(e.slice_qp, e.cfg.bit_depth)
            e.lmbda_sad = e.lmbda ** 0.5
        return VVENC_OK

    def init_pass(self, pass_no: int, stats_fname: str) -> int:
        """Two-pass rate control (vvenc_init_pass analog, vvenc.h.in:306):
        pass 0 collects statistics into stats_fname, pass 1 consumes
        them.  Reinitializes the encoding state; the configuration is
        kept.  Must be called before the first picture of each pass."""
        if self._cfg is None:
            return self._fail(VVENC_ERR_INITIALIZE, "not initialized")
        if pass_no not in (0, 1):
            return self._fail(VVENC_ERR_PARAMETER, "pass must be 0 or 1")
        if self._cfg.target_bitrate <= 0:
            return self._fail(VVENC_ERR_PARAMETER,
                              "two-pass needs target_bitrate > 0")
        cfg = self._cfg
        cfg.rc_stats_out = stats_fname if pass_no == 0 else ""
        cfg.rc_stats_in = stats_fname if pass_no == 1 else ""
        self._state = State.UNINITIALIZED
        self._cfg = None
        return self.init(cfg)

    def take_recons(self):
        """Newly reconstructed pictures since the last call, in POC
        order: [(poc, {0: Y, 1: Cb, 2: Cr})] (the rec-YUV output hook
        behind the reference's vvenc_encode recon parameter,
        vvenc.h.in:286-296)."""
        if self._enc is None:
            return []
        if not hasattr(self, "_recs_taken"):
            self._recs_taken = set()
        out = []
        for poc in sorted(self._enc.recs_by_poc):
            if poc in self._recs_taken:
                continue
            self._recs_taken.add(poc)
            out.append((poc, self._enc.recs_by_poc[poc]))
        return out

    @property
    def state(self) -> State:
        return self._state

    def last_error(self) -> str:
        return self._err

    def _fail(self, code: int, msg: str) -> int:
        self._err = msg
        return code

    # -- encoding -------------------------------------------------------------
    def encode(self, planes) -> Tuple[bytes, bool, int]:
        """Feed one picture (Y, U, V) or None to flush.

        Returns (au_bytes, encode_done, ret_code).  au_bytes may cover
        zero or several access units (GOP bursts)."""
        if self._state == State.UNINITIALIZED:
            return b"", False, self._fail(VVENC_ERR_INITIALIZE,
                                          "encoder not initialized")
        if self._state == State.FLUSHED:
            return b"", True, self._fail(VVENC_ERR_UNSPECIFIED,
                                         "encoder already flushed")
        flush = planes is None
        if not flush:
            self._frames[self._in_poc] = planes
            self._in_poc += 1
        out = self._drain(flush)
        if flush:
            # 2-pass: persist the collected first-pass statistics
            # (the batch path writes them at encode_sequence end)
            enc = self._enc
            if enc is not None and enc.rc is not None \
                    and enc.cfg.rc_stats_out \
                    and enc.cfg.rc_stats_out != "collect:":
                enc.rc.write_stats(enc.cfg.rc_stats_out)
            self._state = State.FLUSHED
        return out, flush, VVENC_OK

    # -- bounded-window MCTF (EncStage queue discipline) ---------------------
    def _mctf_on(self) -> bool:
        cfg = self._enc.cfg
        return bool(cfg.mctf and cfg.gop_size > 1)

    def _mctf_lead(self, flush: bool) -> int:
        """Input pictures that must exist beyond a POC before it can be
        temporally filtered exactly like the batch path (vvenc MCTF stage
        minQueueSize = leadFrames + 1 + MCTF_RANGE, EncLib.cpp:251)."""
        from .encoder.mctf import RANGE
        return 0 if (flush or not self._mctf_on()) else RANGE

    def _get_frame(self, poc: int, flush: bool):
        """Picture for encoding: MCTF-filtered over the same +-RANGE
        window the batch path uses (cache per POC; byte-identical)."""
        if not self._mctf_on():
            return self._frames[poc]
        if flush and self._in_poc <= 2:
            return self._frames[poc]   # batch gate: len(frames) > 2
        if poc in self._filt:
            return self._filt[poc]
        from .encoder.mctf import mctf_strengths, mctf_filter_frame, RANGE
        cfg = self._enc.cfg
        mf, ms = mctf_strengths(cfg.gop_size, cfg.qp)
        sidx = -1
        for k in range(len(mf)):
            if poc % mf[k] == 0:
                sidx = k
        if sidx < 0:
            return self._frames[poc]
        start = max(0, poc - RANGE)
        end = min(self._in_poc, poc + RANGE + 1)
        win = [self._frames[j] for j in range(start, end)]
        if cfg.bim:
            filt, bim = mctf_filter_frame(
                win, poc - start, ms[sidx], cfg.qp, cfg.input_bit_depth,
                bim_ctu_size=cfg.ctu_size, min_noise=self._enc.min_noise)
            if bim is not None:
                self._enc._bim_map[poc] = bim
        else:
            filt = mctf_filter_frame(win, poc - start, ms[sidx], cfg.qp,
                                     cfg.input_bit_depth)
        self._filt[poc] = filt
        return filt

    def _drain(self, flush: bool) -> bytes:
        enc, cfg = self._enc, self._enc.cfg
        out = bytearray()
        lead = self._mctf_lead(flush)
        if cfg.gop_size <= 1 or cfg.intra_period == 1:
            # all-intra / low-delay IPPP path: code-as-they-come
            while self._base + lead < self._in_poc or \
                    (flush and self._base < self._in_poc):
                out += enc.encode_frame(self._get_frame(self._base, flush))
                self._frames.pop(self._base - lead - 1, None)
                enc.recs_by_poc[self._base] = dict(enc.last_rec.rec)
                self._base += 1
            return bytes(out)
        gop = cfg.gop_size
        if not self._started and (self._in_poc > lead
                                  or (flush and self._in_poc > 0)):
            out += enc._encode_picture(0, self._get_frame(0, flush),
                                       SLICE_I, [], [])
            enc.recs_by_poc[0] = dict(enc.last_rec.rec)
            self._started = True
        while self._started and self._base + gop + lead < self._in_poc:
            enc._protect_refs(self._entries, self._base, gop)
            for e in self._entries:
                poc = self._base + e.poc_in_gop
                avail = {d[0] for d in enc.dpb}

                def _ok(p):
                    if p not in avail:
                        return False
                    if poc > enc._drap_floor:
                        return p >= enc._drap_floor or p == 0
                    return True
                is_drap = (cfg.drap_period > 0
                           and e.poc_in_gop == cfg.gop_size
                           and poc % cfg.drap_period == 0)
                if is_drap:
                    assert 0 in avail, \
                        "DRAP: associated IRAP evicted from DPB"
                    refs_l0, refs_l1 = [0], []
                else:
                    refs_l0 = [self._base + r for r in e.refs_past
                               if _ok(self._base + r)] or [self._base]
                    refs_l1 = [self._base + r for r in e.refs_future
                               if _ok(self._base + r)]
                st = SLICE_B if refs_l1 else SLICE_P
                au = enc._encode_picture(poc,
                                         self._get_frame(poc, flush), st,
                                         refs_l0, refs_l1,
                                         e.final_qp_offset(cfg.qp),
                                         tlayer=e.temporal_layer)
                if is_drap:
                    from .bitstream.sei import (write_sei_nal,
                                                SeiDrapIndication,
                                                SEI_DEPENDENT_RAP)
                    au = write_sei_nal(
                        [(SEI_DEPENDENT_RAP,
                          SeiDrapIndication().payload())],
                        prefix=True) + au
                    enc._drap_floor = poc
                out += au
                enc.recs_by_poc[poc] = dict(enc.last_rec.rec)
            for p in range(self._base, self._base + gop):
                self._filt.pop(p, None)
            for p in range(self._base - lead, self._base + gop - lead):
                self._frames.pop(p, None)
            self._base += gop
        if flush and self._started:
            # remaining full GOPs first (the lead gate is lifted)
            # then tail: IPPP on the remaining pictures (mirror of
            # encode_sequence's tail handling)
            for poc in range(self._base + 1, self._in_poc):
                if poc in enc.recs_by_poc:
                    continue
                out += enc._encode_picture(poc, self._get_frame(poc, True),
                                           SLICE_P, [poc - 1], [], 1)
                enc.recs_by_poc[poc] = dict(enc.last_rec.rec)
            self._frames.clear()
            self._filt.clear()
        return bytes(out)


def version() -> str:
    return "vvenc_tpu_torch-0.1"

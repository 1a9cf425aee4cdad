"""LMCS — luma mapping with chroma scaling (common model).

Spec behavior anchored on the reference implementation:
  - LUT construction:   Reshape::constructReshaper (Reshape.cpp:191-229)
  - inverse PWL index:  ReshapeData::getPWLIdxInv (Reshape.cpp:61)
  - chroma adjustment:  ReshapeData::calculateChromaAdjVpduNei
                        (Reshape.cpp:77-151)
  - residual scaling:   AreaBuf<Pel>::scaleSignal (Buffer.cpp:575-621)
  - APS syntax:         HLSWriter::codeLmcsAps (VLCWriter.cpp:544-575)

All mapping is LUT-driven; planes are mapped with a single vectorized
np.take (TPU analog: one gather — see ops/ for the jnp path).
"""

from __future__ import annotations

import numpy as np

PIC_CODE_CW_BINS = 16
FP_PREC = 11          # CommonDef.h:518
CSCALE_FP_PREC = 11   # CommonDef.h:519
LMCS_APS = 1          # keep in sync with codec/alf.py APS type codes


class LmcsParam:
    """lmcs_data() payload (LmcsParam, Slice.h:291-312)."""

    def __init__(self):
        self.min_bin_idx = 0
        self.max_bin_idx = PIC_CODE_CW_BINS - 1
        self.bin_cw_delta = [0] * PIC_CODE_CW_BINS
        self.max_nbits_delta_cw = 1     # lmcs_delta_cw_prec_minus1 + 1
        self.crs_offset = 0             # chrResScalingOffset (delta_crs)


def write_lmcs_aps(bw, aps_id: int, p: LmcsParam,
                   chroma_present: bool = True) -> None:
    """APS RBSP with LMCS payload (HLSWriter::codeAPS:434 + codeLmcsAps)."""
    bw.write(LMCS_APS, 3)
    bw.write(aps_id, 5)
    bw.write_flag(1 if chroma_present else 0)
    bw.write_uvlc(p.min_bin_idx)
    bw.write_uvlc(PIC_CODE_CW_BINS - 1 - p.max_bin_idx)
    assert p.max_nbits_delta_cw > 0
    bw.write_uvlc(p.max_nbits_delta_cw - 1)
    for i in range(p.min_bin_idx, p.max_bin_idx + 1):
        delta = p.bin_cw_delta[i]
        bw.write(abs(delta), p.max_nbits_delta_cw)
        if delta:
            bw.write_flag(1 if delta < 0 else 0)
    crs = p.crs_offset if chroma_present else 0
    if chroma_present:
        bw.write(abs(crs), 3)
    if abs(crs) > 0:
        bw.write_flag(1 if crs < 0 else 0)
    bw.write_flag(0)  # aps_extension_flag
    bw.write_rbsp_trailing_bits()


def read_lmcs_payload(br, chroma_present: bool) -> LmcsParam:
    """Parse lmcs_data() after the APS header fields."""
    p = LmcsParam()
    p.min_bin_idx = br.read_uvlc()
    p.max_bin_idx = PIC_CODE_CW_BINS - 1 - br.read_uvlc()
    p.max_nbits_delta_cw = br.read_uvlc() + 1
    for i in range(p.min_bin_idx, p.max_bin_idx + 1):
        absv = br.read(p.max_nbits_delta_cw)
        if absv and br.read_flag():
            absv = -absv
        p.bin_cw_delta[i] = absv
    if chroma_present:
        crs = br.read(3)
        if crs and br.read_flag():
            crs = -crs
        p.crs_offset = crs
    return p


class ReshapeState:
    """Per-picture reshaper LUTs (Reshape::constructReshaper).

    fwd_lut maps original-domain luma -> mapped domain; inv_lut the
    reverse; chroma_adj_help[bin] is the chroma residual inverse scale
    (CSCALE_FP_PREC fixed point).
    """

    def __init__(self, param: LmcsParam, bit_depth: int,
                 chroma_scale_enabled: bool = True):
        self.param = param
        self.bit_depth = bit_depth
        self.chroma_scale_enabled = chroma_scale_enabled
        lut_size = 1 << bit_depth
        init_cw = lut_size // PIC_CODE_CW_BINS
        self.init_cw = init_cw

        bin_cw = np.zeros(PIC_CODE_CW_BINS, np.int64)
        for i in range(param.min_bin_idx, param.max_bin_idx + 1):
            bin_cw[i] = param.bin_cw_delta[i] + init_cw

        pivot = np.zeros(PIC_CODE_CW_BINS + 1, np.int64)   # mapped pivots
        in_pivot = np.zeros(PIC_CODE_CW_BINS + 1, np.int64)
        fwd_scale = np.zeros(PIC_CODE_CW_BINS, np.int64)
        inv_scale = np.zeros(PIC_CODE_CW_BINS, np.int64)
        adj_help = np.full(PIC_CODE_CW_BINS, 1 << CSCALE_FP_PREC, np.int64)
        log2_bin = int(np.log2(init_cw))
        for i in range(PIC_CODE_CW_BINS):
            pivot[i + 1] = pivot[i] + bin_cw[i]
            in_pivot[i + 1] = in_pivot[i] + init_cw
            fwd_scale[i] = ((bin_cw[i] << FP_PREC) +
                            (1 << (log2_bin - 1))) >> log2_bin
            if bin_cw[i] == 0:
                inv_scale[i] = 0
                adj_help[i] = 1 << CSCALE_FP_PREC
            else:
                inv_scale[i] = (init_cw << FP_PREC) // bin_cw[i]
                adj_help[i] = ((init_cw << FP_PREC) //
                               (bin_cw[i] + param.crs_offset))
        self.bin_cw = bin_cw
        self.pivot = pivot
        self.chroma_adj_help = adj_help

        samples = np.arange(lut_size, dtype=np.int64)
        idx = samples // init_cw
        fwd = pivot[idx] + ((fwd_scale[idx] * (samples - in_pivot[idx]) +
                             (1 << (FP_PREC - 1))) >> FP_PREC)
        self.fwd_lut = np.clip(fwd, 0, lut_size - 1).astype(np.int32)

        # inverse PWL bin: first bin (in [min,max]) whose upper mapped
        # pivot exceeds the sample (getPWLIdxInv, Reshape.cpp:61-68)
        idx_inv = np.full(lut_size, PIC_CODE_CW_BINS - 1, np.int64)
        for b in range(param.max_bin_idx, param.min_bin_idx - 1, -1):
            idx_inv[samples < pivot[b + 1]] = b
        inv = in_pivot[idx_inv] + (
            (inv_scale[idx_inv] * (samples - pivot[idx_inv]) +
             (1 << (FP_PREC - 1))) >> FP_PREC)
        self.inv_lut = np.clip(inv, 0, lut_size - 1).astype(np.int32)
        self._idx_inv = idx_inv

    def fwd_map(self, plane: np.ndarray) -> np.ndarray:
        return self.fwd_lut[plane]

    def inv_map(self, plane: np.ndarray) -> np.ndarray:
        return self.inv_lut[plane]

    def chroma_adj_from_luma(self, avg_luma: int) -> int:
        """calculateChromaAdj (Reshape.cpp:71-75)."""
        return int(self.chroma_adj_help[self._idx_inv[avg_luma]])


def scale_chroma_resi_inv(resi: np.ndarray, scale: int,
                          bit_depth: int) -> np.ndarray:
    """Decoder-side chroma residual scaling (scaleSignal dir=0,
    Buffer.cpp:602-621): resi * scale / 2^11, round-to-nearest away
    from the origin per the sign trick."""
    maxv = (1 << bit_depth) - 1
    val = np.clip(resi, -maxv - 1, maxv).astype(np.int64)
    sign = np.where(resi >= 0, 1, -1)
    absval = sign * val
    out = sign * ((absval * scale + (1 << (CSCALE_FP_PREC - 1)))
                  >> CSCALE_FP_PREC)
    return np.clip(out, -32768, 32767)


def scale_chroma_resi_fwd(resi: np.ndarray, scale: int,
                          bit_depth: int) -> np.ndarray:
    """Encoder-side forward scaling (scaleSignal dir=1):
    resi * 2^11 / scale with round-half-up on the magnitude."""
    maxv = (1 << bit_depth) - 1
    sign = np.where(resi >= 0, 1, -1)
    absval = (sign * resi.astype(np.int64))
    out = sign * (((absval << CSCALE_FP_PREC) + (scale >> 1)) // scale)
    return np.clip(out, -maxv, maxv)


def chroma_adj_vpdu_nei(ps, reshape: ReshapeState, x: int, y: int,
                        ctu_log2: int) -> int:
    """Per-TU chroma scale from the VPDU top-left CU's neighbors
    (calculateChromaAdjVpduNei, Reshape.cpp:77-151).

    (x, y) is the TU's luma position; the average is taken over the
    mapped-domain reconstruction column left of / row above the CU that
    contains the VPDU-aligned top-left corner.
    """
    nlog = min(6, ctu_log2)
    n = 1 << nlog
    xa, ya = x & ~(n - 1), y & ~(n - 1)
    # CU containing the VPDU corner (decoded earlier in z-order)
    cux = int(ps.cu_x[ya >> 2, xa >> 2])
    cuy = int(ps.cu_y[ya >> 2, xa >> 2])
    rec = ps.rec[0]
    total = 0
    pelnum = 0
    if cux > 0 and ps.is_coded(cux - 1, cuy):
        pelnum += 1
        ks = np.minimum(cuy + np.arange(n), ps.h - 1) - cuy
        total += int(rec[cuy + ks, cux - 1].sum())
    if cuy > 0 and ps.is_coded(cux, cuy - 1):
        pelnum += 1
        ks = np.minimum(cux + np.arange(n), ps.w - 1) - cux
        total += int(rec[cuy - 1, cux + ks].sum())
    if pelnum:
        shift = nlog + pelnum - 1
        avg = (total + (1 << (shift - 1))) >> shift
    else:
        avg = 1 << (reshape.bit_depth - 1)
    return reshape.chroma_adj_from_luma(avg)

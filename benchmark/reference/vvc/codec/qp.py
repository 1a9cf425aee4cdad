"""QP derivation: chroma QP mapping table and quantizer QP params.

Implements H.266 7.4.3.4 (ChromaQpTable derivation) and 8.7.1 (QP
derivation incl. the bit-depth offset).  Behavioral reference: vvenc
CommonLib/Slice.cpp ChromaQpMappingTable and CommonLib/Quant.h QpParam.
"""

from __future__ import annotations

from functools import lru_cache


def derive_chroma_qp_table(start: int, in_deltas_m1, out_deltas,
                           qp_bd_offset: int):
    """Build ChromaQpTable[-qp_bd_offset .. 63] as a dict-like list.

    start: sps_qp_table_start_minus26 + 26; in_deltas_m1/out_deltas: point
    deltas from the SPS.  Returns list indexed by (qp + qp_bd_offset).
    """
    num_pts = len(in_deltas_m1)
    qp_in = [start]
    qp_out = [start]
    for j in range(num_pts):
        qp_in.append(qp_in[-1] + in_deltas_m1[j] + 1)
        qp_out.append(qp_out[-1] + out_deltas[j])
    size = 64 + qp_bd_offset
    table = [0] * size

    def idx(k):
        return k + qp_bd_offset

    def clip(v):
        return max(-qp_bd_offset, min(63, v))

    table[idx(qp_in[0])] = qp_out[0]
    for k in range(qp_in[0] - 1, -qp_bd_offset - 1, -1):
        table[idx(k)] = clip(table[idx(k + 1)] - 1)
    for j in range(num_pts):
        sh = (in_deltas_m1[j] + 1) >> 1
        span = in_deltas_m1[j] + 1
        dout = qp_out[j + 1] - qp_out[j]
        for m in range(1, span + 1):
            k = qp_in[j] + m
            table[idx(k)] = table[idx(qp_in[j])] + ((dout * m + sh) // span)
    for k in range(qp_in[num_pts] + 1, 64):
        table[idx(k)] = clip(table[idx(k - 1)] + 1)
    return table


class QpState:
    """Per-slice QP state: luma QP + derived per-component quantizer QPs."""

    def __init__(self, sps, pps, slice_qp: int, sh=None):
        self.bit_depth = sps.bit_depth
        self.qp_bd_offset = 6 * (sps.bit_depth - 8)
        self.qp_y = slice_qp
        self.slice_qp = slice_qp
        start, ins, outs = sps.chroma_qp_tables[0]
        self._ctab = derive_chroma_qp_table(start + 26, ins, outs,
                                            self.qp_bd_offset)
        # total chroma offset = PPS + slice-level (VVC 8.7.1 CuQpOffset)
        sh_cb = getattr(sh, "cb_qp_offset", 0) if sh is not None else 0
        sh_cr = getattr(sh, "cr_qp_offset", 0) if sh is not None else 0
        self.cb_off = pps.cb_qp_offset + sh_cb
        self.cr_off = pps.cr_qp_offset + sh_cr
        self.joint_off = getattr(pps, "joint_cbcr_qp_offset", 0)

    def luma_qp(self) -> int:
        """Quantizer QP for luma (Qp'Y, includes bit-depth offset)."""
        return self.qp_y + self.qp_bd_offset

    def chroma_qp(self, comp: int) -> int:
        """Quantizer QP for Cb (comp=1) / Cr (comp=2)."""
        q = max(-self.qp_bd_offset, min(63, self.qp_y))
        qpc = self._ctab[q + self.qp_bd_offset]
        off = self.cb_off if comp == 1 else self.cr_off
        qpc = max(-self.qp_bd_offset, min(63, qpc + off))
        return qpc + self.qp_bd_offset

    def joint_qp(self) -> int:
        """Quantizer QP for a joint Cb-Cr residual with ICT mode |2|
        (vvenc Quant QpParam: useJQP iff abs(ictMode) == 2)."""
        q = max(-self.qp_bd_offset, min(63, self.qp_y))
        qpc = self._ctab[q + self.qp_bd_offset]
        qpc = max(-self.qp_bd_offset, min(63, qpc + self.joint_off))
        return qpc + self.qp_bd_offset

    def set_cu_qp(self, qp_y: int) -> None:
        """Switch the state to one CU's luma QP (cu_qp_delta)."""
        self.qp_y = qp_y if qp_y >= 0 else self.slice_qp

    def chroma_deblock_qp(self, qp_y: int, comp: int,
                          joint: bool = False) -> int:
        """Chroma QP for the deblocking tc/beta lookup of a CU with luma
        QP qp_y (QpParam.Qp(0) - qpBdOffset, vvenc LoopFilter.cpp:1057).
        joint: the TU uses joint Cb-Cr with ICT mode |2| (joint QP)."""
        q = max(-self.qp_bd_offset, min(63, qp_y))
        qpc = self._ctab[q + self.qp_bd_offset]
        off = self.joint_off if joint else \
            (self.cb_off if comp == 1 else self.cr_off)
        return max(-self.qp_bd_offset, min(63, qpc + off))

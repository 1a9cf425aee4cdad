"""NAL unit encapsulation and emulation prevention (EBSP).

Reference analog: vvenc EncoderLib/NALwrite.cpp (emulation prevention),
CommonLib/Nal.h (NAL types).  NAL unit type values follow ITU-T H.266
Table 5; the two-byte NAL header layout follows H.266 section 7.3.1.2.
"""

from __future__ import annotations

from enum import IntEnum


class NalUnitType(IntEnum):
    TRAIL = 0
    STSA = 1
    RADL = 2
    RASL = 3
    IDR_W_RADL = 7
    IDR_N_LP = 8
    CRA = 9
    GDR = 10
    OPI = 12
    DCI = 13
    VPS = 14
    SPS = 15
    PPS = 16
    PREFIX_APS = 17
    SUFFIX_APS = 18
    PH = 19
    AUD = 20
    EOS = 21
    EOB = 22
    PREFIX_SEI = 23
    SUFFIX_SEI = 24
    FD = 25


VCL_NAL_TYPES = frozenset(
    {NalUnitType.TRAIL, NalUnitType.STSA, NalUnitType.RADL, NalUnitType.RASL,
     NalUnitType.IDR_W_RADL, NalUnitType.IDR_N_LP, NalUnitType.CRA,
     NalUnitType.GDR}
)


def nal_header(nal_type: NalUnitType, temporal_id: int = 0, layer_id: int = 0) -> bytes:
    """forbidden_zero(1) reserved_zero(1) nuh_layer_id(6) | nal_unit_type(5) tid_plus1(3)."""
    assert 0 <= layer_id < 64 and 0 <= temporal_id < 7
    byte0 = layer_id & 0x3F
    byte1 = ((int(nal_type) & 0x1F) << 3) | (temporal_id + 1)
    return bytes((byte0, byte1))


def add_ebsp(rbsp: bytes) -> bytes:
    """Insert emulation_prevention_three_byte per H.266 7.4.1.1.

    After two zero bytes, a byte <= 0x03 must be escaped with 0x03.
    """
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    # a NAL payload must not end with 0x00 0x00 (would be ambiguous with the
    # next start code); cabac_zero_word handling appends 0x03 in that case
    if zeros >= 2:
        out.append(3)
    return bytes(out)


def strip_ebsp(ebsp: bytes) -> bytes:
    out = bytearray()
    zeros = 0
    i = 0
    n = len(ebsp)
    while i < n:
        b = ebsp[i]
        if zeros >= 2 and b == 3 and i + 1 < n and ebsp[i + 1] <= 3:
            zeros = 0
            i += 1
            continue
        if zeros >= 2 and b == 3 and i + 1 == n:
            # trailing escape byte
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


def make_nal_unit(nal_type: NalUnitType, rbsp: bytes, temporal_id: int = 0,
                  layer_id: int = 0, long_start_code: bool = True) -> bytes:
    """Annex-B byte-stream NAL unit: start code + header + EBSP payload."""
    start = b"\x00\x00\x00\x01" if long_start_code else b"\x00\x00\x01"
    return start + nal_header(nal_type, temporal_id, layer_id) + add_ebsp(rbsp)


def split_annexb(stream: bytes):
    """Split an Annex-B byte stream into (nal_type, temporal_id, rbsp) tuples."""
    units = []
    i = 0
    n = len(stream)
    starts = []
    while i + 2 < n:
        if stream[i] == 0 and stream[i + 1] == 0 and stream[i + 2] == 1:
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    starts.append(None)
    for s, e_next in zip(starts[:-1], starts[1:]):
        end = n if e_next is None else e_next - 3
        # trim trailing zeros that belong to the next start code prefix
        while end > s and stream[end - 1] == 0:
            end -= 1
        payload = stream[s:end]
        if len(payload) < 2:
            continue
        nal_type = NalUnitType((payload[1] >> 3) & 0x1F)
        temporal_id = (payload[1] & 0x7) - 1
        units.append((nal_type, temporal_id, strip_ebsp(payload[2:])))
    return units

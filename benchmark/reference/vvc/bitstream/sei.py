"""SEI messages (H.274/VSEI) — construction, serialization, parsing.

Structural analog of vvenc EncoderLib/SEIwrite.{h,cpp} + SEIEncoder.{h,cpp}
and CommonLib/SEI.h / MD5.h / PicYuvMD5.cpp: the messages vvenc emits that
matter for interop and integrity:

- decoded_picture_hash (payloadType 132): MD5 / CRC / checksum over the
  reconstruction — the end-to-end integrity anchor (vvencCfg.h:542).
- buffering_period (0) / pic_timing (1): HRD timing skeleton.
- mastering_display_colour_volume (137), content_light_level (144),
  alternative_transfer_characteristics (147): HDR metadata passthrough.

An SEI NAL unit is a sequence of (ff-escaped payload_type, ff-escaped
payload_size, payload bytes) followed by rbsp trailing bits.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .bitwriter import BitWriter, BitReader
from .nal import NalUnitType, make_nal_unit

# payload types (H.274 Table 4 / vvenc SEI.h PayloadType)
SEI_BUFFERING_PERIOD = 0
SEI_PIC_TIMING = 1
SEI_DECODED_PICTURE_HASH = 132
SEI_MASTERING_DISPLAY = 137
SEI_CONTENT_LIGHT_LEVEL = 144
SEI_DEPENDENT_RAP = 145
SEI_ALTERNATIVE_TRANSFER = 147

HASH_MD5, HASH_CRC, HASH_CHECKSUM = 0, 1, 2


# ---------------------------------------------------------------------------
# decoded picture hash (vvenc PicYuvMD5.cpp)
# ---------------------------------------------------------------------------

def _plane_bytes(plane: np.ndarray, bit_depth: int) -> bytes:
    """Raster-order sample bytes: low byte, then high byte if depth > 8."""
    p = plane.astype(np.uint16)
    if bit_depth <= 8:
        return p.astype(np.uint8).tobytes()
    lo = (p & 0xFF).astype(np.uint8)
    hi = (p >> 8).astype(np.uint8)
    out = np.empty(p.shape + (2,), np.uint8)
    out[..., 0] = lo
    out[..., 1] = hi
    return out.tobytes()


def _crc16(data: bytes) -> int:
    """CRC over bits as specified for the picture hash SEI
    (vvenc MD5.h compCRC: x^16+x^12+x^5+1, init 0xFFFF, 2 zero pad bytes)."""
    crc = 0xFFFF
    for byte in data + b"\x00\x00":
        for bit in range(7, -1, -1):
            crc_msb = (crc >> 15) & 1
            crc = ((crc << 1) & 0xFFFF) | ((byte >> bit) & 1)
            if crc_msb:
                crc ^= 0x1021
    return crc & 0xFFFF


def _checksum(plane: np.ndarray, bit_depth: int) -> int:
    """Position-xor checksum (vvenc MD5.h compChecksum)."""
    h, w = plane.shape
    yy, xx = np.mgrid[0:h, 0:w]
    xor_mask = ((xx & 0xFF) ^ (yy & 0xFF) ^ (xx >> 8) ^ (yy >> 8))
    p = plane.astype(np.int64)
    s = int(((p & 0xFF) ^ xor_mask).sum())
    if bit_depth > 8:
        s += int((((p >> 8) & 0xFF) ^ xor_mask).sum())
    return s & 0xFFFFFFFF


def compute_picture_hash(planes, bit_depth: int, method: int
                         ) -> List[bytes]:
    """Per-component digest of a reconstruction {0: Y, 1: Cb, 2: Cr}."""
    out = []
    for c in range(3):
        if method == HASH_MD5:
            out.append(hashlib.md5(
                _plane_bytes(planes[c], bit_depth)).digest())
        elif method == HASH_CRC:
            out.append(_crc16(_plane_bytes(planes[c], bit_depth))
                       .to_bytes(2, "big"))
        else:
            out.append(_checksum(planes[c], bit_depth)
                       .to_bytes(4, "big"))
    return out


@dataclass
class SeiDecodedPictureHash:
    method: int = HASH_MD5
    digests: List[bytes] = field(default_factory=list)

    def payload(self) -> bytes:
        out = bytearray([self.method, 0x00])  # hash_type, single_comp=0 + 7 reserved
        for d in self.digests:
            out += d
        return bytes(out)

    @classmethod
    def parse(cls, data: bytes) -> "SeiDecodedPictureHash":
        method = data[0]
        n = {HASH_MD5: 16, HASH_CRC: 2, HASH_CHECKSUM: 4}[method]
        body = data[2:]
        return cls(method, [body[i * n:(i + 1) * n] for i in range(3)])


# ---------------------------------------------------------------------------
# HRD timing skeleton + HDR metadata
# ---------------------------------------------------------------------------

@dataclass
class SeiBufferingPeriod:
    """Minimal single-layer buffering period (vvenc SEIEncoder
    initBufferingPeriodSEI analog, concat-friendly defaults)."""
    initial_cpb_removal_delay: int = 90000 // 2
    initial_cpb_removal_offset: int = 0
    cpb_removal_delay_length: int = 24
    dpb_output_delay_length: int = 24

    def payload(self) -> bytes:
        bw = BitWriter()
        bw.write_flag(0)                      # bp_nal_hrd_params_present
        bw.write_flag(1)                      # bp_vcl_hrd_params_present
        bw.write(self.cpb_removal_delay_length - 1, 5)
        bw.write(self.dpb_output_delay_length - 1, 5)
        bw.write_flag(0)                      # duration_flag
        bw.write_flag(0)                      # concatenation
        bw.write_flag(0)                      # additional_concatenation_info
        bw.write(0, self.cpb_removal_delay_length)  # delta minus1
        bw.write(0, 3)                        # bp_max_sublayers_minus1
        bw.write_flag(0)                      # cpb_removal_delay_deltas
        bw.write_uvlc(0)                      # bp_cpb_cnt_minus1
        bw.write(self.initial_cpb_removal_delay, 24)
        bw.write(self.initial_cpb_removal_offset, 24)
        bw.write_rbsp_trailing_bits()
        return bw.get_bytes()


@dataclass
class SeiPicTiming:
    cpb_removal_delay: int = 0
    dpb_output_delay: int = 0
    cpb_removal_delay_length: int = 24
    dpb_output_delay_length: int = 24

    def payload(self) -> bytes:
        bw = BitWriter()
        bw.write(self.cpb_removal_delay, self.cpb_removal_delay_length)
        bw.write(self.dpb_output_delay, self.dpb_output_delay_length)
        bw.write_rbsp_trailing_bits()
        return bw.get_bytes()


@dataclass
class SeiContentLightLevel:
    max_cll: int = 0
    max_fall: int = 0

    def payload(self) -> bytes:
        return self.max_cll.to_bytes(2, "big") + \
            self.max_fall.to_bytes(2, "big")


@dataclass
class SeiDrapIndication:
    """Dependent-RAP indication (H.274 8.2.x; vvenc SEI.h:269
    SEIDependentRAPIndication): presence-only payload — the picture
    references only the associated IRAP, so decoding can start at it.
    The payload is empty syntax; the byte carries the payload-alignment
    stop bit (vvenc SEIwrite xWriteSEIpayloadData alignment)."""

    def payload(self) -> bytes:
        return b"\x80"


@dataclass
class SeiAlternativeTransfer:
    """Alternative transfer characteristics (vvenc SEI.h:533): signals a
    preferred transfer function (e.g. HLG ARIB-STD B67 = 18) on top of
    the VUI one."""
    preferred_transfer_characteristics: int = 18

    def payload(self) -> bytes:
        return bytes([self.preferred_transfer_characteristics])


@dataclass
class SeiMasteringDisplay:
    primaries: Tuple[int, ...] = (0,) * 6    # G,B,R x/y pairs
    white_point: Tuple[int, int] = (0, 0)
    max_luminance: int = 0
    min_luminance: int = 0

    def payload(self) -> bytes:
        out = bytearray()
        for v in self.primaries:
            out += int(v).to_bytes(2, "big")
        for v in self.white_point:
            out += int(v).to_bytes(2, "big")
        out += int(self.max_luminance).to_bytes(4, "big")
        out += int(self.min_luminance).to_bytes(4, "big")
        return bytes(out)


# ---------------------------------------------------------------------------
# SEI NAL serialization / parsing
# ---------------------------------------------------------------------------

def _ff_code(value: int) -> bytes:
    out = bytearray()
    while value >= 255:
        out.append(255)
        value -= 255
    out.append(value)
    return bytes(out)


def write_sei_nal(messages: List[Tuple[int, bytes]], prefix: bool = True,
                  temporal_id: int = 0) -> bytes:
    """messages: [(payload_type, payload_bytes)] -> one SEI NAL unit."""
    body = bytearray()
    for ptype, payload in messages:
        body += _ff_code(ptype)
        body += _ff_code(len(payload))
        body += payload
    bw = BitWriter()
    bw.append_bytes(bytes(body))
    bw.write_rbsp_trailing_bits()
    return make_nal_unit(
        NalUnitType.PREFIX_SEI if prefix else NalUnitType.SUFFIX_SEI,
        bw.get_bytes(), temporal_id=temporal_id)


def parse_sei_rbsp(rbsp: bytes) -> List[Tuple[int, bytes]]:
    """RBSP of an SEI NAL -> [(payload_type, payload_bytes)]."""
    out = []
    i = 0
    while i < len(rbsp):
        if rbsp[i] == 0x80 and all(b == 0 for b in rbsp[i + 1:]):
            break  # rbsp trailing bits
        ptype = 0
        while rbsp[i] == 255:
            ptype += 255
            i += 1
        ptype += rbsp[i]
        i += 1
        size = 0
        while rbsp[i] == 255:
            size += 255
            i += 1
        size += rbsp[i]
        i += 1
        out.append((ptype, rbsp[i:i + size]))
        i += size
    return out

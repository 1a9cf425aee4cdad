"""Bit-level output/input streams.

Reference analog: vvenc CommonLib/BitStream.{h,cpp} (OutputBitstream /
InputBitstream).  Re-designed: we accumulate into a Python bytearray with a
64-bit staging word; byte alignment helpers match the RBSP trailing-bits
semantics of ITU-T H.266.
"""

from __future__ import annotations


class BitWriter:
    """MSB-first bit writer producing an RBSP payload."""

    __slots__ = ("_buf", "_held", "_held_bits")

    def __init__(self) -> None:
        self._buf = bytearray()
        self._held = 0          # bits not yet flushed to _buf (MSB-aligned value)
        self._held_bits = 0     # number of valid bits in _held (< 8)

    # -- raw bits ----------------------------------------------------------
    def write(self, value: int, num_bits: int) -> None:
        if num_bits == 0:
            return
        assert 0 < num_bits <= 64
        assert 0 <= value < (1 << num_bits), (value, num_bits)
        acc = (self._held << num_bits) | value
        nbits = self._held_bits + num_bits
        while nbits >= 8:
            nbits -= 8
            self._buf.append((acc >> nbits) & 0xFF)
        self._held = acc & ((1 << nbits) - 1)
        self._held_bits = nbits

    def write_flag(self, flag) -> None:
        self.write(1 if flag else 0, 1)

    # -- Exp-Golomb --------------------------------------------------------
    def write_uvlc(self, value: int) -> None:
        """ue(v): unsigned Exp-Golomb."""
        assert value >= 0
        code = value + 1
        length = code.bit_length()
        self.write(0, length - 1)
        self.write(code, length)

    def write_svlc(self, value: int) -> None:
        """se(v): signed Exp-Golomb; positive values map to odd codes minus one."""
        self.write_uvlc((value << 1) - 1 if value > 0 else (-value) << 1)

    # -- alignment ---------------------------------------------------------
    @property
    def num_bits(self) -> int:
        return 8 * len(self._buf) + self._held_bits

    def is_byte_aligned(self) -> bool:
        return self._held_bits == 0

    def write_rbsp_trailing_bits(self) -> None:
        """rbsp_stop_one_bit followed by zero alignment bits (H.266 7.3.2.11)."""
        self.write(1, 1)
        self.align_zero()

    def align_zero(self) -> None:
        if self._held_bits:
            self.write(0, 8 - self._held_bits)

    def align_one(self) -> None:
        while self._held_bits:
            self.write(1, 1)

    def write_byte_alignment(self) -> None:
        """byte_alignment(): alignment_bit_equal_to_one then zeros (7.3.2.12)."""
        self.write(1, 1)
        self.align_zero()

    def append_bytes(self, data: bytes) -> None:
        assert self.is_byte_aligned()
        self._buf.extend(data)

    def get_bytes(self) -> bytes:
        assert self.is_byte_aligned(), "stream not byte aligned"
        return bytes(self._buf)


class BitReader:
    """MSB-first bit reader over an RBSP payload (EBSP already stripped)."""

    __slots__ = ("_data", "_pos_bits")

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos_bits = 0

    def read(self, num_bits: int) -> int:
        if num_bits == 0:
            return 0
        end = self._pos_bits + num_bits
        assert end <= 8 * len(self._data), "read past end of stream"
        value = 0
        pos = self._pos_bits
        while num_bits > 0:
            byte = self._data[pos >> 3]
            bit_off = pos & 7
            take = min(8 - bit_off, num_bits)
            chunk = (byte >> (8 - bit_off - take)) & ((1 << take) - 1)
            value = (value << take) | chunk
            pos += take
            num_bits -= take
        self._pos_bits = pos
        return value

    def read_flag(self) -> int:
        return self.read(1)

    def read_uvlc(self) -> int:
        leading_zeros = 0
        while self.read(1) == 0:
            leading_zeros += 1
            assert leading_zeros < 32
        return (1 << leading_zeros) - 1 + (self.read(leading_zeros) if leading_zeros else 0)

    def read_svlc(self) -> int:
        code = self.read_uvlc()
        return (code + 1) >> 1 if (code & 1) else -(code >> 1)

    def read_byte(self) -> int:
        """Unaligned byte read used by the CABAC decoder."""
        return self.read(8)

    @property
    def pos_bits(self) -> int:
        return self._pos_bits

    @property
    def bits_left(self) -> int:
        return 8 * len(self._data) - self._pos_bits

    def byte_align(self) -> None:
        self._pos_bits = (self._pos_bits + 7) & ~7

    def more_rbsp_data(self) -> bool:
        """True if there is payload before the rbsp_stop_one_bit."""
        if self.bits_left <= 0:
            return False
        # find last byte with a nonzero bit => position of rbsp_stop_one_bit
        data = self._data
        last = len(data) - 1
        while last >= 0 and data[last] == 0:
            last -= 1
        if last < 0:
            return False
        stop_byte = data[last]
        # lowest set bit position within the byte
        lsb = (stop_byte & -stop_byte).bit_length() - 1
        stop_bit_pos = 8 * last + (7 - lsb)
        return self._pos_bits < stop_bit_pos

"""VVC CABAC arithmetic coding engine (encoder + decoder + bit estimator).

Implements the binary arithmetic coder of ITU-T H.266 section 9.3.4 with the
two-rate adaptive probability model of section 9.3.3 (15-bit nominal
probability held as a 10-bit and a 14-bit estimate with per-context
adaptation windows).  Behavioral reference: vvenc EncoderLib/BinEncoder.cpp
(encoder) and CommonLib/Contexts.h:BinProbModel (probability model); the
decoder mirrors H.266 9.3.4.3 and is used by the bundled subset decoder for
round-trip/conformance testing.

Probability state layout (vectorized over all contexts with numpy):
  state0 : 15-bit value masked to the top 10 bits   (fast-adapting estimate)
  state1 : 15-bit value masked to the top 14 bits   (slow-adapting estimate)
  state()   = (state0 + state1) >> 8       -> 8-bit combined probability of 1
  mps()     = state >> 7
  LPS range = (((q>>2) * (range>>5)) >> 1) + 4, q = state ^ (0xff if mps)
"""

from __future__ import annotations

import math

import numpy as np

from .ctx_tables import INIT_VALUES, RATE_VALUES, NUM_CTX
from ..utils.dtrace import DTRACE

PROB_BITS = 15
PROB_BITS_0 = 10
PROB_BITS_1 = 14
MASK_0 = ((1 << PROB_BITS_0) - 1) << (PROB_BITS - PROB_BITS_0)  # 0x7FE0
MASK_1 = ((1 << PROB_BITS_1) - 1) << (PROB_BITS - PROB_BITS_1)  # 0x7FFE
SCALE_BITS = 15  # fractional-bit fixed point used by RDO (2^15 per bit)

# renormalization shift per (LPS>>3) bucket, H.266 9.3.4.3.2.2
RENORM_TABLE_32 = np.array(
    [6, 5, 4, 4] + [3] * 4 + [2] * 8 + [1] * 16, dtype=np.int32)


def _make_frac_bits_table() -> np.ndarray:
    """fracBits[state8][bin] = round(-log2(p_bin) * 2^SCALE_BITS).

    p(bin=1) = (2*state8 + 1) / 512.  Matches the normative estimator table
    (vvenc ProbModelTables::m_binFracBits, Contexts.cpp:70) which is the
    same quantized entropy table.
    """
    t = np.zeros((256, 2), dtype=np.uint32)
    for s in range(256):
        p1 = (2 * s + 1) / 512.0
        t[s, 1] = int(round(-math.log2(p1) * (1 << SCALE_BITS)))
        t[s, 0] = int(round(-math.log2(1.0 - p1) * (1 << SCALE_BITS)))
    return t


FRAC_BITS_TABLE = _make_frac_bits_table()
FRAC_BITS_EP = 1 << SCALE_BITS
# terminating-bin estimator costs (bin=0, bin=1)
FRAC_BITS_TRM = (0x0010C, 0x3BFBB)

MAX_QP = 63


class CtxModels:
    """All context probability states, vectorized (numpy uint16 arrays)."""

    __slots__ = ("state0", "state1", "rate0", "rate1")

    def __init__(self, other: "CtxModels | None" = None):
        if other is not None:
            self.state0 = other.state0.copy()
            self.state1 = other.state1.copy()
            self.rate0 = other.rate0.copy()
            self.rate1 = other.rate1.copy()
        else:
            half = np.uint16(1 << (PROB_BITS - 1))
            self.state0 = np.full(NUM_CTX, half & MASK_0, dtype=np.uint16)
            self.state1 = np.full(NUM_CTX, half & MASK_1, dtype=np.uint16)
            self.rate0 = np.full(NUM_CTX, 4, dtype=np.uint8)
            self.rate1 = np.full(NUM_CTX, 7, dtype=np.uint8)

    def init(self, qp: int, init_id: int) -> None:
        """Initialize all contexts for a slice (H.266 9.3.2.2).

        init_id: 0=B, 1=P, 2=I row of the init tables.
        """
        qp = max(0, min(MAX_QP, qp))
        iv = INIT_VALUES[init_id].astype(np.int32)
        slope = (iv >> 3) - 4
        offset = ((iv & 7) * 18) + 1
        st = ((slope * (qp - 16)) >> 1) + offset
        st = np.clip(st, 1, 127)
        p1 = (st << 8).astype(np.uint16)
        self.state0 = p1 & MASK_0
        self.state1 = p1 & MASK_1
        lws = RATE_VALUES.astype(np.int32)
        r0 = 2 + ((lws >> 2) & 3)
        r1 = 3 + r0 + (lws & 3)
        self.rate0 = r0.astype(np.uint8)
        self.rate1 = r1.astype(np.uint8)

    # scalar per-bin operations (host entropy coding path) -----------------
    def state8(self, ctx: int) -> int:
        return (int(self.state0[ctx]) + int(self.state1[ctx])) >> 8

    def mps(self, ctx: int) -> int:
        return self.state8(ctx) >> 7

    def lps_range(self, state8: int, rng: int) -> int:
        q = state8
        if q & 0x80:
            q ^= 0xFF
        return (((q >> 2) * (rng >> 5)) >> 1) + 4

    def update(self, ctx: int, binval: int) -> None:
        r0 = int(self.rate0[ctx])
        r1 = int(self.rate1[ctx])
        s0 = int(self.state0[ctx])
        s1 = int(self.state1[ctx])
        s0 -= (s0 >> r0) & MASK_0
        s1 -= (s1 >> r1) & MASK_1
        if binval:
            s0 += (0x7FFF >> r0) & MASK_0
            s1 += (0x7FFF >> r1) & MASK_1
        self.state0[ctx] = s0
        self.state1[ctx] = s1

    def frac_bits(self, ctx: int, binval: int) -> int:
        return int(FRAC_BITS_TABLE[self.state8(ctx), binval])


class CabacEncoder:
    """Binary arithmetic encoder (H.266 9.3.4.4) writing into a BitWriter."""

    def __init__(self, bit_writer, ctx: CtxModels | None = None):
        self.bw = bit_writer
        self.ctx = ctx if ctx is not None else CtxModels()
        self.start()

    def start(self) -> None:
        self.low = 0
        self.range = 510
        self.buffered_byte = 0xFF
        self.num_buffered_bytes = 0
        self.bits_left = 23

    def init_ctx(self, qp: int, init_id: int) -> None:
        self.ctx.init(qp, init_id)
        self.start()

    # ------------------------------------------------------------------
    def encode_bin(self, binval: int, ctx_id: int) -> None:
        c = self.ctx
        s8 = c.state8(ctx_id)
        if DTRACE.enabled:
            DTRACE.trace("D_CABAC", "bin=%d ctx=%d range=%d state=%d",
                         binval, ctx_id, self.range, s8)
        lps = c.lps_range(s8, self.range)
        self.range -= lps
        if binval != (s8 >> 7):
            num_bits = int(RENORM_TABLE_32[lps >> 3])
            self.bits_left -= num_bits
            self.low = (self.low + self.range) << num_bits
            self.range = lps << num_bits
            if self.bits_left < 12:
                self._write_out()
        else:
            if self.range < 256:
                self.bits_left -= 1
                self.low <<= 1
                self.range <<= 1
                if self.bits_left < 12:
                    self._write_out()
        c.update(ctx_id, binval)

    def encode_bin_ep(self, binval: int) -> None:
        self.low <<= 1
        if binval:
            self.low += self.range
        self.bits_left -= 1
        if self.bits_left < 12:
            self._write_out()

    def encode_bins_ep(self, bins: int, num_bins: int) -> None:
        if self.range == 256:
            self._encode_aligned_bins_ep(bins, num_bins)
            return
        while num_bins > 8:
            num_bins -= 8
            pattern = bins >> num_bins
            self.low = (self.low << 8) + self.range * pattern
            bins -= pattern << num_bins
            self.bits_left -= 8
            if self.bits_left < 12:
                self._write_out()
        self.low = (self.low << num_bins) + self.range * bins
        self.bits_left -= num_bins
        if self.bits_left < 12:
            self._write_out()

    def _encode_aligned_bins_ep(self, bins: int, num_bins: int) -> None:
        rem = num_bins
        while rem > 0:
            take = min(rem, 8)
            mask = (1 << take) - 1
            new_bins = (bins >> (rem - take)) & mask
            self.low = (self.low << take) + (new_bins << 8)
            rem -= take
            self.bits_left -= take
            if self.bits_left < 12:
                self._write_out()

    def encode_remabs_ep(self, value: int, rice_par: int, cutoff: int,
                         max_log2_tr_dyn_range: int) -> None:
        """abs_remainder / dec_abs_level binarization (H.266 9.3.3.3-9.3.3.5):
        truncated-Rice prefix up to `cutoff`, then limited Exp-Golomb."""
        threshold = cutoff << rice_par
        if value < threshold:
            length = (value >> rice_par) + 1
            self.encode_bins_ep((1 << length) - 2, length)
            if rice_par:
                self.encode_bins_ep(value & ((1 << rice_par) - 1), rice_par)
        else:
            max_prefix_len = 32 - cutoff - max_log2_tr_dyn_range
            prefix_len = 0
            code_value = (value >> rice_par) - cutoff
            if code_value >= (1 << max_prefix_len) - 1:
                prefix_len = max_prefix_len
                suffix_len = max_log2_tr_dyn_range
            else:
                while code_value > (2 << prefix_len) - 2:
                    prefix_len += 1
                suffix_len = prefix_len + rice_par + 1  # incl. separator bit
            total_prefix_len = prefix_len + cutoff
            prefix = (1 << total_prefix_len) - 1
            suffix = ((code_value - ((1 << prefix_len) - 1)) << rice_par) \
                | (value & ((1 << rice_par) - 1))
            self.encode_bins_ep(prefix, total_prefix_len)
            self.encode_bins_ep(suffix, suffix_len)

    def encode_bin_trm(self, binval: int) -> None:
        self.range -= 2
        if binval:
            self.low += self.range
            self.low <<= 7
            self.range = 2 << 7
            self.bits_left -= 7
        elif self.range >= 256:
            return
        else:
            self.low <<= 1
            self.range <<= 1
            self.bits_left -= 1
        if self.bits_left < 12:
            self._write_out()

    def align(self) -> None:
        self.range = 256

    # ------------------------------------------------------------------
    def _write_out(self) -> None:
        lead_byte = self.low >> (24 - self.bits_left)
        self.bits_left += 8
        self.low &= 0xFFFFFFFF >> self.bits_left
        if lead_byte == 0xFF:
            self.num_buffered_bytes += 1
        elif self.num_buffered_bytes > 0:
            carry = lead_byte >> 8
            self.bw.write((self.buffered_byte + carry) & 0xFF, 8)
            self.buffered_byte = lead_byte & 0xFF
            fill = (0xFF + carry) & 0xFF
            while self.num_buffered_bytes > 1:
                self.bw.write(fill, 8)
                self.num_buffered_bytes -= 1
        else:
            self.num_buffered_bytes = 1
            self.buffered_byte = lead_byte & 0xFF

    def finish(self) -> None:
        """Flush the arithmetic coder (end_of_slice handling done by caller)."""
        if self.low >> (32 - self.bits_left):
            self.bw.write(self.buffered_byte + 1, 8)
            while self.num_buffered_bytes > 1:
                self.bw.write(0x00, 8)
                self.num_buffered_bytes -= 1
            self.low -= 1 << (32 - self.bits_left)
        else:
            if self.num_buffered_bytes > 0:
                self.bw.write(self.buffered_byte, 8)
            while self.num_buffered_bytes > 1:
                self.bw.write(0xFF, 8)
                self.num_buffered_bytes -= 1
        self.bw.write(self.low >> 8, 24 - self.bits_left)


class CabacDecoder:
    """Binary arithmetic decoder (H.266 9.3.4.3) reading from a BitReader."""

    def __init__(self, bit_reader, ctx: CtxModels | None = None):
        self.br = bit_reader
        self.ctx = ctx if ctx is not None else CtxModels()
        self._started = False

    def start(self) -> None:
        """Consume the 16-bit initialization window (call exactly once)."""
        assert not self._started, "arithmetic decoder already started"
        self._started = True
        self.range = 510
        self.value = (self._next_byte() << 8) + self._next_byte()
        self.bits_needed = -8

    def init_ctx(self, qp: int, init_id: int) -> None:
        self.ctx.init(qp, init_id)
        if not self._started:
            self.start()

    def _next_byte(self) -> int:
        """Read 8 bits, zero-padded past end of payload (the arithmetic
        decoder reads up to 16 bits of lookahead beyond the last coded bin)."""
        left = self.br.bits_left
        if left >= 8:
            return self.br.read_byte()
        if left <= 0:
            return 0
        return self.br.read(left) << (8 - left)

    def _refill(self) -> None:
        self.bits_needed += 1
        if self.bits_needed == 0:
            self.bits_needed = -8
            self.value += self._next_byte()

    def decode_bin(self, ctx_id: int) -> int:
        c = self.ctx
        s8 = c.state8(ctx_id)
        if DTRACE.enabled:
            DTRACE.trace("D_CABAC", "bin ctx=%d range=%d state=%d",
                         ctx_id, self.range, s8)
        binval = s8 >> 7
        lps = c.lps_range(s8, self.range)
        self.range -= lps
        scaled_range = self.range << 7
        if self.value < scaled_range:
            if scaled_range < (256 << 7):
                self.range = scaled_range >> 6
                self.value += self.value
                self._refill()
        else:
            num_bits = int(RENORM_TABLE_32[lps >> 3])
            self.value = (self.value - scaled_range) << num_bits
            self.range = lps << num_bits
            binval = 1 - binval
            self.bits_needed += num_bits
            if self.bits_needed >= 0:
                self.value += self._next_byte() << self.bits_needed
                self.bits_needed -= 8
        c.update(ctx_id, binval)
        return binval

    def decode_bin_ep(self) -> int:
        self.value += self.value
        self._refill()
        binval = 0
        scaled_range = self.range << 7
        if self.value >= scaled_range:
            self.value -= scaled_range
            binval = 1
        return binval

    def decode_bins_ep(self, num_bins: int) -> int:
        bins = 0
        for _ in range(num_bins):
            bins = (bins << 1) | self.decode_bin_ep()
        return bins

    def decode_remabs_ep(self, rice_par: int, cutoff: int,
                         max_log2_tr_dyn_range: int) -> int:
        prefix = 0
        while prefix < cutoff and self.decode_bin_ep():
            prefix += 1
        if prefix < cutoff:
            suffix = self.decode_bins_ep(rice_par) if rice_par else 0
            return (prefix << rice_par) + suffix
        # Exp-Golomb escape: (cutoff+egPrefix) ones [+ separator 0 unless at
        # max], then egPrefix+ricePar (or maxLog2TrDynamicRange) suffix bits
        max_prefix_len = 32 - cutoff - max_log2_tr_dyn_range
        eg_prefix = 0
        while eg_prefix < max_prefix_len and self.decode_bin_ep():
            eg_prefix += 1
        if eg_prefix == max_prefix_len:
            suffix_len = max_log2_tr_dyn_range
        else:
            suffix_len = eg_prefix + rice_par  # separator 0 already consumed
        suffix = self.decode_bins_ep(suffix_len) if suffix_len else 0
        base = (1 << eg_prefix) - 1
        code_value = base + (suffix >> rice_par)
        low_bits = suffix & ((1 << rice_par) - 1)
        return ((cutoff + code_value) << rice_par) + low_bits

    def decode_bin_trm(self) -> int:
        self.range -= 2
        scaled_range = self.range << 7
        if self.value >= scaled_range:
            return 1
        if scaled_range < (256 << 7):
            self.range = scaled_range >> 6
            self.value += self.value
            self._refill()
        return 0


class BitEstimator:
    """Fractional-bit estimator for RDO (vvenc BitEstimator analog).

    Accumulates SCALE_BITS fixed-point bits; shares CtxModels so estimates
    track the real coding state when loaded from a snapshot.
    """

    def __init__(self, ctx: CtxModels | None = None):
        self.ctx = ctx if ctx is not None else CtxModels()
        self.frac_bits = 0

    def encode_bin(self, binval: int, ctx_id: int) -> None:
        self.frac_bits += self.ctx.frac_bits(ctx_id, binval)
        self.ctx.update(ctx_id, binval)

    def encode_bin_ep(self, binval: int) -> None:
        self.frac_bits += FRAC_BITS_EP

    def encode_bins_ep(self, bins: int, num_bins: int) -> None:
        self.frac_bits += num_bins * FRAC_BITS_EP

    def encode_bin_trm(self, binval: int) -> None:
        self.frac_bits += FRAC_BITS_TRM[binval]

    def encode_remabs_ep(self, value: int, rice_par: int, cutoff: int,
                         max_log2_tr_dyn_range: int) -> None:
        """EP-bin count of the go-rice/exp-golomb binarization
        (vvenc BitEstimatorBase::encodeRemAbsEP, BinEncoder.cpp:424)."""
        threshold = cutoff << rice_par
        if value < threshold:
            self.frac_bits += ((value >> rice_par) + 1 + rice_par) * FRAC_BITS_EP
        else:
            max_prefix_len = 32 - cutoff - max_log2_tr_dyn_range
            prefix_len = 0
            code_value = (value >> rice_par) - cutoff
            if code_value >= (1 << max_prefix_len) - 1:
                prefix_len = max_prefix_len
                suffix_len = max_log2_tr_dyn_range
            else:
                while code_value > (2 << prefix_len) - 2:
                    prefix_len += 1
                suffix_len = prefix_len + rice_par + 1
            self.frac_bits += (cutoff + prefix_len + suffix_len) * FRAC_BITS_EP

    def snapshot(self):
        return (CtxModels(self.ctx), self.frac_bits)

    def restore(self, snap) -> None:
        self.ctx, self.frac_bits = CtxModels(snap[0]), snap[1]

    def get_bits(self) -> float:
        return self.frac_bits / (1 << SCALE_BITS)

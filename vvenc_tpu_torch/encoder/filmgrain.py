"""Film grain analysis -> film_grain_characteristics (FGC) SEI.

A copy of vvenc_tpu/encoder/filmgrain.py, unchanged: host code, no device program.

Structural analog of vvenc EncoderLib/SEIFilmGrainAnalyzer.{h,cpp}
(FGAnalyzer :177, Canny :83, Morph :146): estimate the noise/grain level
of the source per intensity interval so a decoder-side grain synthesizer
can re-add it after the (grain-removing) encode.

Pipeline (vvenc doFGanalysis analog, simplified to the frequency-filtering
model the SEI carries):
1. edge mask via Sobel gradients + hysteresis-free threshold (the Canny
   stage; edges and textured areas must not be mistaken for grain);
2. per 8x8 flat block: grain energy = variance of the high-pass residual
   (orig - 3x3 box blur), accumulated per intensity bin;
3. intensity intervals with consistent energy -> comp model values
   (log2-scale-factor fixed-point, model_id 0 = frequency filtering).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..bitstream.bitwriter import BitWriter, BitReader

SEI_FILM_GRAIN = 19  # H.274 payloadType


@dataclass
class FilmGrainModel:
    """One component's grain model: list of (lower, upper, [values])."""
    intervals: List[Tuple[int, int, List[int]]] = field(default_factory=list)


@dataclass
class SeiFilmGrain:
    cancel: int = 0
    model_id: int = 0             # 0: frequency filtering
    blending_mode: int = 0        # 0: additive
    log2_scale_factor: int = 4
    comp_models: List[Optional[FilmGrainModel]] = field(
        default_factory=lambda: [None, None, None])
    persistence: int = 1

    def payload(self) -> bytes:
        bw = BitWriter()
        bw.write_flag(self.cancel)
        if not self.cancel:
            bw.write(self.model_id, 2)
            bw.write_flag(0)  # separate_colour_description_present
            bw.write(self.blending_mode, 2)
            bw.write(self.log2_scale_factor, 4)
            for c in range(3):
                bw.write_flag(1 if self.comp_models[c] else 0)
            for c in range(3):
                m = self.comp_models[c]
                if not m:
                    continue
                bw.write(len(m.intervals) - 1, 8)
                nv = len(m.intervals[0][2])
                bw.write(nv - 1, 3)
                for lo, hi, vals in m.intervals:
                    bw.write(lo, 8)
                    bw.write(hi, 8)
                    for v in vals:
                        bw.write_svlc(v)
            bw.write_flag(self.persistence)
        bw.write_rbsp_trailing_bits()
        return bw.get_bytes()

    @classmethod
    def parse(cls, data: bytes) -> "SeiFilmGrain":
        br = BitReader(data)
        out = cls()
        out.cancel = br.read_flag()
        if out.cancel:
            return out
        out.model_id = br.read(2)
        assert br.read_flag() == 0
        out.blending_mode = br.read(2)
        out.log2_scale_factor = br.read(4)
        present = [br.read_flag() for _ in range(3)]
        for c in range(3):
            if not present[c]:
                continue
            n_int = br.read(8) + 1
            n_val = br.read(3) + 1
            m = FilmGrainModel()
            for _ in range(n_int):
                lo = br.read(8)
                hi = br.read(8)
                vals = [br.read_svlc() for _ in range(n_val)]
                m.intervals.append((lo, hi, vals))
            out.comp_models[c] = m
        out.persistence = br.read_flag()
        return out


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------

def _sobel_mag(y: np.ndarray) -> np.ndarray:
    """|Sobel| gradient magnitude, 0 on the border (the Canny stage's
    gradient; vvenc FGAnalyzer uses the same 3x3 kernels)."""
    s = y.astype(np.int64)
    gx = np.zeros_like(s)
    gy = np.zeros_like(s)
    c = np.s_[1:-1, 1:-1]
    gx[c] = (s[:-2, 2:] + 2 * s[1:-1, 2:] + s[2:, 2:]
             - s[:-2, :-2] - 2 * s[1:-1, :-2] - s[2:, :-2])
    gy[c] = (s[2:, :-2] + 2 * s[2:, 1:-1] + s[2:, 2:]
             - s[:-2, :-2] - 2 * s[:-2, 1:-1] - s[:-2, 2:])
    return np.abs(gx) + np.abs(gy)


def _box3(y: np.ndarray) -> np.ndarray:
    """3x3 box blur (edge-replicated)."""
    p = np.pad(y.astype(np.int64), 1, mode="edge")
    out = np.zeros_like(y, dtype=np.int64)
    for dy in range(3):
        for dx in range(3):
            out += p[dy:dy + y.shape[0], dx:dx + y.shape[1]]
    return out // 9


def analyze_grain(y: np.ndarray, bit_depth: int = 8, block: int = 8,
                  edge_thresh: int = 80, n_bins: int = 8):
    """Per-intensity-bin grain energy of one luma plane.

    Returns (bin_means, bin_sigmas) where sigma is the std-dev of the
    high-pass residual over flat (non-edge) blocks, indexed by intensity
    bin; NaN sigma marks bins with no flat blocks."""
    shift = bit_depth - 8
    y8 = (y >> shift).astype(np.int32) if shift else y.astype(np.int32)
    h, w = y8.shape
    hb, wb = h // block, w // block
    if hb == 0 or wb == 0:
        return np.zeros(n_bins), np.full(n_bins, np.nan)
    edges = _sobel_mag(y8) > edge_thresh * 4
    hp = y8 - _box3(y8)

    def blocks(a):
        return a[:hb * block, :wb * block].reshape(
            hb, block, wb, block).transpose(0, 2, 1, 3).reshape(
            hb * wb, block * block)
    eb = blocks(edges).mean(axis=1)
    vb = blocks(hp).astype(np.float64)
    mb = blocks(y8).mean(axis=1)
    flat = eb < 0.05                       # blocks with (almost) no edges
    sig = np.sqrt((vb ** 2).mean(axis=1))
    sums = np.zeros(n_bins)
    cnts = np.zeros(n_bins)
    means = np.zeros(n_bins)
    for b in range(n_bins):
        lo, hi = 256 * b // n_bins, 256 * (b + 1) // n_bins
        m = flat & (mb >= lo) & (mb < hi)
        cnts[b] = m.sum()
        if cnts[b]:
            sums[b] = sig[m].mean()
        means[b] = (lo + hi) / 2
    sigmas = np.where(cnts > 0, sums, np.nan)
    return means, sigmas


# ---------------------------------------------------------------------------
# Canny + Morph (vvenc SEIFilmGrainAnalyzer.h Canny:83, Morph:146)
# ---------------------------------------------------------------------------

def _gauss5(y: np.ndarray) -> np.ndarray:
    """5x5 Gaussian blur (the Canny pre-filter; binomial [1 4 6 4 1])."""
    k = np.array([1, 4, 6, 4, 1], np.int64)
    p = np.pad(y.astype(np.int64), 2, mode="edge")
    t = sum(k[i] * p[:, i:i + y.shape[1]] for i in range(5))
    o = sum(k[i] * t[i:i + y.shape[0], :] for i in range(5))
    return o // 256


def canny_mask(y: np.ndarray, low_ratio: float = 0.4,
               high_pct: float = 90.0) -> np.ndarray:
    """Canny edge detection (vvenc Canny::detect_edges): Gaussian blur,
    Sobel gradient + orientation, non-maximum suppression, double
    threshold, hysteresis edge tracking.  Returns a bool edge mask."""
    g = _gauss5(y)
    s = g.astype(np.int64)
    gx = np.zeros_like(s)
    gy = np.zeros_like(s)
    c = np.s_[1:-1, 1:-1]
    gx[c] = (s[:-2, 2:] + 2 * s[1:-1, 2:] + s[2:, 2:]
             - s[:-2, :-2] - 2 * s[1:-1, :-2] - s[2:, :-2])
    gy[c] = (s[2:, :-2] + 2 * s[2:, 1:-1] + s[2:, 2:]
             - s[:-2, :-2] - 2 * s[:-2, 1:-1] - s[:-2, 2:])
    mag = np.hypot(gx, gy)
    # orientation quantized to 4 directions (0/45/90/135 deg)
    ang = np.degrees(np.arctan2(gy, gx)) % 180.0
    dbin = np.zeros(y.shape, np.int8)
    dbin[(ang >= 22.5) & (ang < 67.5)] = 1
    dbin[(ang >= 67.5) & (ang < 112.5)] = 2
    dbin[(ang >= 112.5) & (ang < 157.5)] = 3
    # non-maximum suppression (Canny::suppressNonMax)
    mp = np.pad(mag, 1, mode="constant")
    offs = {0: ((0, 1), (0, -1)), 1: ((-1, 1), (1, -1)),
            2: ((1, 0), (-1, 0)), 3: ((1, 1), (-1, -1))}
    nms = np.zeros_like(mag)
    for d, ((dy0, dx0), (dy1, dx1)) in offs.items():
        n0 = mp[1 + dy0:1 + dy0 + y.shape[0], 1 + dx0:1 + dx0 + y.shape[1]]
        n1 = mp[1 + dy1:1 + dy1 + y.shape[0], 1 + dx1:1 + dx1 + y.shape[1]]
        m = dbin == d
        keep = m & (mag >= n0) & (mag >= n1)
        nms[keep] = mag[keep]
    # double threshold (Canny::doubleThreshold) from the magnitude
    # distribution, then hysteresis (Canny::edgeTracking): weak pixels
    # survive only when 8-connected to a strong pixel
    nz = nms[nms > 0]
    if nz.size == 0:
        return np.zeros(y.shape, bool)
    high = np.percentile(nz, high_pct)
    low = low_ratio * high
    strong = nms >= high
    weak = nms >= low
    try:
        import scipy.ndimage as ndi
        edges = ndi.binary_propagation(strong, mask=weak,
                                       structure=np.ones((3, 3), bool))
    except ImportError:
        edges = strong.copy()
        for _ in range(8):     # bounded propagation fallback
            grown = _dilate(edges) & weak
            if (grown == edges).all():
                break
            edges = grown
    return edges


def _dilate(m: np.ndarray, it: int = 1) -> np.ndarray:
    """3x3 binary dilation (vvenc Morph::dilation)."""
    out = m
    for _ in range(it):
        p = np.pad(out, 1, mode="constant")
        acc = np.zeros_like(out)
        for dy in range(3):
            for dx in range(3):
                acc |= p[dy:dy + m.shape[0], dx:dx + m.shape[1]]
        out = acc
    return out


def _dct8_energy(flat_blocks: np.ndarray) -> np.ndarray:
    """Mean |DCT-8x8| of the grain-residual blocks [n, 64] — the
    cut-off-frequency source (FGAnalyzer::blockTransform analog at
    8x8; synthesis low-passes in the transform domain)."""
    k = np.arange(8)
    C = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16.0)
    C[0] *= 1.0 / np.sqrt(2.0)
    C *= 0.5
    n = len(flat_blocks)
    if n == 0:
        return np.zeros((8, 8))
    blk = flat_blocks.reshape(n, 8, 8)
    d = np.einsum("ij,njk,lk->nil", C, blk, C)
    return np.abs(d).mean(axis=0)


def derive_fgc_sei(frames_y, bit_depth: int = 8,
                   min_sigma: float = 0.8) -> Optional[SeiFilmGrain]:
    """Film grain analysis -> FGC SEI (FGAnalyzer::estimateGrainParameters
    analog):

    1. mask = dilated Canny edges (findMask: edges/texture are not grain);
    2. grain estimate = orig - Gaussian-denoised orig (the reference
       subtracts the MCTF-filtered picture; the Gaussian stands in when
       the analysis runs before temporal filtering);
    3. per flat 8x8 block: (mean intensity, grain sigma) data points +
       the block-DCT magnitude accumulation for the cut-off frequencies;
    4. least-squares polynomial fit of sigma over intensity with edge
       extension (fitFunction + extendPoints);
    5. intervals where the quantized fitted scaling is constant become
       the SEI's intensity intervals (defineIntervalsAndScalings +
       scaleDown); model values are [scale, h_cutoff, v_cutoff].

    Returns None when the grain level is below synthesis-worthy
    everywhere."""
    pts_mean = []
    pts_sig = []
    dct_acc = np.zeros((8, 8))
    dct_n = 0
    for y in frames_y[:8]:
        shift = bit_depth - 8
        y8 = (np.asarray(y) >> shift).astype(np.int32) if shift \
            else np.asarray(y).astype(np.int32)
        h, w = y8.shape
        hb, wb = h // 8, w // 8
        if hb == 0 or wb == 0:
            continue
        mask = _dilate(canny_mask(y8), it=1)
        filt = _gauss5(y8)
        res = (y8 - filt).astype(np.float64)

        def blocks(a):
            return a[:hb * 8, :wb * 8].reshape(
                hb, 8, wb, 8).transpose(0, 2, 1, 3).reshape(hb * wb, 64)
        edge_frac = blocks(mask).mean(axis=1)
        flat = edge_frac == 0.0            # countEdges: fully flat only
        if flat.sum() < 16:
            flat = edge_frac < 0.05        # very textured content
        if flat.sum() < 16:
            # heavy-grain content: Canny fires on the grain itself —
            # take the flattest half of the blocks instead
            flat = edge_frac <= np.percentile(edge_frac, 50.0)
        rb = blocks(res)
        mb = blocks(filt).mean(axis=1)
        sig = np.sqrt((rb ** 2).mean(axis=1))
        # regularize excessively fluctuating points (reference clamp)
        med = np.median(sig[flat]) if flat.any() else 0.0
        good = flat & (sig <= 4.0 * max(med, 1e-3))
        pts_mean.append(mb[good])
        pts_sig.append(sig[good])
        if good.any():
            dct_acc += _dct8_energy(rb[good][:256])
            dct_n += 1
    if not pts_mean:
        return None
    mean_v = np.concatenate(pts_mean)
    sig_v = np.concatenate(pts_sig)
    if mean_v.size < 16 or float(np.max(sig_v, initial=0.0)) < min_sigma:
        return None
    # polynomial fit sigma(intensity), order 3 (fitFunction), evaluated
    # over the observed range and edge-extended outside (extendPoints)
    order = min(3, max(1, mean_v.size // 8))
    coef = np.polyfit(mean_v, sig_v, order)
    lo_i, hi_i = int(mean_v.min()), int(mean_v.max())
    xs = np.arange(256, dtype=np.float64)
    fit = np.polyval(coef, np.clip(xs, lo_i, hi_i))
    fit = np.clip(fit, 0.0, None)
    if float(fit.max()) < min_sigma:
        return None
    # cut-off frequencies from the averaged residual DCT: highest
    # row/col whose energy stays above 10% of the DC-adjacent level,
    # mapped to the synthesis grid (value range 2..14)
    if dct_n:
        d = dct_acc / dct_n
        ref_lv = max(d[0, 1:].max(), d[1:, 0].max(), 1e-6)
        col_e = d.max(axis=0)
        row_e = d.max(axis=1)
        h_cut = int(np.clip(((np.nonzero(col_e >= 0.1 * ref_lv)[0].max()
                              if (col_e >= 0.1 * ref_lv).any() else 7)
                             + 1) * 14 // 8, 2, 14))
        v_cut = int(np.clip(((np.nonzero(row_e >= 0.1 * ref_lv)[0].max()
                              if (row_e >= 0.1 * ref_lv).any() else 7)
                             + 1) * 14 // 8, 2, 14))
    else:
        h_cut = v_cut = 8
    sei = SeiFilmGrain()
    scale = 1 << sei.log2_scale_factor
    # defineIntervalsAndScalings: merge consecutive intensities with the
    # same quantized scaling into intervals; drop sub-threshold ones
    q = np.round(fit * scale).astype(np.int64)
    q[fit < min_sigma] = 0
    m = FilmGrainModel()
    start = None
    for i in range(257):
        cur = q[i] if i < 256 else -1
        if start is None:
            if cur > 0:
                start = i
        elif cur != q[start]:
            m.intervals.append((start, i - 1,
                                [int(q[start]), h_cut, v_cut]))
            start = i if cur > 0 else None
        if len(m.intervals) >= 10 and start is not None:
            m.intervals.append((start, 255, [int(q[start]), h_cut, v_cut]))
            start = None
            break
    if not m.intervals:
        return None
    sei.comp_models[0] = m
    return sei

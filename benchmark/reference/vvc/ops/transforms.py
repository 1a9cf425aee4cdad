"""VVC primary transforms (DCT-2 family) + quantization.

Transform matrices are the normative integer tables of ITU-T H.266 8.7.4.1.
The whole DCT-2 family (2..64 points) is generated from the 63 tuned base
values using the even-row recursion (an N-point even row embeds the N/2-point
matrix symmetrically) and the odd-row cosine index mapping — this reproduces
the spec tables exactly (verified against known 4/8-point rows in tests).

Shift conventions (behavioral reference: vvenc CommonLib/TrQuant.cpp:544-545
forward, :608-609 inverse; CommonLib/Quant.cpp:735 quant, :520 dequant):

  forward:  shift1 = log2W + bitDepth + 6 - 15,  shift2 = log2H + 6
  inverse:  shift1 = 7, shift2 = 20 - bitDepth, 16-bit clamp between stages
  transformShift = 15 - bitDepth - (log2W + log2H)//2
  quant:    q = sign * ((|c| * qScale[qp%6] + deadzone) >> (14 + qp//6 + transformShift))
  dequant:  d = clip16(((q * invScale[qp%6] << qp//6) + rnd) >> (6 - transformShift))

Blocks with odd log2(W*H) use the sqrt(2)-compensated scale rows.

The batched half at the end ([B, h, w] int32 on a torch device) is the
device side of the mesh path's partition-level trial (parallel/mesh.py
search_step):

  fwd_transform_batch / inv_transform_batch -> K6, csrc/transform_batch.cu
  quant_batch / dequant_batch               -> K7, csrc/quant_batch.cu

Each wrapper launches its CUDA kernel for a CUDA tensor and runs its plain
PyTorch version (`*_ref`) for a CPU tensor.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from . import kernels

# 63 tuned base values of the DCT-2 family (H.266 8.7.4.1 tables): group g
# holds the odd-row defining values of the 2^(g+1)-point matrix.
_DCT2_BASE = [
    [64],
    [83, 36],
    [89, 75, 50, 18],
    [90, 87, 80, 70, 57, 43, 25, 9],
    [90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4],
    [91, 90, 90, 90, 88, 87, 86, 84, 83, 81, 79, 77, 73, 71, 69, 65,
     62, 59, 56, 52, 48, 44, 41, 37, 33, 28, 24, 20, 15, 11, 7, 2],
]

MAX_LOG2_TR_DYN_RANGE = 15
COEFF_MIN = -(1 << MAX_LOG2_TR_DYN_RANGE)
COEFF_MAX = (1 << MAX_LOG2_TR_DYN_RANGE) - 1

# transform types (vvenc TrafoType order: TypeDef.h DCT2/DCT8/DST7)
DCT2, DCT8, DST7 = 0, 1, 2

# tuned base values sin(pi*m/(2N+1)) of the DST-7/DCT-8 family
# (H.266 8.7.4.1 tables; m = 1..N)
_DST7_BASE = {
    4: [29, 55, 74, 84],
    8: [17, 32, 46, 60, 71, 78, 85, 86],
    16: [8, 17, 25, 33, 40, 48, 55, 62, 68, 73, 77, 81, 85, 87, 88, 88],
    32: [4, 9, 13, 17, 21, 26, 30, 34, 38, 42, 46, 50, 53, 56, 60, 63,
         66, 68, 72, 74, 77, 78, 80, 82, 84, 85, 86, 87, 88, 89, 90, 90],
}


def _sin_lookup(m: int, n2p1: int, base) -> int:
    """sign * base[|m'|] for sin(pi*m/(2N+1)) via symmetry reduction."""
    m %= 2 * n2p1
    sign = 1
    if m >= n2p1:
        sign, m = -1, m - n2p1
    if m > (n2p1 - 1) // 2:
        m = n2p1 - m
    return sign * (base[m - 1] if m else 0)


@lru_cache(maxsize=None)
def dst7_matrix(n: int) -> np.ndarray:
    """N-point DST-7: T[k][n] ~ sin(pi*(2k+1)*(n+1)/(2N+1))."""
    base = _DST7_BASE[n]
    n2p1 = 2 * n + 1
    t = np.zeros((n, n), dtype=np.int32)
    for k in range(n):
        for j in range(n):
            t[k, j] = _sin_lookup((2 * k + 1) * (j + 1), n2p1, base)
    return t


@lru_cache(maxsize=None)
def dct8_matrix(n: int) -> np.ndarray:
    """N-point DCT-8: T[k][n] ~ cos(pi*(2k+1)*(2n+1)/(4N+2)) =
    sin(pi*(2N+1 - (2k+1)(2n+1)%...)/(2N+1)) over the same base values."""
    base = _DST7_BASE[n]
    n2p1 = 2 * n + 1
    t = np.zeros((n, n), dtype=np.int32)
    for k in range(n):
        for j in range(n):
            # cos(pi*q/(2*(2N+1))) with q odd == sin(pi*(2N+1-q)/(2*(2N+1)))
            # == sin(pi*((2N+1-q)/2)/(2N+1)); (2N+1-q) is even
            q = (2 * k + 1) * (2 * j + 1)
            q %= 4 * n2p1
            sign = 1
            if q > 2 * n2p1:      # cos period/sign fold
                q = 4 * n2p1 - q
            if q > n2p1:
                sign, q = -1, 2 * n2p1 - q
            t[k, j] = sign * _sin_lookup((n2p1 - q) // 2, n2p1, base)
    return t


def tr_matrix(n: int, tr_type: int) -> np.ndarray:
    if tr_type == DST7:
        return dst7_matrix(n)
    if tr_type == DCT8:
        return dct8_matrix(n)
    return dct2_matrix(n)


@lru_cache(maxsize=None)
def _tr_matrix_i64(n: int, tr_type: int) -> np.ndarray:
    return tr_matrix(n, tr_type).astype(np.int64)


@lru_cache(maxsize=None)
def _tr_matrix_i64_t(n: int, tr_type: int) -> np.ndarray:
    return np.ascontiguousarray(tr_matrix(n, tr_type).astype(np.int64).T)


def mts_tr_types(mts_idx: int):
    """(trTypeHor, trTypeVer) for explicit MTS (tu_mts_idx 0..4)."""
    return ((DCT2, DCT2), (DST7, DST7), (DCT8, DST7),
            (DST7, DCT8), (DCT8, DCT8))[mts_idx]


def isp_tr_types(w: int, h: int, lfnst_idx: int, sps_mts: bool):
    """ISP implicit transform selection (TrQuant::xSetTrTypes:417-433):
    DST7 per dimension in [4,16]; DCT2 with LFNST or sps_mts off."""
    if not sps_mts or lfnst_idx:
        return DCT2, DCT2
    return (DST7 if 4 <= w <= 16 else DCT2,
            DST7 if 4 <= h <= 16 else DCT2)


def implicit_mts_types(w: int, h: int, is_intra_luma: bool,
                       implicit_mts: bool):
    """(trTypeHor, trTypeVer) for implicit MTS (vvenc
    TrQuant::xSetTrTypes, TrQuant.cpp:417): intra luma TBs with
    4 <= dim <= 16 use DST-7 in that dimension."""
    th = tv = DCT2
    if implicit_mts and is_intra_luma:
        if 4 <= w <= 16:
            th = DST7
        if 4 <= h <= 16:
            tv = DST7
    return th, tv

# g_quantScales / g_invQuantScales (H.266 8.7.3 levelScale; row 1 = sqrt2 adj)
QUANT_SCALES = np.array([
    [26214, 23302, 20560, 18396, 16384, 14564],
    [18396, 16384, 14564, 13107, 11651, 10280]], dtype=np.int64)
INV_QUANT_SCALES = np.array([
    [40, 45, 51, 57, 64, 72],
    [57, 64, 72, 80, 90, 102]], dtype=np.int64)


@lru_cache(maxsize=None)
def dct2_matrix(n: int) -> np.ndarray:
    """N-point DCT-2 integer matrix (rows = basis vectors), H.266 8.7.4.1."""
    if n == 2:
        a = _DCT2_BASE[0][0]
        return np.array([[a, a], [a, -a]], dtype=np.int32)
    half = dct2_matrix(n // 2)
    t = np.zeros((n, n), dtype=np.int32)
    # even rows: symmetric embedding of the N/2-point matrix
    t[0::2, : n // 2] = half
    t[0::2, n // 2:] = half[:, ::-1]
    # odd rows: cosine index mapping into this size's defining values
    vals = _DCT2_BASE[n.bit_length() - 2]
    for j in range(n // 2):
        for col in range(n):
            tt = ((2 * j + 1) * (2 * col + 1)) % (4 * n)
            if tt > 2 * n:
                tt = 4 * n - tt
            sign = 1 if tt < n else -1
            tp = tt if tt < n else 2 * n - tt
            t[2 * j + 1, col] = sign * vals[(tp - 1) // 2]
    return t


# ---------------------------------------------------------------------------
# numpy golden model (spec semantics, used by the subset decoder)
# ---------------------------------------------------------------------------

def _native_tr(w: int, h: int, tr_hor: int, tr_ver: int) -> bool:
    """True when the native transform kernels cover this block (2-D, all
    registered matrix sizes: DCT2 2..64, DST7/DCT8 4..32)."""
    from .. import native
    if not native.available():
        return False
    ok_h = (2 <= w <= 64) if tr_hor == DCT2 else (4 <= w <= 32)
    ok_v = (2 <= h <= 64) if tr_ver == DCT2 else (4 <= h <= 32)
    return ok_h and ok_v


def fwd_transform_np(resi: np.ndarray, bit_depth: int = 10,
                     tr_hor: int = DCT2, tr_ver: int = DCT2) -> np.ndarray:
    """Forward 2-D primary transform of one block [H, W] -> coeffs [H, W].
    Width/height 1 -> single 1-D pass (vvenc TrQuant::xT:551-563)."""
    h, w = resi.shape
    log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
    if w == 1 or h == 1:
        n, tr = (h, tr_ver) if w == 1 else (w, tr_hor)
        shift = (n.bit_length() - 1) + bit_depth + 6 - MAX_LOG2_TR_DYN_RANGE
        t = _tr_matrix_i64(n, tr)
        vec = resi.reshape(n).astype(np.int64)
        out = (t @ vec + (1 << (shift - 1))) >> shift
        out = np.clip(out, COEFF_MIN, COEFF_MAX).astype(np.int32)
        z = 16 if (tr != DCT2 and n == 32) else 32
        if n > z:
            out[z:] = 0
        return out.reshape(resi.shape)
    if _native_tr(w, h, tr_hor, tr_ver):
        from .. import native
        return native.fwd_transform(resi, bit_depth, tr_hor, tr_ver)
    shift1 = log2w + bit_depth + 6 - MAX_LOG2_TR_DYN_RANGE
    shift2 = log2h + 6
    twt = _tr_matrix_i64_t(w, tr_hor)
    th = _tr_matrix_i64(h, tr_ver)
    # horizontal stage: rows of resi against T_w^T
    tmp = (resi.astype(np.int64) @ twt + (1 << (shift1 - 1))) >> shift1
    tmp = np.clip(tmp, COEFF_MIN, COEFF_MAX)
    out = (th @ tmp + (1 << (shift2 - 1))) >> shift2
    out = np.clip(out, COEFF_MIN, COEFF_MAX).astype(np.int32)
    # zero-out: 64-point DCT2 keeps 32 low-freq lines, 32-point DST7/DCT8
    # keep 16 (vvenc TrafoCore reduced-line transforms)
    zw = 16 if (tr_hor != DCT2 and w == 32) else 32
    zh = 16 if (tr_ver != DCT2 and h == 32) else 32
    if w > zw:
        out[:, zw:] = 0
    if h > zh:
        out[zh:, :] = 0
    return out


def inv_transform_np(coeff: np.ndarray, bit_depth: int = 10,
                     tr_hor: int = DCT2, tr_ver: int = DCT2) -> np.ndarray:
    """Inverse 2-D primary transform (H.266 8.7.4): [H, W] -> residual.
    Width/height 1 -> single 1-D pass with shift 21-bd (xIT:615-627)."""
    h, w = coeff.shape
    if w == 1 or h == 1:
        n, tr = (h, tr_ver) if w == 1 else (w, tr_hor)
        shift = 21 - bit_depth
        t = _tr_matrix_i64(n, tr)
        vec = coeff.reshape(n).astype(np.int64)
        out = (t.T @ vec + (1 << (shift - 1))) >> shift
        return np.clip(out, COEFF_MIN, COEFF_MAX).astype(
            np.int32).reshape(coeff.shape)
    if _native_tr(w, h, tr_hor, tr_ver):
        from .. import native
        return native.inv_transform(coeff, bit_depth, tr_hor, tr_ver)
    shift1 = 7
    shift2 = 20 - bit_depth
    tw = _tr_matrix_i64(w, tr_hor)
    tht = _tr_matrix_i64_t(h, tr_ver)
    # vertical stage first (columns), then horizontal
    tmp = (tht @ coeff.astype(np.int64) + (1 << (shift1 - 1))) >> shift1
    tmp = np.clip(tmp, COEFF_MIN, COEFF_MAX)
    out = (tmp @ tw + (1 << (shift2 - 1))) >> shift2
    return np.clip(out, COEFF_MIN, COEFF_MAX).astype(np.int32)


def transform_shift(w: int, h: int, bit_depth: int) -> int:
    return MAX_LOG2_TR_DYN_RANGE - bit_depth - \
        ((w.bit_length() - 1 + h.bit_length() - 1) >> 1)


def needs_sqrt2(w: int, h: int) -> bool:
    return (((w * h).bit_length() - 1) & 1) == 1


def quant_np(coeff: np.ndarray, qp: int, bit_depth: int = 10,
             is_intra_slice: bool = True, thr_val: int = 8) -> np.ndarray:
    """Scalar quantization (vvenc Quant::xQuant deadzone convention) with
    the trailing-subblock threshold (QuantCore, Quant.cpp:132: zero 4x4
    coefficient groups from the scan tail while every coefficient in the
    group is <= thres; thr_val<=0 disables)."""
    h, w = coeff.shape
    sqrt2 = needs_sqrt2(w, h)
    tshift = transform_shift(w, h, bit_depth) + (-1 if sqrt2 else 0)
    qbits = 14 + qp // 6 + tshift
    scale = int(QUANT_SCALES[1 if sqrt2 else 0][qp % 6])
    add = (171 if is_intra_slice else 85) << (qbits - 9)
    coeff = coeff.astype(np.int64)
    if thr_val > 0 and w >= 8 and h >= 8:
        from ..bitstream.residual import scan_info
        sx, sy, blkpos, cg_pos, lcw, lch = scan_info(
            w.bit_length() - 1, h.bit_length() - 1)
        if lcw == 2 and lch == 2:
            use_thres = (thr_val << (qbits - 1)) // (scale << 2) if qbits \
                else ((thr_val >> 1) << qbits) // (scale << 2)
            flat = np.abs(coeff.reshape(-1))
            cg_max = flat[blkpos].reshape(-1, 16).max(axis=1)
            keep = len(cg_max)
            while keep > 1 and cg_max[keep - 1] <= use_thres:
                keep -= 1
            if keep < len(cg_max):
                mask = np.zeros(w * h, dtype=bool)
                mask[blkpos[keep * 16:]] = True
                coeff = coeff.copy()
                coeff.reshape(-1)[mask] = 0
    mag = (np.abs(coeff) * scale + add) >> qbits
    return np.clip(np.sign(coeff) * mag, COEFF_MIN, COEFF_MAX).astype(np.int32)


def dequant_np(qcoeff: np.ndarray, qp: int, bit_depth: int = 10) -> np.ndarray:
    """Spec dequantization (H.266 8.7.3, flat scaling list)."""
    h, w = qcoeff.shape
    if w > 1 and h > 1:
        from .. import native
        if native.available():
            return native.dequant(qcoeff, qp, bit_depth)
    sqrt2 = needs_sqrt2(w, h)
    tshift = transform_shift(w, h, bit_depth) + (-1 if sqrt2 else 0)
    right_shift = 6 - (tshift + qp // 6)
    scale = int(INV_QUANT_SCALES[1 if sqrt2 else 0][qp % 6])
    q = np.clip(qcoeff.astype(np.int64), -(1 << 15), (1 << 15) - 1)
    if right_shift > 0:
        add = 1 << (right_shift - 1)
        d = (q * scale + add) >> right_shift
    else:
        d = (q * scale) << (-right_shift)
    return np.clip(d, COEFF_MIN, COEFF_MAX).astype(np.int32)


def dequant_ts_np(qcoeff: np.ndarray, qp: int, min_qp_prime_ts: int = 16
                  ) -> np.ndarray:
    """Transform-skip dequant (Quant::dequant with isTransformSkip:
    no transform shift, no sqrt2, QP floored at QpPrimeTsMin =
    4 + 6*internalMinusInputBitDepth, Quant.cpp:119-125,560)."""
    q_ts = max(qp, min_qp_prime_ts)
    right_shift = 6 - q_ts // 6
    scale = int(INV_QUANT_SCALES[0][q_ts % 6])
    q = np.clip(qcoeff.astype(np.int64), -(1 << 15), (1 << 15) - 1)
    if right_shift > 0:
        add = 1 << (right_shift - 1)
        d = (q * scale + add) >> right_shift
    else:
        d = (q * scale) << (-right_shift)
    return np.clip(d, COEFF_MIN, COEFF_MAX).astype(np.int32)


def sdh_adjust(qcoeff: np.ndarray, tcoef: np.ndarray, qp: int,
               bit_depth: int = 10) -> np.ndarray:
    """Sign-data-hiding parity fixup (vvenc Quant::xSignBitHidingHDQ):
    for each CG whose nonzero span reaches SBH_THRESHOLD, make the
    abs-level parity match the sign of the lowest-scan nonzero by a +-1
    adjustment at the position of least quantization-error increase."""
    from ..bitstream.residual import scan_info, SBH_THRESHOLD
    h, w = qcoeff.shape
    out = qcoeff.astype(np.int64).copy()
    sx, sy, blkpos, cg_pos, lcw, lch = scan_info(
        w.bit_length() - 1, h.bit_length() - 1)
    cg_size = 1 << (lcw + lch)
    n = len(blkpos)
    sqrt2 = needs_sqrt2(w, h)
    tshift = transform_shift(w, h, bit_depth) + (-1 if sqrt2 else 0)
    qbits = 14 + qp // 6 + tshift
    scale = int(QUANT_SCALES[1 if sqrt2 else 0][qp % 6])
    tflat = tcoef.astype(np.int64).reshape(-1)
    qflat = out.reshape(-1)
    for cg0 in range(0, n, cg_size):
        pos = [sp for sp in range(cg0, cg0 + cg_size)
               if qflat[blkpos[sp]] != 0]
        if not pos:
            continue
        first_nz, last_nz = pos[0], pos[-1]
        if last_nz - first_nz < SBH_THRESHOLD:
            continue
        parity = int(sum(abs(int(qflat[blkpos[sp]])) for sp in pos)) & 1
        want = 1 if qflat[blkpos[first_nz]] < 0 else 0
        if parity == want:
            continue
        # candidate adjustments that cannot change first/last nz position
        best = None
        for sp in range(cg0, cg0 + cg_size):
            blk = int(blkpos[sp])
            q = int(qflat[blk])
            ld = abs(int(tflat[blk])) * scale
            for dq in (+1, -1):
                if q == 0:
                    if dq < 0 or not (first_nz < sp < last_nz):
                        continue
                    nq = 1 if tflat[blk] >= 0 else -1
                elif dq < 0:
                    if abs(q) == 1 and sp in (first_nz, last_nz):
                        continue
                    nq = q - 1 if q > 0 else q + 1
                else:
                    nq = q + 1 if q > 0 else q - 1
                err0 = abs(ld - (abs(q) << qbits))
                err1 = abs(ld - (abs(nq) << qbits))
                inc = err1 - err0
                if best is None or inc < best[0]:
                    best = (inc, blk, nq)
        if best is not None:
            qflat[best[1]] = best[2]
    return np.clip(out, COEFF_MIN, COEFF_MAX).astype(np.int32)


def quant_ts_np(resi: np.ndarray, qp: int, min_qp_prime_ts: int = 16,
                is_intra_slice: bool = True) -> np.ndarray:
    """Transform-skip forward quantization: the spatial residual is
    quantized directly (no transform shift, no sqrt2, QP floored at
    QpPrimeTsMin) with the same deadzone as Quant::xQuant."""
    q_ts = max(qp, min_qp_prime_ts)
    qbits = 14 + q_ts // 6
    scale = int(QUANT_SCALES[0][q_ts % 6])
    add = (171 if is_intra_slice else 85) << (qbits - 9)
    r = resi.astype(np.int64)
    mag = (np.abs(r) * scale + add) >> qbits
    return np.clip(np.sign(r) * mag, COEFF_MIN, COEFF_MAX).astype(np.int32)


def fwd_res_dpcm(levels: np.ndarray, mode: int) -> np.ndarray:
    """BDPCM forward residual DPCM on quantized levels (differences along
    the prediction direction; exact inverse of inv_res_dpcm)."""
    out = levels.astype(np.int64).copy()
    if mode == 1:
        out[:, 1:] = out[:, 1:] - levels.astype(np.int64)[:, :-1]
    else:
        out[1:, :] = out[1:, :] - levels.astype(np.int64)[:-1, :]
    return np.clip(out, COEFF_MIN, COEFF_MAX).astype(np.int32)


def inv_res_dpcm(coeff: np.ndarray, mode: int) -> np.ndarray:
    """BDPCM inverse residual DPCM on quantized levels
    (Quant.cpp invResDPCM:298): mode 1 horizontal, 2 vertical."""
    out = coeff.astype(np.int64).copy()
    if mode == 1:
        for x in range(1, out.shape[1]):
            out[:, x] = np.clip(out[:, x - 1] + out[:, x],
                                COEFF_MIN, COEFF_MAX)
    else:
        for y in range(1, out.shape[0]):
            out[y] = np.clip(out[y - 1] + out[y], COEFF_MIN, COEFF_MAX)
    return out.astype(np.int32)


def dequant_dq_np(qcoeff: np.ndarray, qp: int,
                  bit_depth: int = 10) -> np.ndarray:
    """Dependent-quantization dequant (vvenc DepQuant.cpp:574 dequantBlock).

    Dispatches to the native kernel when loaded; `_dequant_dq_py` is the
    golden model (tests/test_native.py fuzzes native vs python)."""
    from .. import native
    if native.available():
        return native.dequant_dq(qcoeff, qp, bit_depth)
    return _dequant_dq_py(qcoeff, qp, bit_depth)


def _dequant_dq_py(qcoeff: np.ndarray, qp: int,
                   bit_depth: int = 10) -> np.ndarray:
    """Pure-python DQ dequant: walks the grouped-4x4 scan from the highest
    coded position down to DC, tracking the 4-state machine;
    reconstruction index is 2*level - sign(level)*(state>>1), quantizer
    runs at QP+1."""
    from ..bitstream.residual import scan_info, _next_state
    h, w = qcoeff.shape
    sqrt2 = needs_sqrt2(w, h)
    tshift = transform_shift(w, h, bit_depth) + (-1 if sqrt2 else 0)
    qp_dq = qp + 1
    shift = 6 + 1 - qp_dq // 6 - tshift
    scale = int(INV_QUANT_SCALES[1 if sqrt2 else 0][qp_dq % 6])
    if shift < 0:
        scale <<= -shift
        add, rs = 0, 0
    else:
        add, rs = (1 << shift) >> 1, shift
    blkpos = scan_info(w.bit_length() - 1, h.bit_length() - 1)[2]
    flat = qcoeff.reshape(-1)
    out = np.zeros(w * h, dtype=np.int64)
    state = 0
    for sp in range(len(blkpos) - 1, -1, -1):
        pos = int(blkpos[sp])
        level = int(flat[pos])
        if level:
            q_idx = 2 * level + (-(state >> 1) if level > 0 else (state >> 1))
            out[pos] = (q_idx * scale + add) >> rs
        state = _next_state(state, level)
    return np.clip(out, COEFF_MIN, COEFF_MAX).astype(np.int32).reshape(h, w)


# ---------------------------------------------------------------------------
# batched path: [B, h, w] int32 on a torch device (K6, K7)
# ---------------------------------------------------------------------------

def _clip_coeff(x):
    return torch.clamp(x, COEFF_MIN, COEFF_MAX)


def _fwd_tr_ref(resi, w, h, trh, trv, bit_depth):
    """Forward transform with per-axis type (DCT2/DST7) [B, h, w], int32;
    products as multiply-and-sum over the contraction index."""
    dev = resi.device
    shift1 = (w.bit_length() - 1) + bit_depth + 6 - 15
    shift2 = (h.bit_length() - 1) + 6
    tw = torch.from_numpy(tr_matrix(w, trh).astype(np.int32)).to(dev)
    th = torch.from_numpy(tr_matrix(h, trv).astype(np.int32)).to(dev)
    # tmp[b, y, u] = sum_x resi[b, y, x] * tw[u, x]
    tmp = sum(resi[:, :, x, None] * tw[None, None, :, x] for x in range(w))
    tmp = _clip_coeff((tmp + (1 << (shift1 - 1))) >> shift1)
    # out[b, v, u] = sum_y th[v, y] * tmp[b, y, u]
    out = sum(th[None, :, y, None] * tmp[:, None, y, :] for y in range(h))
    out = _clip_coeff((out + (1 << (shift2 - 1))) >> shift2)
    if w > 32 or h > 32:
        yy = torch.arange(h, device=dev)[:, None]
        xx = torch.arange(w, device=dev)[None, :]
        out = torch.where((xx < 32) & (yy < 32), out, 0)
    return out


def _inv_tr_ref(coeff, w, h, trh, trv, bit_depth):
    dev = coeff.device
    shift1, shift2 = 7, 20 - bit_depth
    tw = torch.from_numpy(tr_matrix(w, trh).astype(np.int32)).to(dev)
    th = torch.from_numpy(tr_matrix(h, trv).astype(np.int32)).to(dev)
    # tmp[b, y, u] = sum_v th[v, y] * coeff[b, v, u]
    tmp = sum(th[None, v, :, None] * coeff[:, None, v, :] for v in range(h))
    tmp = _clip_coeff((tmp + (1 << (shift1 - 1))) >> shift1)
    # out[b, y, x] = sum_u tmp[b, y, u] * tw[u, x]
    out = sum(tmp[:, :, u, None] * tw[None, None, u, :] for u in range(w))
    return _clip_coeff((out + (1 << (shift2 - 1))) >> shift2)


def fwd_transform_batch_ref(resi: torch.Tensor, w: int, h: int,
                            bit_depth: int = 10) -> torch.Tensor:
    """Plain PyTorch version of fwd_transform_batch."""
    return _fwd_tr_ref(resi, w, h, DCT2, DCT2, bit_depth)


def inv_transform_batch_ref(coeff: torch.Tensor, w: int, h: int,
                            bit_depth: int = 10) -> torch.Tensor:
    """Plain PyTorch version of inv_transform_batch."""
    return _inv_tr_ref(coeff, w, h, DCT2, DCT2, bit_depth)


def _quant_shift(w: int, h: int, bit_depth: int):
    """(sqrt2 row, transform shift with its sqrt(2) adjustment)."""
    sqrt2 = needs_sqrt2(w, h)
    return int(sqrt2), transform_shift(w, h, bit_depth) - int(sqrt2)


def _quant_params(w, h, qp, bit_depth, is_intra_slice):
    """(scale, add, qbits) of quant_batch."""
    row, tshift = _quant_shift(w, h, bit_depth)
    qbits = 14 + qp // 6 + tshift
    return (int(QUANT_SCALES[row][qp % 6]),
            (171 if is_intra_slice else 85) << (qbits - 9), qbits)


def _dequant_params(w, h, qp, bit_depth):
    """(scale, right shift) of dequant_batch."""
    row, tshift = _quant_shift(w, h, bit_depth)
    return int(INV_QUANT_SCALES[row][qp % 6]), 6 - (tshift + qp // 6)


def quant_batch_ref(coeff: torch.Tensor, w: int, h: int, qp: int,
                    bit_depth: int = 10,
                    is_intra_slice: bool = True) -> torch.Tensor:
    """Plain PyTorch version of quant_batch (int32, no clip of the
    levels, as the reference)."""
    scale, add, qbits = _quant_params(w, h, qp, bit_depth, is_intra_slice)
    return torch.sign(coeff) * ((coeff.abs() * scale + add) >> qbits)


def dequant_batch_ref(qcoeff: torch.Tensor, w: int, h: int, qp: int,
                      bit_depth: int = 10) -> torch.Tensor:
    """Plain PyTorch version of dequant_batch."""
    scale, rs = _dequant_params(w, h, qp, bit_depth)
    q = torch.clamp(qcoeff, -(1 << 15), (1 << 15) - 1)
    if rs > 0:
        d = (q * scale + (1 << (rs - 1))) >> rs
    else:
        d = (q * scale) << (-rs)
    return _clip_coeff(d)


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_K6_FWD_ARGS = [_P, _P, _L, _I, _I, _I, _I, _P, _P, _P]
_K6_INV_ARGS = [_P, _P, _L, _I, _I, _I, _P, _P, _P]


def _require_blocks(x: torch.Tensor, w: int, h: int, name: str):
    """x's device after checking that it is a CUDA [B, h, w] int32
    contiguous tensor and that (w, h) is a DCT-2 size the kernels take."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for {dev}")
    kernels.require(x, name, torch.int32, 3, dev)
    if tuple(x.shape[1:]) != (h, w):
        raise ValueError(f"{name}: {tuple(x.shape)} is not [B, {h}, {w}]")
    if not (w in (4, 8, 16, 32, 64) and h in (4, 8, 16, 32, 64)):
        raise ValueError(f"{name}: block {w}x{h}: sides must be 4..64")
    return dev


def k6_launch(x: torch.Tensor, out: torch.Tensor, w: int, h: int,
              bit_depth: int, inverse: bool) -> tuple:
    """(C symbol, argument types, arguments) of K6's forward (or inverse)
    entry on x [B, h, w] into out, as fwd/inv_transform_batch launch it;
    raises if the bit depth gives a shift below 1."""
    from .tables import device_tables
    if inverse:
        shift2 = 20 - bit_depth
        if shift2 < 1:
            raise ValueError(f"inv_transform_batch: bit depth {bit_depth}")
        t = device_tables(w, h, x.device)
        return ("vt_inv_transform_batch", _K6_INV_ARGS,
                (x.data_ptr(), out.data_ptr(), x.shape[0], w, h, shift2,
                 t["tr"][(h, DCT2)].data_ptr(), t["tr"][(w, DCT2)].data_ptr(),
                 kernels.stream_ptr(out)))
    shift1 = (w.bit_length() - 1) + bit_depth + 6 - MAX_LOG2_TR_DYN_RANGE
    shift2 = (h.bit_length() - 1) + 6
    if shift1 < 1:
        raise ValueError(f"fwd_transform_batch: bit depth {bit_depth} "
                         f"gives a first-stage shift of {shift1}")
    t = device_tables(w, h, x.device)
    return ("vt_fwd_transform_batch", _K6_FWD_ARGS,
            (x.data_ptr(), out.data_ptr(), x.shape[0], w, h, shift1, shift2,
             t["trT"][(w, DCT2)].data_ptr(), t["tr"][(h, DCT2)].data_ptr(),
             kernels.stream_ptr(out)))


def _k6(x: torch.Tensor, w: int, h: int, bit_depth: int,
        inverse: bool) -> torch.Tensor:
    name = "inv_transform_batch" if inverse else "fwd_transform_batch"
    _require_blocks(x, w, h, name)
    out = torch.empty_like(x)
    symbol, argtypes, args = k6_launch(x, out, w, h, bit_depth, inverse)
    if x.shape[0] == 0:
        return out
    fn = kernels.function("transform_batch", symbol, argtypes)
    kernels.check("transform_batch", fn(*args))
    kernels.count(name)
    return out


def fwd_transform_batch(resi: torch.Tensor, w: int, h: int,
                        bit_depth: int = 10) -> torch.Tensor:
    """Forward DCT-2 of a batch of blocks [B, h, w] int32 -> [B, h, w]
    int32: rounding shift and clip after each stage, 64-point zero-out.
    K6 on a CUDA device, the plain version on the CPU."""
    if resi.device.type == "cpu":
        return fwd_transform_batch_ref(resi, w, h, bit_depth)
    return _k6(resi, w, h, bit_depth, False)


def inv_transform_batch(coeff: torch.Tensor, w: int, h: int,
                        bit_depth: int = 10) -> torch.Tensor:
    """Inverse DCT-2 of a batch of blocks [B, h, w] int32 -> [B, h, w]
    int32.  K6 on a CUDA device, the plain version on the CPU."""
    if coeff.device.type == "cpu":
        return inv_transform_batch_ref(coeff, w, h, bit_depth)
    return _k6(coeff, w, h, bit_depth, True)


def quant_batch(coeff: torch.Tensor, w: int, h: int, qp: int,
                bit_depth: int = 10,
                is_intra_slice: bool = True) -> torch.Tensor:
    """Scalar quantisation of a batch [B, h, w] int32 -> levels [B, h, w]
    int32 (deadzone 171/512 on intra slices, 85/512 otherwise).  K7 on a
    CUDA device, the plain version on the CPU."""
    if coeff.device.type == "cpu":
        return quant_batch_ref(coeff, w, h, qp, bit_depth, is_intra_slice)
    _require_blocks(coeff, w, h, "quant_batch")
    scale, add, qbits = _quant_params(w, h, qp, bit_depth, is_intra_slice)
    out = torch.empty_like(coeff)
    if coeff.numel() == 0:
        return out
    fn = kernels.function("quant_batch", "vt_quant_batch",
                          [_P, _P, _L, _I, _I, _I, _P])
    err = fn(coeff.data_ptr(), out.data_ptr(), coeff.numel(), scale, add,
             qbits, kernels.stream_ptr(out))
    kernels.check("quant_batch", err)
    kernels.count("quant_batch")
    return out


def dequant_batch(qcoeff: torch.Tensor, w: int, h: int, qp: int,
                  bit_depth: int = 10) -> torch.Tensor:
    """Scalar dequantisation of a batch of levels [B, h, w] int32 ->
    [B, h, w] int32.  K7 on a CUDA device, the plain version on the
    CPU."""
    if qcoeff.device.type == "cpu":
        return dequant_batch_ref(qcoeff, w, h, qp, bit_depth)
    _require_blocks(qcoeff, w, h, "dequant_batch")
    scale, rs = _dequant_params(w, h, qp, bit_depth)
    out = torch.empty_like(qcoeff)
    if qcoeff.numel() == 0:
        return out
    fn = kernels.function("quant_batch", "vt_dequant_batch",
                          [_P, _P, _L, _I, _I, _P])
    err = fn(qcoeff.data_ptr(), out.data_ptr(), qcoeff.numel(), scale, rs,
             kernels.stream_ptr(out))
    kernels.check("quant_batch", err)
    kernels.count("dequant_batch")
    return out

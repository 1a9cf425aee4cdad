"""VVC intra prediction — numpy golden model (spec semantics).

Implements ITU-T H.266 8.4.5.2: reference sample filtering (MDIS), planar,
DC, the 65 angular modes with wide-angle mapping, 4-tap luma interpolation
(cubic DCT-IF / smoothing), 2-tap chroma interpolation, and PDPC.

Behavioral reference: vvenc CommonLib/IntraPrediction.cpp
(xPredIntraPlanar_Core:79, xGetPredValDc:302, initPredIntraParams:409,
xPredIntraAng:518, xFilterReferenceSamples:994, PDPC kernels :137-189).

Reference sample layout used here:
  top[0]  = reconstructed sample at (-1, -1)  (corner)
  top[k]  = sample at (x + k - 1, y - 1), k = 1 .. 2W (+padding)
  left[0] = corner, left[k] = sample at (x - 1, y + k - 1), k = 1 .. 2H

The batched device path lives in intra_presel.py; this module is the
bit-exact scalar model used by the subset decoder and as the test oracle.
"""

from __future__ import annotations

import numpy as np

PLANAR_IDX = 0
DC_IDX = 1
HOR_IDX = 18
DIA_IDX = 34
VER_IDX = 50
VDIA_IDX = 66
NUM_LUMA_MODE = 67

# intraPredAngle / invAngle tables (H.266 Table 27 / 8.4.5.2.12)
ANG_TABLE = np.array([0, 1, 2, 3, 4, 6, 8, 10, 12, 14, 16, 18, 20, 23, 26,
                      29, 32, 35, 39, 45, 51, 57, 64, 73, 86, 102, 128, 171,
                      256, 341, 512, 1024], dtype=np.int32)
INV_ANG_TABLE = np.array([0, 16384, 8192, 5461, 4096, 2731, 2048, 1638, 1365,
                          1170, 1024, 910, 819, 712, 630, 565, 512, 468, 420,
                          364, 321, 287, 256, 224, 191, 161, 128, 96, 64, 48,
                          32, 16], dtype=np.int32)

# MDIS thresholds indexed by (log2W+log2H)>>1 (vvenc m_aucIntraFilter)
MDIS_THRESH = [24, 24, 24, 14, 2, 0, 0, 0]

# 4-tap chroma/cubic interpolation filter, 32 phases (H.266 Table 33)
CHROMA_FILTER = np.array([
    [0, 64, 0, 0], [-1, 63, 2, 0], [-2, 62, 4, 0], [-2, 60, 7, -1],
    [-2, 58, 10, -2], [-3, 57, 12, -2], [-4, 56, 14, -2], [-4, 55, 15, -2],
    [-4, 54, 16, -2], [-5, 53, 18, -2], [-6, 52, 20, -2], [-6, 49, 24, -3],
    [-6, 46, 28, -4], [-5, 44, 29, -4], [-4, 42, 30, -4], [-4, 39, 33, -4],
    [-4, 36, 36, -4], [-4, 33, 39, -4], [-4, 30, 42, -4], [-4, 29, 44, -5],
    [-4, 28, 46, -6], [-3, 24, 49, -6], [-2, 20, 52, -6], [-2, 18, 53, -5],
    [-2, 16, 54, -4], [-2, 15, 55, -4], [-2, 14, 56, -4], [-2, 12, 57, -3],
    [-2, 10, 58, -2], [-1, 7, 60, -2], [0, 4, 62, -2], [0, 2, 63, -1],
    [0, 0, 64, 0]], dtype=np.int32)


def smoothing_filter(frac: int) -> np.ndarray:
    """Intra Gaussian-like smoothing 4-tap (computed per H.266 8.4.5.2.12)."""
    return np.array([16 - (frac >> 1), 32 - (frac >> 1),
                     16 + (frac >> 1), frac >> 1], dtype=np.int32)


def wide_angle_map(w: int, h: int, mode: int) -> int:
    """Map signalled mode to extended (wide-angle) mode (8.4.5.2.7)."""
    if DC_IDX < mode <= VDIA_IDX:
        mode_shift = [0, 6, 10, 12, 14, 15]
        delta = abs((w.bit_length() - 1) - (h.bit_length() - 1))
        if w > h and mode < 2 + mode_shift[delta]:
            mode += VDIA_IDX - 1
        elif h > w and mode > VDIA_IDX - mode_shift[delta]:
            mode -= VDIA_IDX - 1
    return mode


def is_integer_slope(abs_ang: int) -> bool:
    return (abs_ang & 31) == 0


class IntraParams:
    __slots__ = ("is_ver", "angle", "abs_inv_angle", "ref_filter",
                 "interp", "apply_pdpc", "angular_scale", "pred_mode")


def intra_params(w: int, h: int, mode: int, is_luma: bool = True,
                 ref_idx: int = 0, cu_dims=None, isp: bool = False
                 ) -> IntraParams:
    """Derive prediction parameters (vvenc initPredIntraParams:409).

    ref_idx: multi-reference-line index (MRL); disables PDPC and reference
    smoothing/interpolation-switch (vvenc initPredIntraParams:424,458).
    cu_dims: (cuW, cuH) for ISP — the wide-angle mapping uses the CU shape
    (initPredIntraParams:418 blockSize = useISP ? cuSize : puSize); isp
    additionally disables reference smoothing / interpolation switching."""
    p = IntraParams()
    ww, wh = cu_dims if cu_dims is not None else (w, h)
    pred_mode = wide_angle_map(ww, wh, mode)
    p.pred_mode = pred_mode
    p.is_ver = pred_mode >= DIA_IDX
    p.ref_filter = False
    p.interp = False
    p.apply_pdpc = w >= 4 and h >= 4 and ref_idx == 0
    p.angle = 0
    p.abs_inv_angle = 0
    p.angular_scale = 0
    angle_mode = (pred_mode - VER_IDX) if p.is_ver else -(pred_mode - HOR_IDX)
    abs_ang = 0
    if DC_IDX < mode < NUM_LUMA_MODE:
        abs_ang = int(ANG_TABLE[abs(angle_mode)])
        p.abs_inv_angle = int(INV_ANG_TABLE[abs(angle_mode)])
        p.angle = abs_ang if angle_mode >= 0 else -abs_ang
        if angle_mode < 0:
            p.apply_pdpc = False
        elif angle_mode > 0:
            side = h if p.is_ver else w
            p.angular_scale = min(2, (side.bit_length() - 1) -
                                  ((3 * p.abs_inv_angle - 2).bit_length() - 1 - 8))
            p.apply_pdpc = p.apply_pdpc and p.angular_scale >= 0
    if not is_luma or mode == DC_IDX or ref_idx != 0 or isp:
        pass
    elif mode == PLANAR_IDX:
        p.ref_filter = w * h > 32
    else:
        diff = min(abs(pred_mode - HOR_IDX), abs(pred_mode - VER_IDX))
        log2_size = ((w.bit_length() - 1) + (h.bit_length() - 1)) >> 1
        if diff > MDIS_THRESH[log2_size]:
            if is_integer_slope(abs_ang):
                p.ref_filter = True
            else:
                p.interp = True
    return p


def filter_reference(top: np.ndarray, left: np.ndarray):
    """[1 2 1]/4 reference smoothing (vvenc xFilterReferenceSamples:994).

    The LAST sample of each side (index 2W / 2H) stays unfiltered
    (refBufFiltered[predSize] = refBufUnfiltered[predSize])."""
    ft = top.copy()
    fl = left.copy()
    corner = (int(top[0]) + int(top[1]) + int(left[0]) + int(left[1]) + 2) >> 2
    n = len(top) - 3  # == predSize == 2W (arrays carry +3 padding)
    ft[1:n] = (top[:n - 1].astype(np.int32) + 2 * top[1:n] + top[2:n + 1] + 2) >> 2
    ft[0] = corner
    ft[n:] = top[n]
    m = len(left) - 3
    fl[1:m] = (left[:m - 1].astype(np.int32) + 2 * left[1:m] + left[2:m + 1] + 2) >> 2
    fl[0] = corner
    fl[m:] = left[m]
    return ft, fl


def _pred_planar(top: np.ndarray, left: np.ndarray, w: int, h: int) -> np.ndarray:
    log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
    top_row = top[1:w + 2].astype(np.int32)      # w+1 entries
    left_col = left[1:h + 2].astype(np.int32)    # h+1 entries
    bottom_left = left_col[h]
    top_right = top_row[w]
    x = np.arange(w, dtype=np.int32)
    y = np.arange(h, dtype=np.int32)
    hor = (left_col[:h, None] << log2w) + (x[None, :] + 1) * \
        (top_right - left_col[:h, None])
    ver = (top_row[None, :w] << log2h) + (y[:, None] + 1) * \
        (bottom_left - top_row[None, :w])
    offset = 1 << (log2w + log2h)
    return ((hor << log2h) + (ver << log2w) + offset) >> (1 + log2w + log2h)


def _pred_dc(top: np.ndarray, left: np.ndarray, w: int, h: int,
             ref_idx: int = 0) -> np.ndarray:
    denom = (w << 1) if w == h else max(w, h)
    shift = denom.bit_length() - 1
    off = ref_idx + 1
    s = 0
    if w >= h:
        s += int(top[off:off + w].astype(np.int64).sum())
    if w <= h:
        s += int(left[off:off + h].astype(np.int64).sum())
    dc = (s + (denom >> 1)) >> shift
    return np.full((h, w), dc, dtype=np.int32)


def _pdpc_planar_dc(pred: np.ndarray, top: np.ndarray, left: np.ndarray,
                    w: int, h: int) -> np.ndarray:
    scale = (((w * h).bit_length() - 1) - 2) >> 2
    y = np.arange(h, dtype=np.int32)
    x = np.arange(w, dtype=np.int32)
    wt = (32 >> np.minimum(31, (y << 1) >> scale))[:, None]
    wl = (32 >> np.minimum(31, (x << 1) >> scale))[None, :]
    l = left[1:h + 1].astype(np.int32)[:, None]
    t = top[1:w + 1].astype(np.int32)[None, :]
    return pred + ((wl * (l - pred) + wt * (t - pred) + 32) >> 6)


def predict_intra(top: np.ndarray, left: np.ndarray, mode: int, w: int, h: int,
                  bit_depth: int = 10, is_luma: bool = True,
                  override_pdpc=None, ref_idx: int = 0,
                  cu_dims=None, isp: bool = False) -> np.ndarray:
    """Full intra prediction for one block (dispatches to the bit-exact
    native C++ port when available; _predict_intra_py below is the
    golden model and fallback — tests/test_native.py enforces exact
    equivalence)."""
    from .. import native
    if native.available():
        return native.predict_intra(top, left, mode, w, h, bit_depth,
                                    is_luma, ref_idx, cu_dims, isp,
                                    override_pdpc)
    return _predict_intra_py(top, left, mode, w, h, bit_depth, is_luma,
                             override_pdpc, ref_idx, cu_dims, isp)


def _predict_intra_py(top: np.ndarray, left: np.ndarray, mode: int, w: int,
                      h: int, bit_depth: int = 10, is_luma: bool = True,
                      override_pdpc=None, ref_idx: int = 0,
                      cu_dims=None, isp: bool = False) -> np.ndarray:
    """Full intra prediction for one block. top/left per module docstring,
    each with at least 2*side+ref_idx+3 entries (padded by replication);
    for ref_idx > 0 they must come from build_reference_samples(...,
    ref_idx) (the shifted reference line).
    override_pdpc: force PDPC on/off (None = spec behavior); used by the
    batched search kernel tests which omit PDPC in preselection."""
    top = np.asarray(top, dtype=np.int32)
    left = np.asarray(left, dtype=np.int32)
    maxval = (1 << bit_depth) - 1
    p = intra_params(w, h, mode, is_luma, ref_idx, cu_dims=cu_dims, isp=isp)
    if override_pdpc is not None:
        p.apply_pdpc = override_pdpc
    if p.ref_filter:
        top, left = filter_reference(top, left)
    if mode == PLANAR_IDX:
        assert ref_idx == 0, "planar is excluded with MRL"
        pred = _pred_planar(top, left, w, h)
        if p.apply_pdpc:
            pred = _pdpc_planar_dc(pred, top, left, w, h)
        return np.clip(pred, 0, maxval).astype(np.int32)
    if mode == DC_IDX:
        pred = _pred_dc(top, left, w, h, ref_idx)
        if p.apply_pdpc:
            pred = _pdpc_planar_dc(pred, top, left, w, h)
        return np.clip(pred, 0, maxval).astype(np.int32)
    main_len = None
    if isp and cu_dims is not None:
        # ISP positive-angle main reference spans cuDim + partDim
        # (xPredIntraAng:554 with m_topRefLength = cuW + puW)
        main_len = (cu_dims[0] + w) if p.is_ver else (cu_dims[1] + h)
    return _pred_angular(top, left, p, w, h, maxval, is_luma, ref_idx,
                         main_len=main_len)


def _build_ref_main_side(top, left, p, w, h, m: int = 0, main_len=None):
    """Construct refMain/refSide arrays (vvenc xPredIntraAng:534-585).

    m is the multi-reference-line index; the returned base already includes
    the `refMain += multiRefIdx` shift of the reference code.  Returns
    (ref_main, ref_side, base) where ref_main[base + k] corresponds to
    refMain[k] (k may be negative down to -(side - m))."""
    if p.angle < 0:
        side = h if p.is_ver else w
        main_src = top if p.is_ver else left
        side_src = left if p.is_ver else top
        main_len = (w if p.is_ver else h) + 2 + m
        ref_main = np.zeros(side + main_len + 4, dtype=np.int32)
        base_pre = side
        ref_main[base_pre:base_pre + main_len] = main_src[:main_len]
        for k in range(-side, 0):
            idx = min((-k * p.abs_inv_angle + 256) >> 9, side)
            ref_main[base_pre + k] = side_src[idx]
        base = base_pre + m
        ref_side = side_src[m:]
    else:
        main_src = top if p.is_ver else left
        ref_len = main_len if main_len is not None \
            else 2 * (w if p.is_ver else h)
        log2_ratio = (w.bit_length() - 1) - (h.bit_length() - 1)
        s = max(0, log2_ratio if p.is_ver else -log2_ratio)
        max_index = (m << s) + 2
        rows = h if p.is_ver else w
        need = m + ((rows * max(p.angle, 0)) >> 5) + \
            (w if p.is_ver else h) + 8
        ref_main = np.zeros(max(ref_len + m + max_index + 8, need),
                            dtype=np.int32)
        n = min(len(main_src), ref_len + m + 1)
        ref_main[:n] = main_src[:n]
        ref_main[n:] = main_src[n - 1]  # replicate beyond
        base = m
        side_src = left if p.is_ver else top
        ref_side = side_src[m:]
    return ref_main, ref_side, base


def _pred_angular(top, left, p, w, h, maxval, is_luma, m: int = 0,
                  main_len=None):
    ref_main, ref_side, base = _build_ref_main_side(top, left, p, w, h, m,
                                                    main_len=main_len)
    # work in "vertical" orientation; transpose at the end for horizontal
    tw, th = (w, h) if p.is_ver else (h, w)
    pred = np.zeros((th, tw), dtype=np.int32)
    if p.angle == 0:
        pred[:, :] = ref_main[base + 1: base + 1 + tw][None, :]
        if p.apply_pdpc:
            scale = (((tw * th).bit_length() - 1) - 2) >> 2
            top_left = ref_main[base]
            for y in range(th):
                lval = int(ref_side[1 + y])
                for x in range(min(3 << scale, tw)):
                    wl = 32 >> ((2 * x) >> scale)
                    v = pred[y, x] + ((wl * (lval - top_left) + 32) >> 6)
                    pred[y, x] = min(max(v, 0), maxval)
    else:
        # NB: when the block's angle is a non-integer slope, the 4-tap /
        # 2-tap filter is applied on EVERY row, including rows whose own
        # fraction is 0 (the smoothing filter still smooths there) —
        # vvenc IntraPredAngleLuma_Core:191 has no per-row copy shortcut.
        integer_slope = is_integer_slope(abs(p.angle))
        delta_pos = p.angle * (1 + m)
        for y in range(th):
            delta_int = delta_pos >> 5
            frac = delta_pos & 31
            if integer_slope:
                pred[y, :] = ref_main[base + delta_int + 1:
                                      base + delta_int + 1 + tw]
            elif is_luma:
                f = CHROMA_FILTER[frac] if not p.interp else smoothing_filter(frac)
                idx = base + delta_int + np.arange(tw)
                v = (f[0] * ref_main[idx] + f[1] * ref_main[idx + 1] +
                     f[2] * ref_main[idx + 2] + f[3] * ref_main[idx + 3] + 32) >> 6
                if not p.interp:  # cubic has negative taps -> clip
                    v = np.clip(v, 0, maxval)
                pred[y, :] = v
            else:
                idx = base + delta_int + 1 + np.arange(tw)
                pred[y, :] = ((32 - frac) * ref_main[idx] +
                              frac * ref_main[idx + 1] + 16) >> 5
            delta_pos += p.angle
        if p.apply_pdpc:
            scale = p.angular_scale
            for y in range(th):
                inv_sum = 256
                for x in range(min(3 << scale, tw)):
                    inv_sum += p.abs_inv_angle
                    wl = 32 >> ((2 * x) >> scale)
                    lval = int(ref_side[y + (inv_sum >> 9) + 1])
                    pred[y, x] = pred[y, x] + \
                        ((wl * (lval - pred[y, x]) + 32) >> 6)
    if not p.is_ver:
        pred = pred.T
    return np.clip(pred, 0, maxval).astype(np.int32)


def build_reference_samples(rec: np.ndarray, x: int, y: int, w: int, h: int,
                            coded_mask: np.ndarray, unit: int,
                            bit_depth: int = 10, ref_idx: int = 0,
                            pred_sizes=None, avail_fn=None):
    """Reference sample derivation with availability substitution
    (vvenc xFillReferenceSamples:755).

    rec: full reconstructed plane (so far); coded_mask: bool per `unit`-sized
    cell, True where samples are already reconstructed.  ref_idx (MRL line
    index m) selects the reference line: the corner moves to
    (x-1-m, y-1-m) and the border arrays gain m extra entries.  Returns
    (top, left) arrays of length 2W+m+3 / 2H+m+3:
      top[k]  = sample at (x - 1 - m + k, y - 1 - m)
      left[k] = sample at (x - 1 - m, y - 1 - m + k)
    (padded by replication for 4-tap interpolation access).
    """
    if avail_fn is None:
        from .. import native
        if native.available() and rec.dtype == np.int32 \
                and rec.flags.c_contiguous:
            return native.build_refs(rec, x, y, w, h, coded_mask, unit,
                                     bit_depth, ref_idx, pred_sizes)
    m = ref_idx
    pred_size = (2 * w if pred_sizes is None else pred_sizes[0]) + m
    pred_hsize = (2 * h if pred_sizes is None else pred_sizes[1]) + m
    dc_val = 1 << (bit_depth - 1)
    ph, pw = rec.shape
    x0, y0 = x - 1 - m, y - 1 - m  # corner coordinates

    top = np.full(pred_size + 3, dc_val, dtype=np.int32)
    left = np.full(pred_hsize + 3, dc_val, dtype=np.int32)
    if avail_fn is not None:
        # custom availability (ISP inner partitions): scalar path
        def avail(px, py):
            if px < 0 or py < 0 or px >= pw or py >= ph:
                return False
            return bool(avail_fn(px, py))

        filled_top = np.zeros(pred_size + 1, dtype=bool)
        filled_left = np.zeros(pred_hsize + 1, dtype=bool)
        if avail(x0, y0):
            top[0] = left[0] = rec[y0, x0]
            filled_top[0] = filled_left[0] = True
        for j in range(1, pred_size + 1):
            px, py = x0 + j, y0
            if avail(px, py):
                top[j] = rec[py, px]
                filled_top[j] = True
        for i in range(1, pred_hsize + 1):
            px, py = x0, y0 + i
            if avail(px, py):
                left[i] = rec[py, px]
                filled_left[i] = True
    else:
        # vectorized coded-mask availability
        jx = x0 + np.arange(pred_size + 1)
        if y0 >= 0:
            jc = np.clip(jx, 0, pw - 1)
            filled_top = (jx >= 0) & (jx < pw) & \
                coded_mask[y0 // unit, jc // unit]
            np.copyto(top[:pred_size + 1], rec[y0, jc], where=filled_top)
        else:
            filled_top = np.zeros(pred_size + 1, dtype=bool)
        iy = y0 + np.arange(pred_hsize + 1)
        if x0 >= 0:
            ic = np.clip(iy, 0, ph - 1)
            filled_left = (iy >= 0) & (iy < ph) & \
                coded_mask[ic // unit, x0 // unit]
            np.copyto(left[:pred_hsize + 1], rec[ic, x0], where=filled_left)
        else:
            filled_left = np.zeros(pred_hsize + 1, dtype=bool)
    if filled_top.any() or filled_left.any():
        # substitution (8.4.5.2.2): scan from bottom-left upwards then
        # left-to-right along the top, propagating the previous sample
        seq_filled = np.concatenate([filled_left[1:][::-1], [filled_left[0]],
                                     filled_top[1:]])
        seq_vals = np.concatenate([left[1:1 + pred_hsize][::-1],
                                   [left[0]], top[1:1 + pred_size]])
        first = int(np.argmax(seq_filled))
        # forward-fill: each position takes the value of the nearest filled
        # position at or before it (positions before `first` take `first`)
        idx = np.maximum.accumulate(
            np.where(seq_filled, np.arange(len(seq_vals)), -1))
        idx = np.where(idx < 0, first, idx)
        seq_vals = seq_vals[idx]
        left[1:1 + pred_hsize] = seq_vals[:pred_hsize][::-1]
        left[0] = seq_vals[pred_hsize]
        top[0] = seq_vals[pred_hsize]
        top[1:1 + pred_size] = seq_vals[pred_hsize + 1:]
    # padding for 4-tap access
    top[pred_size + 1:] = top[pred_size]
    left[pred_hsize + 1:] = left[pred_hsize]
    return top, left

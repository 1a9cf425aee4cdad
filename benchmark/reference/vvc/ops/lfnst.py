"""Low-frequency non-separable transform (LFNST), H.266 8.7.4.3.

Secondary transform on the top-left primary (DCT-2) coefficients of intra
blocks: 16 (or 8) coded coefficients map to a 16- or 48-sample low-frequency
region.  Kernel matrices are the normative spec tables (stored in
lfnst_weights.npz; inverse kernels are the forward transposes).

Behavioral reference: vvenc CommonLib/TrQuant.cpp (xFwdLfnst:944,
xInvLfnst:833, xGetLFNSTIntraMode:806, xGetTransposeFlag:831,
xFwdLfnstNxNCore / xInvLfnstNxNCore) and Rom.cpp g_lfnstLut:95.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

NUM_LUMA_MODE = 67
NUM_EXT_LUMA_MODE = 28
DIA_IDX = 34
VDIA_IDX = 66

_W = np.load(os.path.join(os.path.dirname(__file__), "lfnst_weights.npz"))
FWD8 = _W["fwd8"].astype(np.int32)   # [4][2][16][48]
FWD4 = _W["fwd4"].astype(np.int32)   # [4][2][16][16]

# transform-set index per extended intra mode (normative; Rom.cpp:95)
LFNST_LUT = np.array([
    0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 2, 2, 2,
    2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    dtype=np.int32)

MODE_SHIFT = [0, 6, 10, 12, 14, 15]


def lfnst_intra_mode(w: int, h: int, dir_mode: int) -> int:
    """Extended (wide-angle) mode for LFNST set selection
    (vvenc xGetLFNSTIntraMode)."""
    if dir_mode < 2:
        return dir_mode
    lw, lh = w.bit_length() - 1, h.bit_length() - 1
    if w > h and dir_mode < 2 + MODE_SHIFT[lw - lh]:
        return dir_mode + (VDIA_IDX - 1) + (NUM_EXT_LUMA_MODE >> 1)
    if h > w and dir_mode > VDIA_IDX - MODE_SHIFT[lh - lw]:
        return dir_mode - (VDIA_IDX + 1) + (NUM_EXT_LUMA_MODE >> 1) \
            + NUM_LUMA_MODE
    return dir_mode


def transpose_flag(ext_mode: int) -> bool:
    return ((ext_mode >= NUM_LUMA_MODE
             and ext_mode >= NUM_LUMA_MODE + (NUM_EXT_LUMA_MODE >> 1))
            or (ext_mode < NUM_LUMA_MODE and ext_mode > DIA_IDX))


@lru_cache(maxsize=None)
def _region_coords(sb: int, transposed: bool):
    """(ys, xs) of the LFNST sample-vector positions, in vector order
    (mirrors the xFwd/xInvLfnst gather/placement loops)."""
    ys, xs = [], []
    if not transposed:
        for y in range(sb):
            stride = sb if y < 4 else 4
            for x in range(stride):
                ys.append(y)
                xs.append(x)
    elif sb == 4:
        for x in range(4):
            for y in range(4):
                ys.append(y)
                xs.append(x)
    else:
        for x in range(4):
            for y in range(8):
                ys.append(y)
                xs.append(x)
        for x in range(4, 8):
            for y in range(4):
                ys.append(y)
                xs.append(x)
    return np.array(ys), np.array(xs)


@lru_cache(maxsize=None)
def _block_scan(w: int, h: int):
    """(xs, ys) grouped 4x4 diagonal scan of the block (first 48 entries
    cover the LFNST top-left region in the normative order)."""
    from ..bitstream.residual import scan_info
    sx, sy, _, _, _, _ = scan_info(w.bit_length() - 1, h.bit_length() - 1)
    return sx, sy


def _params(w: int, h: int, intra_mode: int, lfnst_idx: int,
            map_dims=None):
    """map_dims: (W, H) used for the wide-angle set mapping when it
    differs from the block dims (ISP uses the CU dims, TrQuant.cpp:866)."""
    mw, mh = map_dims if map_dims is not None else (w, h)
    ext = lfnst_intra_mode(mw, mh, intra_mode)
    tset = int(LFNST_LUT[ext])
    tr = transpose_flag(ext)
    sb = 8 if (w >= 8 and h >= 8) else 4
    nonzero = 8 if ((w == 4 and h == 4) or (w == 8 and h == 8)) else 16
    mat = (FWD8 if sb == 8 else FWD4)[tset][lfnst_idx - 1]  # [16][48|16]
    return tr, sb, nonzero, mat


def fwd_lfnst(coeff: np.ndarray, w: int, h: int, intra_mode: int,
              lfnst_idx: int) -> np.ndarray:
    """Forward LFNST on a primary-coefficient block.  Returns a new block:
    the LFNST region carries the 16 (or 8) secondary coefficients at the
    leading scan positions, the rest of the region is zero.  (Coefficients
    outside the region are untouched; the caller must ensure they are zero
    before choosing lfnst_idx > 0.)"""
    tr, sb, nonzero, mat = _params(w, h, intra_mode, lfnst_idx)
    ys, xs = _region_coords(sb, tr)
    src = coeff[ys, xs].astype(np.int64)
    out_v = (mat.astype(np.int64) @ src + 64) >> 7      # 16 outputs
    out = coeff.copy()
    zy, zx = _region_coords(sb, False)
    out[zy, zx] = 0
    sx, sy = _block_scan(w, h)
    n = min(nonzero, 16)
    out[sy[:n], sx[:n]] = out_v[:n]
    return out


def inv_lfnst(coeff: np.ndarray, w: int, h: int, intra_mode: int,
              lfnst_idx: int, map_dims=None) -> np.ndarray:
    """Inverse LFNST: 16 scan-ordered inputs -> 48/16-sample region."""
    tr, sb, nonzero, mat = _params(w, h, intra_mode, lfnst_idx, map_dims)
    sx, sy = _block_scan(w, h)
    src = coeff[sy[:nonzero], sx[:nonzero]].astype(np.int64)
    out_v = np.clip((mat.T.astype(np.int64)[:, :nonzero] @ src + 64) >> 7,
                    -(1 << 15), (1 << 15) - 1)
    out = coeff.copy()
    zy, zx = _region_coords(sb, False)
    out[zy, zx] = 0
    ys, xs = _region_coords(sb, tr)
    out[ys, xs] = out_v
    return out

"""Matrix-based intra prediction (MIP), H.266 8.4.5.2.2/8.4.5.2.3.

Boundary Haar-downsampling -> small integer matrix multiply (the normative
weight tables, stored in mip_weights.npz) -> bilinear upsampling against the
original boundary samples.

Behavioral reference: vvenc CommonLib/MatrixIntraPrediction.cpp
(prepareInputForPred:87, predBlock:131, boundaryDownsampling1D:233,
predictionUpsampling1DHor/Ver:263-330) and the mipMatrixMulCore kernel
(CommonLib/Buffer.cpp:84).  Weight matrices are the normative tables of the
standard (H.266 Table 22-24 data, mirrored in vvenc CommonLib/MipData.h).

The numpy path is the bit-exact model used by encoder and decoder.
"""

from __future__ import annotations

import os

import numpy as np

MIP_SHIFT_MATRIX = 6
MIP_OFFSET_MATRIX = 32

_W = np.load(os.path.join(os.path.dirname(__file__), "mip_weights.npz"))
MIP_MATRIX = {0: _W["s0"].astype(np.int32),   # [16][16][4]
              1: _W["s1"].astype(np.int32),   # [8][16][8]
              2: _W["s2"].astype(np.int32)}   # [6][64][8]


def mip_size_id(w: int, h: int) -> int:
    """vvenc getMipSizeId (UnitTools.cpp:3665)."""
    if w == 4 and h == 4:
        return 0
    if w == 4 or h == 4 or (w == 8 and h == 8):
        return 1
    return 2


def num_mip_modes(w: int, h: int) -> int:
    return (16, 8, 6)[mip_size_id(w, h)]


def _downsample(full: np.ndarray, dst_len: int) -> np.ndarray:
    src_len = full.shape[0]
    if dst_len >= src_len:
        return full[:dst_len].astype(np.int32)
    f = src_len // dst_len
    lg = f.bit_length() - 1
    s = full[:dst_len * f].reshape(dst_len, f).sum(axis=1)
    return (s + (1 << (lg - 1))) >> lg


def _upsample_1d(red: np.ndarray, before: np.ndarray, factor: int):
    """Linear upsampling along axis 1.  red: (n, m); before: (n,) boundary
    column prepended at position -1.  Returns (n, m*factor)."""
    lg = factor.bit_length() - 1
    prev = np.concatenate([before[:, None], red[:, :-1]], axis=1)  # (n, m)
    diff = red - prev
    # scaledVal starts at (prev << lg) + round, accumulates diff each pos
    pos = np.arange(1, factor + 1, dtype=np.int64)
    vals = ((prev.astype(np.int64) << lg) + (1 << (lg - 1)))[:, :, None] \
        + diff[:, :, None] * pos[None, None, :]
    return (vals >> lg).reshape(red.shape[0], -1).astype(np.int32)


def predict_mip(top: np.ndarray, left: np.ndarray, w: int, h: int,
                mode: int, transposed: bool, bit_depth: int) -> np.ndarray:
    """MIP prediction for one block.

    top: W neighbors directly above (after substitution), left: H neighbors
    directly left — i.e. build_reference_samples()'s top[1:w+1]/left[1:h+1].
    """
    from .. import native
    if native.available():
        return native.predict_mip(top, left, w, h, mode, transposed,
                                  bit_depth)
    return _predict_mip_py(top, left, w, h, mode, transposed, bit_depth)


def _predict_mip_py(top: np.ndarray, left: np.ndarray, w: int, h: int,
                    mode: int, transposed: bool, bit_depth: int) -> np.ndarray:
    """Pure-numpy golden model (the native kernel's bit-exact reference)."""
    size_id = mip_size_id(w, h)
    bdry_size = 2 if size_id == 0 else 4
    red_size = 4 if size_id < 2 else 8
    up_hor = w // red_size
    up_ver = h // red_size

    red_top = _downsample(top, bdry_size)
    red_left = _downsample(left, bdry_size)
    if transposed:
        bdry = np.concatenate([red_left, red_top]).astype(np.int32)
    else:
        bdry = np.concatenate([red_top, red_left]).astype(np.int32)
    input_offset = int(bdry[0])
    p = bdry - input_offset
    if size_id < 2:
        p[0] = (1 << (bit_depth - 1)) - input_offset
    else:
        p[0] = 0

    weights = MIP_MATRIX[size_id][mode]        # (out*out, in)
    s = int(p.sum())
    offset = (1 << (MIP_SHIFT_MATRIX - 1)) - MIP_OFFSET_MATRIX * s \
        + (input_offset << MIP_SHIFT_MATRIX)
    maxval = (1 << bit_depth) - 1
    acc = weights.astype(np.int64) @ p.astype(np.int64)
    red = np.clip((acc + offset) >> MIP_SHIFT_MATRIX, 0, maxval)
    red = red.reshape(red_size, red_size).astype(np.int32)
    if transposed:
        red = red.T

    if up_hor == 1 and up_ver == 1:
        return red

    # horizontal upsampling: rows land at vertical positions
    # (r+1)*up_ver - 1; "before" sample is the left boundary at that row
    cur = red
    if up_hor > 1:
        before = left[np.arange(red_size) * up_ver + up_ver - 1] \
            if up_ver > 1 else left[:red_size]
        cur = _upsample_1d(cur, before.astype(np.int32), up_hor)  # (red, w)
    if up_ver > 1:
        before = top[:w] if cur.shape[1] == w else top[:cur.shape[1]]
        cur = _upsample_1d(cur.T, before.astype(np.int32), up_ver).T
    return cur.astype(np.int32)


def predict_mip_all_modes(top: np.ndarray, left: np.ndarray, w: int, h: int,
                          bit_depth: int) -> np.ndarray:
    """All (mode, transpose) MIP predictions of one block, numpy.

    Returns array (num_modes, 2, h, w): axis 1 is [normal, transposed]."""
    n = num_mip_modes(w, h)
    from .. import native
    if native.available():
        return native.predict_mip_all(top, left, w, h, bit_depth, n)
    out = np.empty((n, 2, h, w), dtype=np.int32)
    for m in range(n):
        for t in (0, 1):
            out[m, t] = predict_mip(top, left, w, h, m, bool(t), bit_depth)
    return out

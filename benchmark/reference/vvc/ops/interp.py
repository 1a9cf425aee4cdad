"""Motion-compensation interpolation filters (H.266 8.5.6.3).

8-tap luma / 4-tap chroma separable filters at 1/16 (chroma 1/32) pel
phases.  Behavioral reference: vvenc CommonLib/InterpolationFilter.cpp:85
(m_lumaFilter), :107 (m_chromaFilter), filter arithmetic (shift/offset
conventions with the 14-bit intermediate precision) per
InterpolationFilter::filter<>.

numpy golden path + the batched device path (a batch of equal-size
windows at one fractional phase; the encoder groups blocks by phase):

  mc_batch -> K8, csrc/mc_batch.cu; mc_batch_ref is its plain version
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from . import kernels
from .intra import CHROMA_FILTER  # 32-phase 4-tap (shared with intra)

IF_INTERNAL_PREC = 14
IF_FILTER_PREC = 6
IF_INTERNAL_OFFS = 1 << (IF_INTERNAL_PREC - 1)

# 16-phase 8-tap luma filter (H.266 Table 34)
LUMA_FILTER = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [0, 1, -3, 63, 4, -2, 1, 0],
    [-1, 2, -5, 62, 8, -3, 1, 0],
    [-1, 3, -8, 60, 13, -4, 1, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 52, 26, -8, 3, -1],
    [-1, 3, -9, 47, 31, -10, 4, -1],
    [-1, 4, -11, 45, 34, -10, 4, -1],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [-1, 4, -10, 34, 45, -11, 4, -1],
    [-1, 4, -10, 31, 47, -9, 3, -1],
    [-1, 3, -8, 26, 52, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
    [0, 1, -4, 13, 60, -8, 3, -1],
    [0, 1, -3, 8, 62, -5, 2, -1],
    [0, 1, -2, 4, 63, -3, 1, 0]], dtype=np.int32)

NTAPS_LUMA = 8
NTAPS_CHROMA = 4


def _filter_1d(src, taps, axis, is_first, is_last, bit_depth):
    """One separable filter stage with the normative shift/offset scheme."""
    head_room = IF_INTERNAL_PREC - bit_depth
    shift = IF_FILTER_PREC
    if is_last:
        shift += 0 if is_first else head_room
        offset = 1 << (shift - 1)
        offset += 0 if is_first else IF_INTERNAL_OFFS << IF_FILTER_PREC
    else:
        shift -= head_room if is_first else 0
        offset = (-IF_INTERNAL_OFFS << shift) if is_first else 0
    n = len(taps)
    acc = np.zeros([s - n + 1 if a == axis else s
                    for a, s in enumerate(src.shape)], dtype=np.int64)
    for k in range(n):
        sl = [slice(None)] * src.ndim
        sl[axis] = slice(k, k + acc.shape[axis])
        acc += int(taps[k]) * src[tuple(sl)].astype(np.int64)
    val = (acc + offset) >> shift
    if is_last:
        val = np.clip(val, 0, (1 << bit_depth) - 1)
    return val


# 6-tap alternative half-pel luma filter (AMVR half-pel mode; vvenc
# InterpolationFilter.cpp:106 m_lumaAltHpelIFilter)
ALT_HPEL_FILTER = np.array([0, 3, 9, 20, 20, 9, 3, 0], dtype=np.int32)

# BCW weights (vvenc Rom.cpp:1152)
BCW_WEIGHTS = (-2, 3, 4, 5, 10)
BCW_DEFAULT = 2


def mc_block_np(ref_plane: np.ndarray, x: int, y: int, w: int, h: int,
                mv_x: int, mv_y: int, bit_depth: int = 10,
                is_luma: bool = True, intermediate: bool = False,
                alt_hpel: bool = False,
                taps_override: np.ndarray = None) -> np.ndarray:
    """Motion-compensated prediction of one block.

    mv in units of 1/16 luma pel (1/32 chroma pel for chroma planes with
    the chroma mv convention already applied by the caller).
    ref_plane is border-padded by replication on demand.
    intermediate=True returns the 14-bit biased intermediate used for
    bi-prediction averaging (isLast=false path).

    Dispatches to the native kernel (vte_mc_block) when loaded — the MC
    filter is the RD loop's hottest host op (InterpolationFilterX86.h
    analog); `_mc_block_py` below is the golden model
    (tests/test_native.py fuzzes native vs python)."""
    from .. import native
    if native.available() and ref_plane.dtype == np.int32 \
            and ref_plane.flags.c_contiguous:
        return native.mc_block(ref_plane, x, y, w, h, mv_x, mv_y,
                               bit_depth, is_luma, intermediate, alt_hpel,
                               taps_override)
    return _mc_block_py(ref_plane, x, y, w, h, mv_x, mv_y, bit_depth,
                        is_luma, intermediate, alt_hpel, taps_override)


def _mc_block_py(ref_plane: np.ndarray, x: int, y: int, w: int, h: int,
                 mv_x: int, mv_y: int, bit_depth: int = 10,
                 is_luma: bool = True, intermediate: bool = False,
                 alt_hpel: bool = False,
                 taps_override: np.ndarray = None) -> np.ndarray:
    """Pure-python golden MC (see mc_block_np)."""
    if is_luma:
        frac_bits, taps_tbl, ntaps = 4, LUMA_FILTER, NTAPS_LUMA
        if taps_override is not None:
            taps_tbl = taps_override   # e.g. the 6-tap affine luma filter
    else:
        frac_bits, taps_tbl, ntaps = 5, CHROMA_FILTER, NTAPS_CHROMA

    def taps_for(frac):
        if is_luma and alt_hpel and frac == 8:
            return ALT_HPEL_FILTER
        return taps_tbl[frac]
    int_x, frac_x = x + (mv_x >> frac_bits), mv_x & ((1 << frac_bits) - 1)
    int_y, frac_y = y + (mv_y >> frac_bits), mv_y & ((1 << frac_bits) - 1)
    half = ntaps // 2 - 1
    # gather padded source window (replicated borders)
    ph, pw = ref_plane.shape
    xs = np.clip(np.arange(int_x - half, int_x + w + ntaps - 1 - half), 0, pw - 1)
    ys = np.clip(np.arange(int_y - half, int_y + h + ntaps - 1 - half), 0, ph - 1)
    win = ref_plane[np.ix_(ys, xs)].astype(np.int32)
    last = not intermediate
    if frac_x == 0 and frac_y == 0:
        out = win[half:half + h, half:half + w]
        if intermediate:
            head_room = IF_INTERNAL_PREC - bit_depth
            out = (out.astype(np.int64) << head_room) - IF_INTERNAL_OFFS
        return out.astype(np.int32)
    if frac_y == 0:
        out = _filter_1d(win[half:half + h, :], taps_for(frac_x), 1,
                         True, last, bit_depth)
        return out.astype(np.int32)
    if frac_x == 0:
        out = _filter_1d(win[:, half:half + w], taps_for(frac_y), 0,
                         True, last, bit_depth)
        return out.astype(np.int32)
    tmp = _filter_1d(win, taps_for(frac_x), 1, True, False, bit_depth)
    out = _filter_1d(tmp, taps_for(frac_y), 0, False, last, bit_depth)
    return out.astype(np.int32)


def bi_average_np(a: np.ndarray, b: np.ndarray, bit_depth: int = 10) -> np.ndarray:
    """Bi-prediction average of two 14-bit intermediates
    (vvenc AreaBuf<Pel>::addAvg, Buffer.cpp:625)."""
    shift = max(2, IF_INTERNAL_PREC - bit_depth) + 1
    offset = (1 << (shift - 1)) + 2 * IF_INTERNAL_OFFS
    out = (a.astype(np.int64) + b.astype(np.int64) + offset) >> shift
    return np.clip(out, 0, (1 << bit_depth) - 1).astype(np.int32)


def bcw_average_np(a: np.ndarray, b: np.ndarray, bcw_idx: int,
                   bit_depth: int = 10) -> np.ndarray:
    """BCW weighted bi-prediction average (vvenc
    AreaBuf<Pel>::addWeightedAvg, Buffer.cpp:522)."""
    w1 = BCW_WEIGHTS[bcw_idx]
    w0 = 8 - w1
    shift = max(2, IF_INTERNAL_PREC - bit_depth) + 3
    offset = (1 << (shift - 1)) + (IF_INTERNAL_OFFS << 3)
    out = (a.astype(np.int64) * w0 + b.astype(np.int64) * w1 + offset) \
        >> shift
    return np.clip(out, 0, (1 << bit_depth) - 1).astype(np.int32)


# ---------------------------------------------------------------------------
# batched path: one fractional phase, a batch of windows
# ---------------------------------------------------------------------------

def _mc_stage(frac, is_first, is_last, bit_depth, is_luma):
    """(taps, shift, offset) of one filter stage at phase frac with the
    reference's shift/offset scheme."""
    taps_tbl = LUMA_FILTER if is_luma else np.asarray(CHROMA_FILTER)
    head_room = IF_INTERNAL_PREC - bit_depth
    shift = IF_FILTER_PREC
    if is_last:
        shift += 0 if is_first else head_room
        offset = (1 << (shift - 1)) + \
            (0 if is_first else IF_INTERNAL_OFFS << IF_FILTER_PREC)
    else:
        shift -= head_room if is_first else 0
        offset = (-IF_INTERNAL_OFFS << shift) if is_first else 0
    return [int(t) for t in taps_tbl[frac]], shift, offset


def _mc_check(windows, frac_x, frac_y, w, h, is_luma) -> int:
    """ntaps of one mc_batch call after checking its arguments."""
    nphases = len(LUMA_FILTER) if is_luma else len(CHROMA_FILTER)
    ntaps = NTAPS_LUMA if is_luma else NTAPS_CHROMA
    for f in (frac_x, frac_y):
        if not 0 <= f < nphases:
            raise IndexError(f"mc_batch: phase {f} outside the "
                             f"{nphases}-phase filter table")
    if windows.dim() != 3 or tuple(windows.shape[1:]) != (h + ntaps - 1,
                                                          w + ntaps - 1):
        raise ValueError(f"windows {tuple(windows.shape)}: need [B, "
                         f"{h + ntaps - 1}, {w + ntaps - 1}]")
    return ntaps


def _mc_plan(windows, frac_x, frac_y, w, h, bit_depth, is_luma):
    """(ntaps, half, stage) of one mc_batch call after checking its
    arguments; stage(frac, is_first, is_last) -> (taps, shift, offset)
    with the reference's shift/offset scheme."""
    ntaps = _mc_check(windows, frac_x, frac_y, w, h, is_luma)

    def stage(frac, is_first, is_last):
        return _mc_stage(frac, is_first, is_last, bit_depth, is_luma)
    return ntaps, ntaps // 2 - 1, stage


def mc_batch_ref(windows: torch.Tensor, frac_x: int, frac_y: int, w: int,
                 h: int, bit_depth: int = 10,
                 is_luma: bool = True) -> torch.Tensor:
    """Plain PyTorch version of mc_batch: the reference's int32 program
    (its intermediates are the size of the windows)."""
    ntaps, half, stage = _mc_plan(windows, frac_x, frac_y, w, h, bit_depth,
                                  is_luma)
    maxval = (1 << bit_depth) - 1

    def run(src, frac, axis, is_first, is_last):
        taps, shift, offset = stage(frac, is_first, is_last)
        length = src.shape[axis] - ntaps + 1
        acc = None
        for k in range(ntaps):
            term = taps[k] * src.narrow(axis, k, length)
            acc = term if acc is None else acc + term
        val = (acc + offset) >> shift
        return torch.clamp(val, 0, maxval) if is_last else val

    if frac_x == 0 and frac_y == 0:
        return windows[:, half:half + h, half:half + w].clone()
    if frac_y == 0:
        return run(windows[:, half:half + h, :], frac_x, 2, True, True)
    if frac_x == 0:
        return run(windows[:, :, half:half + w], frac_y, 1, True, True)
    tmp = run(windows, frac_x, 2, True, False)
    return run(tmp, frac_y, 1, False, True)


_K8_ARGS = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
            + [ctypes.c_int] * 25 + [ctypes.c_void_p])


@lru_cache(maxsize=None)
def _k8_args(frac_x: int, frac_y: int, bit_depth: int,
             is_luma: bool) -> tuple:
    """The 23 ints vt_mc_batch takes after (B, w, h) for one phase:
    ntaps, kind (0 copy, 1 horizontal only, 2 vertical only, 3 both),
    the 8 horizontal and 8 vertical taps (zero past ntaps), sh1, off1,
    sh2, off2 and the clip's maximum.  They depend only on the phase, the
    bit depth and the plane, so they are computed once."""
    ntaps = NTAPS_LUMA if is_luma else NTAPS_CHROMA
    kind = (frac_x != 0) + 2 * (frac_y != 0)
    tx, s1, o1 = _mc_stage(frac_x, True, kind != 3, bit_depth, is_luma)
    ty, s2, o2 = _mc_stage(frac_y, kind != 3, True, bit_depth, is_luma)
    pad = [0] * (8 - ntaps)
    return (ntaps, kind, *(tx + pad), *(ty + pad), s1, o1, s2, o2,
            (1 << bit_depth) - 1)


def mc_batch(windows: torch.Tensor, frac_x: int, frac_y: int, w: int,
             h: int, bit_depth: int = 10, is_luma: bool = True) -> torch.Tensor:
    """MC filter a batch of pre-gathered windows at one fractional phase.

    windows: [B, h + ntaps - 1, w + ntaps - 1] int32 (for frac-only dims
    the extra ntaps-1 border is still expected; integer dims use the
    centre).  Returns [B, h, w] int32 predictions.  K8 on a CUDA device,
    the plain version on the CPU."""
    if windows.device.type == "cpu":
        return mc_batch_ref(windows, frac_x, frac_y, w, h, bit_depth,
                            is_luma)
    dev = windows.device
    if dev.type != "cuda":
        raise ValueError(f"mc_batch: no kernel for {dev}")
    kernels.require(windows, "windows", torch.int32, 3, dev)
    _mc_check(windows, frac_x, frac_y, w, h, is_luma)
    args = _k8_args(frac_x, frac_y, bit_depth, is_luma)
    B = windows.shape[0]
    out = torch.empty((B, h, w), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    fn = kernels.function("mc_batch", "vt_mc_batch", _K8_ARGS)
    err = fn(windows.data_ptr(), out.data_ptr(), B, w, h, *args,
             kernels.stream_ptr(out))
    kernels.check("mc_batch", err)
    kernels.count("mc_batch")
    return out

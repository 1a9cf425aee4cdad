"""Device copies of the static tables the CUDA kernels read.

The kernels take their per-(w, h) control flow from the same numpy tables
the host golden models use (ops/intra_vec._shape_tables, ops/transforms
tr_matrix, ops/intra_plan._MODE_BITS).  device_tables() uploads them once
per (device, w, h) and keeps them for the life of the process.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .intra_vec import _shape_tables
from .transforms import DCT2, DST7, tr_matrix

# flag bits of mode_info[:, 2]
FLAG_VER, FLAG_PDPC, FLAG_ANG0 = 1, 2, 4


def _angular_tables(w: int, h: int) -> dict:
    """K1's view of _shape_tables(w, h, True, 0): flat reference-pool
    indices (pool = [top, ftop, left, fleft], LPAD entries each) and the
    per-mode tap, shift and PDPC tables, all int32."""
    t = _shape_tables(w, h, True, 0)
    lpad = t.LPAD
    info = np.zeros((t.shift.shape[0], 4), np.int32)
    info[:, 0] = t.shift
    info[:, 1] = t.round
    info[:, 2] = (t.is_ver * FLAG_VER + t.pdpc_on * FLAG_PDPC
                  + t.pdpc_ang0 * FLAG_ANG0)
    side = (t.pdpc_side_src.astype(np.int64)[:, None, None] * lpad
            + t.pdpc_side_idx)
    return dict(
        rm_flat=(t.rm_src.astype(np.int64) * lpad + t.rm_idx),
        row_start=t.row_start, filt=t.filt, mode_info=info,
        pdpc_wl=t.pdpc_wl, side_flat=side,
        LPAD=lpad, LR=t.LR, TM=max(w, h), B0=t.B0)


@lru_cache(maxsize=None)
def _device_tables(device: str, w: int, h: int) -> dict:
    from .intra_plan import _MODE_BITS
    dev = torch.device(device)
    out = {}
    for k, v in _angular_tables(w, h).items():
        out[k] = (torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(dev)
                  if isinstance(v, np.ndarray) else v)
    # transform matrices of both axes
    out["tr"] = {}
    for n in {w, h}:
        for tt in (DCT2, DST7):
            if tt == DST7 and not 4 <= n <= 32:
                continue
            m = np.ascontiguousarray(tr_matrix(n, tt), np.int32)
            out["tr"][(n, tt)] = torch.from_numpy(m).to(dev)
    out["trT"] = {k: v.t().contiguous() for k, v in out["tr"].items()}
    out["mode_bits"] = torch.from_numpy(_MODE_BITS.copy()).to(dev)
    return out


# the widest PDPC support of an angular mode (3 << scale columns, at most
# 12); K4 holds this many weights and side offsets per mode
PDPC_COLS = 12


def presel_mode_tables(w: int, h: int, nA: int, nL: int) -> dict:
    """K4's per-mode tables for a (w, h) class whose reference pool is
    [top (nA) | ftop (nA) | left (nL) | fleft (nL)]: K1's tables turned
    into one list of pool positions per mode, clamped here to the pool's
    last entry (as XLA clamps the reference's gathers), so that the kernel
    gathers a mode's values once per candidate and reads them with no
    index table and no clamp.

    Mode m's list (row m - 2 of `gidx`) is its reference main from the
    lowest to the highest position its rows read (SB entries), then its
    PDPC side values S[j] = pool[min(side * LPAD + min(j, cap), last)],
    then (for the pure horizontal / vertical modes) the corner entry at
    TL.  The kernel reads a row's 4-tap window at rs[row] + col and a PDPC
    sample's side value at SB + row + soff[col]; the construction is
    checked here against K1's tables entry by entry.  Returns numpy
    arrays: gidx [65, LM] int32 (LM odd), rs [65, TM] int32, taps
    [65, TM, 4] float32, wl [65, PDPC_COLS] float32, soff [65, PDPC_COLS]
    int32, minfo [65, 4] int32 (flags, SB, TL, the list's length) and LM."""
    t = _shape_tables(w, h, True, 0)
    a = _angular_tables(w, h)
    last = 2 * nA + 2 * nL - 1
    TM = a["TM"]
    lists, rs_rel = [], np.zeros((65, TM), np.int32)
    wl = np.zeros((65, PDPC_COLS), np.float32)
    soff = np.zeros((65, PDPC_COLS), np.int32)
    minfo = np.zeros((65, 4), np.int32)
    for m in range(65):
        rows, cols = (h, w) if t.is_ver[m] else (w, h)
        rs = a["row_start"][m, :rows]
        lo, hi = int(rs.min()), int(rs.max()) + cols + 2
        rm = np.minimum(a["rm_flat"][m, lo:hi + 1], last)
        rs_rel[m, :rows] = rs - lo
        side, tl = [], []
        if t.pdpc_on[m]:
            pw = int((t.pdpc_wl[m] != 0).sum())
            assert pw <= PDPC_COLS
            sidx = t.pdpc_side_idx[m, :rows, :pw]
            off = sidx[0]
            cap = int(sidx.max())
            base = int(t.pdpc_side_src[m]) * t.LPAD
            n = rows + int(off.max())
            side = np.minimum(base + np.minimum(np.arange(n), cap), last)
            want = np.minimum(a["side_flat"][m, :rows, :pw], last)
            got = side[np.arange(rows)[:, None] + off[None, :]]
            assert np.array_equal(got, want), (w, h, m)
            wl[m, :pw] = t.pdpc_wl[m, :pw]
            soff[m, :pw] = off
        if t.pdpc_ang0[m]:
            tl = [min(int(a["rm_flat"][m, a["B0"]]), last)]
        lists.append(np.concatenate([rm, side, tl]).astype(np.int32))
        minfo[m] = (a["mode_info"][m, 2], len(rm), len(rm) + len(side),
                    len(rm) + len(side) + len(tl))
    LM = max(len(x) for x in lists) | 1
    gidx = np.zeros((65, LM), np.int32)
    for m, x in enumerate(lists):
        gidx[m, :len(x)] = x
    return dict(gidx=gidx, rs=rs_rel,
                taps=a["filt"].astype(np.float32), wl=wl, soff=soff,
                minfo=minfo, LM=LM)


@lru_cache(maxsize=None)
def _presel_device_tables(device: str, w: int, h: int, nA: int,
                          nL: int) -> dict:
    dev = torch.device(device)
    return {k: (torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                if isinstance(v, np.ndarray) else v)
            for k, v in presel_mode_tables(w, h, nA, nL).items()}


def presel_device_tables(w: int, h: int, nA: int, nL: int, device) -> dict:
    """presel_mode_tables(w, h, nA, nL) as tensors on `device`, uploaded
    once per (device, w, h, nA, nL)."""
    return _presel_device_tables(str(torch.device(device)), int(w), int(h),
                                 int(nA), int(nL))


def device_tables(w: int, h: int, device) -> dict:
    """The kernels' tables for block size (w, h) as tensors on `device`:
    K1's angular tables (rm_flat, row_start, filt, mode_info, pdpc_wl,
    side_flat and the ints LPAD, LR, TM, B0), the transform matrices
    tr[(n, type)] for n in {w, h} and their transposes trT[(n, type)],
    and mode_bits."""
    return _device_tables(str(torch.device(device)), int(w), int(h))

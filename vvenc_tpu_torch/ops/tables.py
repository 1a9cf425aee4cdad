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


def device_tables(w: int, h: int, device) -> dict:
    """The kernels' tables for block size (w, h) as tensors on `device`:
    K1's angular tables (rm_flat, row_start, filt, mode_info, pdpc_wl,
    side_flat and the ints LPAD, LR, TM, B0), the transform matrices
    tr[(n, type)] for n in {w, h} and their transposes trT[(n, type)],
    and mode_bits."""
    return _device_tables(str(torch.device(device)), int(w), int(h))

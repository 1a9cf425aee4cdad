"""Distortion kernels: SAD / SSE / SATD (Hadamard), numpy golden models
and the batched device versions.

Analog of vvenc's RdCost engine (CommonLib/RdCost.h:114, SIMD kernels
RdCostX86.h).  The 67-mode SATD of the intra planning lives in
ops/intra_presel.satd_batch (CUDA kernel csrc/satd_modes.cu); this
module's batched functions compare two [B, H, W] int32 inputs:

  sse_batch / sad_batch / satd_batch -> K10, csrc/dist_batch.cu; each
  *_ref is its plain version

sad_batch and satd_batch are the reference's int32 arithmetic, wrapping
as XLA's does where a sum passes 2^31 (large tiles of large values).
sse_batch sums exactly in int64 and returns the float32 of the sum; the
reference sums float32 squares in XLA's order (within rtol 1e-5 of it).

SATD follows the reference's Hadamard convention (8x8 transform with the
final normalization (sum/8 * 2), 4x4 with sum/2-ish scaling) so RD decisions
are comparable to vvenc's; exact normalization: vvenc xCalcHADs8x8 returns
(sum + 2) >> 2 per 8x8 after abs-sum of the 2-D Hadamard, and xCalcHADs4x4
returns (sum + 1) >> 1 with DC adjusted.  We reproduce the 8x8 and 4x4
variants used for intra mode preselection.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from . import kernels


@lru_cache(maxsize=None)
def _hadamard(n: int) -> np.ndarray:
    if n == 1:
        return np.array([[1]], dtype=np.int32)
    h = _hadamard(n // 2)
    return np.block([[h, h], [h, -h]])


def sse_np(a: np.ndarray, b: np.ndarray) -> int:
    d = a.astype(np.int64) - b.astype(np.int64)
    return int((d * d).sum())


def sad_np(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).sum())


def satd_np(a: np.ndarray, b: np.ndarray) -> int:
    """Hadamard transformed SAD over 8x8 (or 4x4) tiles, vvenc convention."""
    d = a.astype(np.int64) - b.astype(np.int64)
    h, w = d.shape
    ts = 8 if (h % 8 == 0 and w % 8 == 0) else 4
    hm = _hadamard(ts).astype(np.int64)
    total = 0
    for y in range(0, h, ts):
        for x in range(0, w, ts):
            blk = d[y:y + ts, x:x + ts]
            t = hm @ blk @ hm
            s = int(np.abs(t).sum())
            if ts == 8:
                total += (s + 2) >> 2
            else:
                s = s - abs(int(t[0, 0])) + (abs(int(t[0, 0])) >> 2)
                total += (s + 1) >> 1
    return total


# ---------------------------------------------------------------------------
# batched versions: a, b [B, H, W] int32
# ---------------------------------------------------------------------------

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_CHUNK_ELEMS = 1 << 22          # int64 samples per step of a plain version


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """The int32 value (as int64) that XLA's wrapping int32 arithmetic
    gives for the exact integer x."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _steps(B: int, per_item: int):
    """Batch slices that keep a plain version's int64 intermediate of
    per_item samples an item to about _CHUNK_ELEMS samples."""
    step = max(1, _CHUNK_ELEMS // max(1, per_item))
    return [slice(c, min(c + step, B)) for c in range(0, B, step)]


def sse_batch_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of sse_batch: [B] float32 of the exact int64
    sum of (a - b)^2 (the difference wraps to int32 first, as the
    reference's)."""
    B = a.shape[0]
    out = torch.empty((B,), dtype=torch.int64, device=a.device)
    for s in _steps(B, a[0].numel() if B else 0):
        d = _wrap32(a[s].long() - b[s].long())
        out[s] = (d * d).sum(dim=(-2, -1))
    return out.to(torch.float32)


def sad_batch_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of sad_batch: [B] int32 sum of |a - b|."""
    B = a.shape[0]
    out = torch.empty((B,), dtype=torch.int32, device=a.device)
    for s in _steps(B, a[0].numel() if B else 0):
        d = _wrap32(_wrap32(a[s].long() - b[s].long()).abs())
        out[s] = _wrap32(d.sum(dim=(-2, -1))).to(torch.int32)
    return out


def satd_batch_ref(a: torch.Tensor, b: torch.Tensor,
                   tile: int = 8) -> torch.Tensor:
    """Plain PyTorch version of satd_batch: per tile x tile tile the 2-D
    Hadamard of the difference as integer multiply-and-sum, sum|T| with
    (s + 2) >> 2 (tile 8) or the DC correction and (s + 1) >> 1 (every
    other tile), summed over the tiles; every step wraps to int32 as the
    reference's int32 einsum and sums do."""
    _check_pair(a, b, tile)
    B, H, W = a.shape
    hm = torch.from_numpy(_hadamard(tile).astype(np.int64)).to(a.device)
    out = torch.empty((B,), dtype=torch.int32, device=a.device)
    for s in _steps(B, H * W):
        d = _wrap32(a[s].long() - b[s].long())
        n = d.shape[0]
        t = d.reshape(n, H // tile, tile, W // tile, tile).permute(0, 1, 3, 2, 4)
        # hm @ t @ hm, exact in int64 (|d| <= 2^31, tile <= 64), then wrapped
        t = sum(hm[:, j, None] * t[..., j, None, :] for j in range(tile))
        t = sum(t[..., :, k, None] * hm[k][None, :] for k in range(tile))
        t = _wrap32(t)
        sm = _wrap32(_wrap32(t.abs()).sum(dim=(-2, -1)))
        if tile == 8:
            sm = _wrap32(sm + 2) >> 2
        else:
            dc = _wrap32(t[..., 0, 0].abs())
            sm = _wrap32(_wrap32(sm - dc + (dc >> 2)) + 1) >> 1
        out[s] = _wrap32(sm.sum(dim=(1, 2))).to(torch.int32)
    return out


def _check_pair(a: torch.Tensor, b: torch.Tensor, tile: int = 1) -> None:
    if a.dim() != 3 or tuple(a.shape) != tuple(b.shape):
        raise ValueError(f"a {tuple(a.shape)} / b {tuple(b.shape)}: need "
                         "two [B, H, W] tensors of one shape")
    if tile < 1 or tile & (tile - 1) or tile > 64:
        raise ValueError(f"tile {tile}: a power of two up to 64")
    if a.shape[1] % tile or a.shape[2] % tile:
        raise ValueError(f"tile {tile} does not divide {tuple(a.shape[1:])}")


def _launch(entry: str, symbol: str, a, b, out, *extra) -> torch.Tensor:
    """Checks a and b, launches K10's `symbol` on them into out."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"{entry}: no kernel for {dev}")
    kernels.require(a, "a", torch.int32, 3, dev)
    kernels.require(b, "b", torch.int32, 3, dev)
    B, H, W = a.shape
    if B == 0 or H * W == 0:
        return out.zero_()
    fn = kernels.function("dist_batch", symbol,
                          [_P, _P, _P, _L, _I, _I] + [_I] * len(extra) + [_P])
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), B, H, W, *extra,
             kernels.stream_ptr(out))
    kernels.check("dist_batch", err)
    kernels.count(entry)
    return out


def sse_batch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of squared differences of a batch: a, b [B, H, W] int32 ->
    [B] float32 (the exact integer sum, rounded once).  K10 on a CUDA
    device, the plain version on the CPU."""
    _check_pair(a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return sse_batch_ref(a, b)
    out = torch.empty((a.shape[0],), dtype=torch.float32, device=a.device)
    return _launch("sse_batch", "vt_sse_batch", a, b, out)


def sad_batch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of absolute differences of a batch: a, b [B, H, W] int32 ->
    [B] int32.  K10 on a CUDA device, the plain version on the CPU."""
    _check_pair(a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return sad_batch_ref(a, b)
    out = torch.empty((a.shape[0],), dtype=torch.int32, device=a.device)
    return _launch("sad_batch", "vt_sad_batch", a, b, out)


def satd_batch(a: torch.Tensor, b: torch.Tensor, tile: int = 8) -> torch.Tensor:
    """Batched Hadamard SAD: a, b [B, H, W] int32, tile a power of two
    (up to 64) dividing H and W -> [B] int32.  K10 on a CUDA device, the
    plain version on the CPU."""
    _check_pair(a, b, tile)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return satd_batch_ref(a, b, tile)
    # the kernel stores every element once: no zero-fill
    out = torch.empty((a.shape[0],), dtype=torch.int32, device=a.device)
    return _launch("satd_batch", "vt_satd_batch", a, b, out, tile)

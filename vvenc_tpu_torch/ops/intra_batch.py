"""Batched intra mode evaluation: the 67-mode SATD of a batch of square
blocks from host-built per-mode reference arrays.

Counterpart of vvenc's per-block mode loop (IntraSearch
estIntraPredLumaQT, IntraSearch.cpp), evaluated for ALL 67 modes of a
BATCH of equal-size blocks at once:

  host:   per block, build the per-mode extended main reference array
          (availability, substitution, MDIS filtering, wide-angle mapping,
          negative-angle extension) -> RM [B, M, L] (build_ref_mains)
  device: the prediction of every mode (4-tap angular gather from RM,
          planar without MDIS, square DC, no PDPC) and its SATD against
          the source -> costs [B, M] (mode_costs_batch)

  mode_costs_batch -> K11, csrc/mode_costs.cu; mode_costs_batch_ref is
  its plain version

The index and filter tables are static per size (_mode_tables); the
kernel's copy is uploaded once per (size, device).  PDPC is omitted in
this preselection pass (full RD of the chosen candidates applies it
exactly, matching vvenc's pre-pass approach).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from . import intra as I
from . import kernels
from .rdcost import _hadamard

NUM_MODES = I.NUM_LUMA_MODE  # 67


@lru_cache(maxsize=None)
def _mode_tables(w: int, h: int):
    """Static per-(w, h) tables for the angular gather kernel.

    Returns (ref_len, base_off, row_start[M, H] int32, filt[M, H, 4] int32,
             is_transposed[M] bool, uses_filtered[M] bool).
    row_start[m, y] gives the index into the (per-mode) extended main ref of
    the first tap for row y; prediction x adds +x.
    """
    assert w == h, "non-square handled after MTT lands"
    side = h
    base_off = side              # room for negative-angle left extension
    ref_len = side + 2 * w + 8   # base_off + refMain[0..2w+4]
    row_start = np.zeros((NUM_MODES, h), dtype=np.int32)
    filt = np.zeros((NUM_MODES, h, 4), dtype=np.int32)
    transposed = np.zeros(NUM_MODES, dtype=bool)
    uses_filtered = np.zeros(NUM_MODES, dtype=bool)
    for mode in range(2, NUM_MODES):
        p = I.intra_params(w, h, mode, True)
        transposed[mode] = not p.is_ver
        uses_filtered[mode] = p.ref_filter
        delta_pos = p.angle
        for y in range(h):
            delta_int = delta_pos >> 5
            frac = delta_pos & 31
            if I.is_integer_slope(abs(p.angle)):
                # pure copy: the unit tap sits at k=1, so the same base as
                # the 4-tap case addresses refMain[deltaInt + 1 + x]
                row_start[mode, y] = base_off + delta_int
                filt[mode, y] = (0, 64, 0, 0)
            else:
                row_start[mode, y] = base_off + delta_int
                if p.interp:
                    filt[mode, y] = I.smoothing_filter(frac)
                else:
                    filt[mode, y] = I.CHROMA_FILTER[frac]
            delta_pos += p.angle
    return ref_len, base_off, row_start, filt, transposed, uses_filtered


def build_ref_mains(tops: np.ndarray, lefts: np.ndarray, w: int, h: int):
    """Host prep: per-mode extended main reference arrays.

    tops:  [B, 2w+3] unfiltered top refs (corner at index 0)
    lefts: [B, 2h+3]
    Returns RM [B, NUM_MODES, ref_len] int32.
    """
    B = tops.shape[0]
    ref_len, base_off, _, _, transposed, uses_filtered = _mode_tables(w, h)
    ftops = np.empty_like(tops)
    flefts = np.empty_like(lefts)
    for b in range(B):
        ftops[b], flefts[b] = I.filter_reference(tops[b], lefts[b])
    rm = np.zeros((B, NUM_MODES, ref_len), dtype=np.int32)
    for mode in range(2, NUM_MODES):
        p = I.intra_params(w, h, mode, True)
        t_src = ftops if p.ref_filter else tops
        l_src = flefts if p.ref_filter else lefts
        for b in range(B):
            main, _, base = I._build_ref_main_side(
                t_src[b], l_src[b], p, w, h)
            n = min(len(main), ref_len - (base_off - base))
            rm[b, mode, base_off - base: base_off - base + n] = main[:n]
    return rm


def _check_inputs(src, rm, tops, lefts, w, h):
    """ref_len after checking the shapes (square sizes 4..64)."""
    if w != h:
        raise ValueError(f"mode_costs_batch: {w}x{h}: square blocks only")
    if w not in (4, 8, 16, 32, 64):
        raise ValueError(f"mode_costs_batch: size {w}: 4..64")
    ref_len = _mode_tables(w, h)[0]
    B = src.shape[0]
    if src.dim() != 3 or tuple(src.shape[1:]) != (h, w) or rm.dim() != 3 or \
            tuple(rm.shape) != (B, NUM_MODES, ref_len) or \
            tops.dim() != 2 or lefts.dim() != 2 or tops.shape[0] != B or \
            lefts.shape[0] != B or tops.shape[1] < w + 2 or \
            lefts.shape[1] < h + 2:
        raise ValueError(
            f"src {tuple(src.shape)}, rm {tuple(rm.shape)}, tops "
            f"{tuple(tops.shape)}, lefts {tuple(lefts.shape)}: need [B, {h}, "
            f"{w}], [B, {NUM_MODES}, {ref_len}], [B, >={w + 2}], "
            f"[B, >={h + 2}]")
    return ref_len


def _ref_chunk(w: int) -> int:
    """Blocks per step of the plain version: bounds its [B, 67, h, w]
    intermediates to about 64 MB of int32."""
    return max(1, (1 << 24) // (NUM_MODES * w * w))


def mode_costs_batch_ref(src: torch.Tensor, rm: torch.Tensor,
                         tops: torch.Tensor, lefts: torch.Tensor, w: int,
                         h: int, bit_depth: int = 10) -> torch.Tensor:
    """Plain PyTorch version of mode_costs_batch: the reference's int32
    program, _ref_chunk blocks at a time, the Hadamard products written
    as integer multiply-and-sum."""
    _check_inputs(src, rm, tops, lefts, w, h)
    dev = src.device
    _, _, row_start, filt, transposed, _ = _mode_tables(w, h)
    idx = torch.from_numpy(row_start[:, :, None] + np.arange(w)[None, None]
                           ).to(dev).long().reshape(NUM_MODES, h * w)
    filt_t = torch.from_numpy(filt).to(dev)
    tr = torch.from_numpy(transposed).to(dev)
    log2w = w.bit_length() - 1
    log2h = log2w
    maxval = (1 << bit_depth) - 1
    tile = 8 if w % 8 == 0 else 4
    hm = torch.from_numpy(_hadamard(tile).astype(np.int32)).to(dev)
    xg = torch.arange(w, dtype=torch.int32, device=dev)[None, None, :]
    yg = torch.arange(h, dtype=torch.int32, device=dev)[None, :, None]
    B = src.shape[0]
    out = torch.empty((B, NUM_MODES), dtype=torch.int32, device=dev)
    step = _ref_chunk(w)
    for c0 in range(0, B, step):
        c1 = min(c0 + step, B)
        n = c1 - c0
        r = rm[c0:c1]
        acc = None
        for k in range(4):
            g = torch.gather(r, 2, (idx + k)[None].expand(n, -1, -1)) \
                .reshape(n, NUM_MODES, h, w)
            term = filt_t[None, :, :, k:k + 1] * g
            acc = term if acc is None else acc + term
        ang = torch.clamp((acc + 32) >> 6, 0, maxval)
        ang = torch.where(tr[None, :, None, None], ang.transpose(2, 3), ang)
        top_row = tops[c0:c1, 1:w + 2]
        left_col = lefts[c0:c1, 1:h + 2]
        br_ = left_col[:, h][:, None, None]
        tr_ = top_row[:, w][:, None, None]
        lc = left_col[:, :h, None]
        tp = top_row[:, None, :w]
        hor = (lc << log2w) + (xg + 1) * (tr_ - lc)
        ver = (tp << log2h) + (yg + 1) * (br_ - tp)
        planar = ((hor << log2h) + (ver << log2w) + (1 << (log2w + log2h))) \
            >> (1 + log2w + log2h)
        dc = (tops[c0:c1, 1:w + 1].sum(dim=1, dtype=torch.int32)
              + lefts[c0:c1, 1:h + 1].sum(dim=1, dtype=torch.int32) + w) \
            >> (log2w + 1)
        preds = ang.clone()
        preds[:, I.PLANAR_IDX] = planar
        preds[:, I.DC_IDX] = dc[:, None, None]
        d = src[c0:c1, None] - preds                              # [n,M,h,w]
        t = d.reshape(n, NUM_MODES, h // tile, tile, w // tile, tile) \
            .permute(0, 1, 2, 4, 3, 5)
        t = sum(hm[:, j, None] * t[..., j, None, :] for j in range(tile))
        t = sum(t[..., :, k, None] * hm[k][None, :] for k in range(tile))
        s = t.abs().sum(dim=(-2, -1), dtype=torch.int32)
        if tile == 8:
            s = (s + 2) >> 2
        else:
            dc_t = t[..., 0, 0].abs()
            s = ((s - dc_t + (dc_t >> 2)) + 1) >> 1
        out[c0:c1] = s.sum(dim=(2, 3), dtype=torch.int32)
    return out


_TABLES: dict = {}


def _device_tables(w: int, dev: torch.device):
    """(row_start [67, w], filt [2, 67, w, 4], transposed [67]) int32 on
    dev, uploaded once per (size, device); filt[0] holds the taps, filt[1]
    the bits of the same taps as float32 (K11's float route)."""
    key = (w, str(dev))
    t = _TABLES.get(key)
    if t is None:
        _, _, row_start, filt, transposed, _ = _mode_tables(w, w)
        filt2 = np.stack([filt.astype(np.int32),
                          filt.astype(np.float32).view(np.int32)])
        t = _TABLES[key] = tuple(
            torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
            for a in (row_start, filt2, transposed))
    return t


_P, _I = ctypes.c_void_p, ctypes.c_int
_K11_ARGS = [_P, _P, _P, _I, _P, _I, _P, ctypes.c_longlong, _I, _I, _I, _P,
             _P, _P, _P]


def mode_costs_batch(src: torch.Tensor, rm: torch.Tensor, tops: torch.Tensor,
                     lefts: torch.Tensor, w: int, h: int,
                     bit_depth: int = 10) -> torch.Tensor:
    """SATD cost of every intra mode for a batch of blocks.

    src: [B, H, W] int32 source samples (internal bit depth)
    rm:  [B, M, L] per-mode extended main refs (host-built)
    tops/lefts: [B, 2w+3] / [B, 2h+3] raw refs for planar/DC
    returns costs [B, M] int32 (SATD, no PDPC, no mode-bit term).  K11 on
    a CUDA device, the plain version on the CPU; at bit_depth <= 10 K11
    runs its float32 route, exact for samples in 0 .. 2^bit_depth - 1."""
    if all(t.device.type == "cpu" for t in (src, rm, tops, lefts)):
        return mode_costs_batch_ref(src, rm, tops, lefts, w, h, bit_depth)
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"mode_costs_batch: no kernel for {dev}")
    kernels.require(src, "src", torch.int32, 3, dev)
    kernels.require(rm, "rm", torch.int32, 3, dev)
    kernels.require(tops, "tops", torch.int32, 2, dev)
    kernels.require(lefts, "lefts", torch.int32, 2, dev)
    ref_len = _check_inputs(src, rm, tops, lefts, w, h)
    B = src.shape[0]
    out = torch.empty((B, NUM_MODES), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    row_start, filt, transposed = _device_tables(w, dev)
    fn = kernels.function("mode_costs", "vt_mode_costs", _K11_ARGS)
    err = fn(src.data_ptr(), rm.data_ptr(), tops.data_ptr(), tops.shape[1],
             lefts.data_ptr(), lefts.shape[1], out.data_ptr(), B, ref_len, w,
             bit_depth, row_start.data_ptr(), filt.data_ptr(),
             transposed.data_ptr(), kernels.stream_ptr(out))
    kernels.check("mode_costs", err)
    kernels.count("mode_costs")
    return out

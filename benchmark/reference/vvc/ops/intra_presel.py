"""Batched intra prediction of all 67 modes + Hadamard SATD on the card.

The device stage shared by the RD planning (ops/intra_plan.py): for a
batch of candidate blocks whose reference rows/columns come from SOURCE
samples (which decouples the ranking from the reconstruction order and so
makes frame-level batching legal; the native searcher re-predicts the
chosen candidates from the true references, so the bitstream stays
exact), predict every intra mode and cost it against the source block.

  predict_all_modes  -> K1, csrc/intra_pred_all.cu
  satd_batch         -> K2, csrc/satd_modes.cu
  presel_costs_plane -> K4, csrc/presel_costs.cu: K1 and K2 fused for
                        the frame-level preselection (FramePresel), read
                        straight from the padded source plane
  presel_costs       -> K4's second entry: the same on the reference's
                        gathered inputs (device planning's 67-mode SATD,
                        ops/intra_plan._plan_class_core; the mesh path;
                        graft_entry)

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
PyTorch version (`*_ref`, a transcription of the JAX reference) for CPU
tensors.  All static per-(w, h) control flow comes from
ops/intra_vec._shape_tables, the tables the bit-exact host path gathers
with.

The reference pool is [tops, ftop, lefts, fleft] and is read at
segment * LPAD + index with LPAD = max(2w, 2h) + 3.  The frame-level
preselection gathers its references 2w+3 / 2h+3 wide, so on a
rectangular class the segments are narrower than LPAD and the reads past
the first land elsewhere in the pool, and reads past its end read its
last entry (XLA clamps gather indices).  The reference does this, and the
port reproduces it (ROADMAP.md section 3).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import intra as I
from . import kernels
from .intra_vec import _shape_tables
from .rdcost import _hadamard
from .tables import device_tables, presel_device_tables

NUM_MODES = I.NUM_LUMA_MODE  # 67

_P, _I = ctypes.c_void_p, ctypes.c_int


def _filter_refs(tops, lefts, w, h):
    """[1 2 1]/4 reference smoothing (I.filter_reference), int32."""
    corner = (tops[:, 0] + tops[:, 1] + lefts[:, 0] + lefts[:, 1] + 2) >> 2
    n = 2 * w  # top pred size (arrays carry +3 padding)
    ft = tops.clone()
    ft[:, 1:n] = (tops[:, :n - 1] + 2 * tops[:, 1:n] + tops[:, 2:n + 1]
                  + 2) >> 2
    ft[:, 0] = corner
    ft[:, n:] = tops[:, n:n + 1]
    m = 2 * h
    fl = lefts.clone()
    fl[:, 1:m] = (lefts[:, :m - 1] + 2 * lefts[:, 1:m] + lefts[:, 2:m + 1]
                  + 2) >> 2
    fl[:, 0] = corner
    fl[:, m:] = lefts[:, m:m + 1]
    return ft, fl


def _pdpc_planar_dc(pred, top, left, w, h):
    dev = pred.device
    scale = (((w * h).bit_length() - 1) - 2) >> 2
    y = torch.arange(h, dtype=torch.int32, device=dev)
    x = torch.arange(w, dtype=torch.int32, device=dev)
    wt = (32 >> torch.clamp((y << 1) >> scale, max=31))[None, :, None]
    wl = (32 >> torch.clamp((x << 1) >> scale, max=31))[None, None, :]
    lc = left[:, 1:h + 1][:, :, None]
    tp = top[:, 1:w + 1][:, None, :]
    return pred + ((wl * (lc - pred) + wt * (tp - pred) + 32) >> 6)


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def predict_all_modes_ref(tops: torch.Tensor, lefts: torch.Tensor, w: int,
                          h: int, bit_depth: int = 10) -> torch.Tensor:
    """Plain PyTorch version of predict_all_modes (the JAX reference's
    arithmetic, op for op): int32 tops [B, >=2w+3] / lefts [B, >=2h+3] ->
    [B, 67, h, w] int16.  References narrower than LPAD are read as the
    reference reads them (module docstring)."""
    t = _shape_tables(w, h, True, 0)
    dev = tops.device
    maxval = (1 << bit_depth) - 1
    LPAD = t.LPAD
    tops = tops[:, :LPAD].to(torch.int32)
    lefts = lefts[:, :LPAD].to(torch.int32)
    B = tops.shape[0]
    ftop, fleft = _filter_refs(tops, lefts, w, h)
    # int16 reference pool, [B, 4*LPAD] when the references are LPAD wide
    flat = torch.cat([tops, ftop, lefts, fleft], dim=1).to(torch.int16)
    last = flat.shape[1] - 1          # reads past the end clamp to it
    rm_flat = np.minimum(t.rm_src.astype(np.int64) * LPAD + t.rm_idx,
                         last)                                  # [65, LR]

    preds = torch.empty((B, NUM_MODES, h, w), dtype=torch.int16, device=dev)
    for group, (tw, th) in ((True, (w, h)), (False, (h, w))):
        gsel = np.nonzero(t.is_ver == group)[0]
        if len(gsel) == 0:
            continue
        ng = len(gsel)
        rs = t.row_start[gsel][:, :th]                        # [ng, th]
        filt = _t(t.filt[gsel][:, :th], dev)                  # [ng, th, 4]
        widx = rm_flat[gsel][
            np.arange(ng)[:, None, None],
            rs[:, :, None] + np.arange(tw + 3, dtype=np.int32)[None, None]]
        win = flat[:, _t(widx, dev)]                          # [B,ng,th,tw+3]
        acc = None
        for k in range(4):
            term = filt[None, :, :, None, k] * win[..., k:k + tw].to(
                torch.int32)
            acc = term if acc is None else acc + term
        pred = (acc + _t(t.round[gsel], dev)[None, :, None, None]) >> \
            _t(t.shift[gsel], dev)[None, :, None, None]
        pred = torch.clamp(pred, 0, maxval)
        # PDPC on its support slab (first <= 12 columns)
        pd = t.pdpc_on[gsel]
        if pd.any():
            pw = min(int(t.pdpc_wl[gsel].astype(bool).sum(axis=1).max()), tw)
            side_flat = np.minimum(
                t.pdpc_side_src[gsel].astype(np.int64)[:, None, None] * LPAD
                + t.pdpc_side_idx[gsel][:, :th, :pw], last)
            lval = flat[:, _t(side_flat, dev)].to(torch.int32)
            wl = _t(t.pdpc_wl[gsel][:, :pw], dev)[None, :, None, :]
            a0 = t.pdpc_ang0[gsel]
            p12 = pred[..., :pw]
            reg_m = _t(pd & ~a0, dev)[None, :, None, None]
            upd_reg = p12 + ((wl * (lval - p12) + 32) >> 6)
            p12 = torch.where(reg_m, upd_reg, p12)
            if a0.any():
                tl = flat[:, _t(rm_flat[gsel, t.B0], dev)].to(torch.int32)
                tl = tl[:, :, None, None]
                upd0 = torch.clamp(p12 + ((wl * (lval - tl) + 32) >> 6),
                                   0, maxval)
                a0_m = _t(pd & a0, dev)[None, :, None, None] & (wl != 0)
                p12 = torch.where(a0_m, upd0, p12)
            pred = torch.cat([p12, pred[..., pw:]], dim=-1)
        pred = torch.clamp(pred, 0, maxval).to(torch.int16)
        if not group:
            pred = pred.transpose(2, 3)
        preds[:, _t(gsel + 2, dev)] = pred

    # planar (mirrors I._pred_planar + planar/DC PDPC)
    log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
    pf = (w * h > 32)  # planar MDIS
    p_top, p_left = (ftop, fleft) if pf else (tops, lefts)
    top_row = p_top[:, 1:w + 2]
    left_col = p_left[:, 1:h + 2]
    br = left_col[:, h][:, None, None]
    tr = top_row[:, w][:, None, None]
    xg = torch.arange(w, dtype=torch.int32, device=dev)[None, None, :]
    yg = torch.arange(h, dtype=torch.int32, device=dev)[None, :, None]
    lc = left_col[:, :h, None]
    tr_row = top_row[:, None, :w]
    hor = (lc << log2w) + (xg + 1) * (tr - lc)
    ver = (tr_row << log2h) + (yg + 1) * (br - tr_row)
    planar = ((hor << log2h) + (ver << log2w) + (1 << (log2w + log2h))) \
        >> (1 + log2w + log2h)
    if w >= 4 and h >= 4:
        planar = _pdpc_planar_dc(planar, p_top, p_left, w, h)
    preds[:, I.PLANAR_IDX] = torch.clamp(planar, 0, maxval).to(torch.int16)

    # DC (non-square: average of the longer side only)
    denom = (w << 1) if w == h else max(w, h)
    shift_dc = denom.bit_length() - 1
    s = torch.zeros((B,), dtype=torch.int32, device=dev)
    if w >= h:
        s = s + tops[:, 1:1 + w].sum(dim=1, dtype=torch.int32)
    if w <= h:
        s = s + lefts[:, 1:1 + h].sum(dim=1, dtype=torch.int32)
    dc = (s + (denom >> 1)) >> shift_dc
    dcp = dc[:, None, None].expand(B, h, w)
    if w >= 4 and h >= 4:
        dcp = _pdpc_planar_dc(dcp, tops, lefts, w, h)
    preds[:, I.DC_IDX] = torch.clamp(dcp, 0, maxval).to(torch.int16)
    return preds


_K1_ARGS = [_P, _I, _P, _I, _P, _I, _I, _I, _I,
            _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]


def predict_all_modes(tops: torch.Tensor, lefts: torch.Tensor, w: int,
                      h: int, bit_depth: int = 10) -> torch.Tensor:
    """All 67 intra predictions for a batch of reference rows/columns:
    int32 tops [B, >=LPAD], lefts [B, >=LPAD] (LPAD = max(2w, 2h) + 3) ->
    [B, 67, h, w] int16 in mode order.  K1 on a CUDA device, the plain
    version on the CPU."""
    if tops.device.type == "cpu" and lefts.device.type == "cpu":
        return predict_all_modes_ref(tops, lefts, w, h, bit_depth)
    dev = tops.device
    if dev.type != "cuda":
        raise ValueError(f"predict_all_modes: no kernel for {dev}")
    t = device_tables(w, h, dev)
    kernels.require(tops, "tops", torch.int32, 2, dev)
    kernels.require(lefts, "lefts", torch.int32, 2, dev)
    B = tops.shape[0]
    if lefts.shape[0] != B or min(tops.shape[1], lefts.shape[1]) < t["LPAD"]:
        raise ValueError(f"tops {tuple(tops.shape)} / lefts "
                         f"{tuple(lefts.shape)}: need [B, >={t['LPAD']}]")
    if not (w in (4, 8, 16, 32, 64) and h in (4, 8, 16, 32, 64)):
        raise ValueError(f"block {w}x{h}: sides must be 4..64")
    out = torch.empty((B, NUM_MODES, h, w), dtype=torch.int16, device=dev)
    if B == 0:
        return out
    fn = kernels.function("intra_pred_all", "vt_intra_pred_all", _K1_ARGS)
    err = fn(tops.data_ptr(), tops.shape[1], lefts.data_ptr(),
             lefts.shape[1], out.data_ptr(), B, w, h, bit_depth,
             t["rm_flat"].data_ptr(), t["row_start"].data_ptr(),
             t["filt"].data_ptr(), t["mode_info"].data_ptr(),
             t["pdpc_wl"].data_ptr(), t["side_flat"].data_ptr(),
             t["LPAD"], t["LR"], t["TM"], t["B0"], kernels.stream_ptr(out))
    kernels.check("intra_pred_all", err)
    kernels.count("intra_pred_all")
    return out


def satd_batch_ref(src_blocks: torch.Tensor, preds: torch.Tensor, w: int,
                   h: int) -> torch.Tensor:
    """Plain PyTorch version of satd_batch: the same 8x8 (4x4 when w or h
    is not a multiple of 8) Hadamard tiles as the JAX reference, with the
    matrix products written as integer multiply-and-sum over the
    contraction index (exact; the reference's f32 matmuls are exact too,
    every intermediate being < 2^24)."""
    B, M = preds.shape[0], preds.shape[1]
    tile = 8 if (w % 8 == 0 and h % 8 == 0) else 4
    hm = _t(_hadamard(tile).astype(np.int32), preds.device)
    d = (src_blocks[:, None, :, :].to(torch.int16) - preds).to(torch.int32)
    d = d.reshape(-1, tile, w)                             # rows of tiles
    t1 = sum(hm[None, :, j, None] * d[:, None, j, :] for j in range(tile))
    t1 = t1.reshape(-1, tile, w // tile, tile)
    t2 = sum(t1[..., k, None] * hm[k][None, None, None, :]
             for k in range(tile))
    s = t2.abs().sum(dim=(1, 3), dtype=torch.int32)       # [N, w/t]
    if tile == 8:
        s = (s + 2) >> 2
    else:
        dc_t = t2[:, 0, :, 0].abs()
        s = ((s - dc_t + (dc_t >> 2)) + 1) >> 1
    return s.reshape(B, M, -1).sum(dim=2, dtype=torch.int32)


_K2_ARGS = [_P, _P, _P, ctypes.c_longlong, _I, _I, _I, _P]


def satd_batch(src_blocks: torch.Tensor, preds: torch.Tensor, w: int,
               h: int) -> torch.Tensor:
    """vvenc-convention SATD of src [B, h, w] int32 vs preds [B, M, h, w]
    int16 -> [B, M] int32.  K2 on a CUDA device, the plain version on the
    CPU."""
    if src_blocks.device.type == "cpu" and preds.device.type == "cpu":
        return satd_batch_ref(src_blocks, preds, w, h)
    dev = preds.device
    if dev.type != "cuda":
        raise ValueError(f"satd_batch: no kernel for {dev}")
    kernels.require(src_blocks, "src_blocks", torch.int32, 3, dev)
    kernels.require(preds, "preds", torch.int16, 4, dev)
    B, M = preds.shape[0], preds.shape[1]
    if tuple(src_blocks.shape) != (B, h, w) or \
            tuple(preds.shape[2:]) != (h, w) or w % 4 or h % 4:
        raise ValueError(f"src {tuple(src_blocks.shape)} / preds "
                         f"{tuple(preds.shape)} do not match {w}x{h}")
    out = torch.empty((B, M), dtype=torch.int32, device=dev)
    if B * M == 0:
        return out
    fn = kernels.function("satd_modes", "vt_satd_modes", _K2_ARGS)
    err = fn(src_blocks.data_ptr(), preds.data_ptr(), out.data_ptr(), B * M,
             M, w, h, kernels.stream_ptr(out))
    kernels.check("satd_modes", err)
    kernels.count("satd_modes")
    return out


# ---------------------------------------------------------------------------
# host helpers: candidate grids
# ---------------------------------------------------------------------------

def _class_grid(W, H, w, h, mtt: bool = True):
    """Candidate block positions of one size class.

    mtt=True: 4-pel-aligned sub-grid (covers every position nested
    BT/TT can produce).  mtt=False (QT-only partitioning, the
    faster/firstpass presets): blocks of size (w, h) only ever occur at
    size-aligned positions — 16x fewer candidates per class."""
    ax = w if not mtt else max(4, w // 4)
    ay = h if not mtt else max(4, h // 4)
    xs = np.arange(0, W - w + 1, ax, dtype=np.int32)
    ys = np.arange(0, H - h + 1, ay, dtype=np.int32)
    return xs, ys, ax, ay


# ---------------------------------------------------------------------------
# frame-level preselection: 67-mode SATD costs of every candidate block
# ---------------------------------------------------------------------------

def shapes_for_config(ctu_size: int, max_mtt_depth_i: int):
    """(shapes, mtt) — size classes the intra partitioner can visit (max
    TB 64; MTT adds the rectangular classes, aspect ratio capped at 8
    per VVC); mtt tells the grid whether sub-size-aligned positions are
    reachable."""
    sizes = [s for s in (4, 8, 16, 32, 64) if s <= min(ctu_size, 64)]
    shapes = [(s, s) for s in sizes]
    if max_mtt_depth_i > 0:
        for w in sizes:
            for h in sizes:
                if w != h and max(w, h) // min(w, h) <= 8:
                    shapes.append((w, h))
    return shapes, max_mtt_depth_i > 0


def _class_chunk(w: int, h: int) -> int:
    """Candidates per step of the plain version: bounds its [B, 67, h, w]
    prediction intermediate to about 512 MB (the reference's chunk)."""
    return max(64, (1 << 29) // (NUM_MODES * 4 * w * h))


def presel_costs_ref(src_blocks: torch.Tensor, tops: torch.Tensor,
                     lefts: torch.Tensor, w: int, h: int,
                     bit_depth: int = 10) -> torch.Tensor:
    """Plain PyTorch version of the reference's presel_costs: SATD cost
    of all 67 intra modes for a batch of blocks, K1's and K2's plain
    versions in sequence, _class_chunk candidates at a time.

    src_blocks: [B, h, w] int32; tops: [B, >=2w+3]; lefts: [B, >=2h+3]
    -> costs [B, 67] int32."""
    B = src_blocks.shape[0]
    out = torch.empty((B, NUM_MODES), dtype=torch.int32,
                      device=src_blocks.device)
    step = _class_chunk(w, h)
    for c0 in range(0, B, step):
        c1 = min(c0 + step, B)
        preds = predict_all_modes_ref(tops[c0:c1], lefts[c0:c1], w, h,
                                      bit_depth)
        out[c0:c1] = satd_batch_ref(src_blocks[c0:c1], preds, w, h)
    return out


def plane_inputs(plane: torch.Tensor, pad: int, xs, ys, w: int, h: int):
    """The reference's presel_costs inputs for the grid (xs, ys) of an
    edge-padded source plane: (blocks [B, h, w], tops [B, 2w+3], lefts
    [B, 2h+3]) int32, B = len(ys) * len(xs) in row-major grid order."""
    sp = plane.to(torch.int32)
    xs = torch.as_tensor(xs, device=sp.device).long()
    ys = torch.as_tensor(ys, device=sp.device).long()
    by = ys[:, None].expand(len(ys), len(xs)).reshape(-1) + pad
    bx = xs[None, :].expand(len(ys), len(xs)).reshape(-1) + pad
    jt = torch.arange(2 * w + 3, device=sp.device)
    jl = torch.arange(2 * h + 3, device=sp.device)
    tops = sp[(by - 1)[:, None], (bx - 1)[:, None] + jt[None, :]]
    lefts = sp[(by - 1)[:, None] + jl[None, :], (bx - 1)[:, None]]
    iy = torch.arange(h, device=sp.device)
    ix = torch.arange(w, device=sp.device)
    blocks = sp[(by[:, None] + iy[None, :])[:, :, None],
                (bx[:, None] + ix[None, :])[:, None, :]]
    return blocks, tops, lefts


_K4G_ARGS = [_P, _P, _I, _P, _I, ctypes.c_longlong, _P, _I, _I, _I, _I, _I,
             _P, _P, _P, _P, _P, _P, _I, _P]


def _k4_tables(t: dict) -> tuple:
    """K4's per-mode table arguments (ops/tables.presel_device_tables)."""
    return (t["gidx"].data_ptr(), t["rs"].data_ptr(), t["taps"].data_ptr(),
            t["wl"].data_ptr(), t["soff"].data_ptr(), t["minfo"].data_ptr(),
            t["LM"])


def presel_costs(src_blocks: torch.Tensor, tops: torch.Tensor,
                 lefts: torch.Tensor, w: int, h: int,
                 bit_depth: int = 10) -> torch.Tensor:
    """The reference's presel_costs: SATD cost of all 67 intra modes for
    a batch of blocks, src_blocks [B, h, w], tops [B, >=2w+3], lefts
    [B, >=2h+3], all int32 -> [B, 67] int32.  K4 (its gathered entry) on
    a CUDA device, presel_costs_ref on the CPU."""
    if all(x.device.type == "cpu" for x in (src_blocks, tops, lefts)):
        return presel_costs_ref(src_blocks, tops, lefts, w, h, bit_depth)
    dev = src_blocks.device
    if dev.type != "cuda":
        raise ValueError(f"presel_costs: no kernel for {dev}")
    kernels.require(src_blocks, "src_blocks", torch.int32, 3, dev)
    kernels.require(tops, "tops", torch.int32, 2, dev)
    kernels.require(lefts, "lefts", torch.int32, 2, dev)
    if not (w in (4, 8, 16, 32, 64) and h in (4, 8, 16, 32, 64)):
        raise ValueError(f"block {w}x{h}: sides must be 4..64")
    B = src_blocks.shape[0]
    if tuple(src_blocks.shape[1:]) != (h, w) or tops.shape[0] != B or \
            lefts.shape[0] != B or tops.shape[1] < 2 * w + 3 or \
            lefts.shape[1] < 2 * h + 3:
        raise ValueError(f"src {tuple(src_blocks.shape)} / tops "
                         f"{tuple(tops.shape)} / lefts {tuple(lefts.shape)}"
                         f": need [B, {h}, {w}], [B, >={2 * w + 3}], "
                         f"[B, >={2 * h + 3}]")
    out = torch.empty((B, NUM_MODES), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    # the pool's segments: the references cut to LPAD, as the reference
    # cuts them (predict_all_modes_ref)
    lpad = _shape_tables(w, h, True, 0).LPAD
    nA, nL = min(tops.shape[1], lpad), min(lefts.shape[1], lpad)
    t = presel_device_tables(w, h, nA, nL, dev)
    fn = kernels.function("presel_costs", "vt_presel_costs_gathered",
                          _K4G_ARGS)
    err = fn(src_blocks.data_ptr(), tops.data_ptr(), tops.shape[1],
             lefts.data_ptr(), lefts.shape[1], B, out.data_ptr(), w, h,
             bit_depth, nA, nL, *_k4_tables(t), kernels.stream_ptr(out))
    kernels.check("presel_costs", err)
    kernels.count("presel_costs_gathered")
    return out


_K4_ARGS = [_P, ctypes.c_longlong, _I, _P, _I, _P, _I, _P, _I, _I, _I,
            _P, _P, _P, _P, _P, _P, _I, _P]


def presel_costs_plane(plane: torch.Tensor, pad: int, xs: torch.Tensor,
                       ys: torch.Tensor, w: int, h: int,
                       bit_depth: int = 10,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """67-mode SATD costs of every candidate block (xs[i % nx],
    ys[i // nx]) of one (w, h) class, read from the int16 source plane
    edge-padded by `pad` -> [ny*nx, 67] int32 (into `out` when given).
    Every grid position must lie in the picture (0 <= x <= W - w).
    Equals presel_costs_ref on the reference's inputs (plane_inputs).
    K4 on a CUDA device; on the CPU the plain version on plane_inputs."""
    nx, ny = len(xs), len(ys)
    if plane.device.type == "cpu":
        res = presel_costs_ref(*plane_inputs(plane, pad, xs, ys, w, h),
                               w, h, bit_depth)
        if out is None:
            return res
        out.copy_(res)
        return out
    dev = plane.device
    if dev.type != "cuda":
        raise ValueError(f"presel_costs_plane: no kernel for {dev}")
    kernels.require(plane, "plane", torch.int16, 2, dev)
    kernels.require(xs, "xs", torch.int32, 1, dev)
    kernels.require(ys, "ys", torch.int32, 1, dev)
    if not (w in (4, 8, 16, 32, 64) and h in (4, 8, 16, 32, 64)):
        raise ValueError(f"block {w}x{h}: sides must be 4..64")
    if pad < max(w, h) + 2:
        raise ValueError(f"pad {pad}: the {w}x{h} references reach "
                         f"{max(w, h) + 2} samples past the picture")
    if plane.data_ptr() % 4:
        raise ValueError("plane: the kernel copies int16 pairs, so its "
                         "base must be 4-byte aligned")
    if out is None:
        out = torch.empty((nx * ny, NUM_MODES), dtype=torch.int32,
                          device=dev)
    kernels.require(out, "out", torch.int32, 2, dev)
    if tuple(out.shape) != (nx * ny, NUM_MODES):
        raise ValueError(f"out {tuple(out.shape)}: need "
                         f"({nx * ny}, {NUM_MODES})")
    if nx * ny == 0:
        return out
    t = presel_device_tables(w, h, 2 * w + 3, 2 * h + 3, dev)
    fn = kernels.function("presel_costs", "vt_presel_costs", _K4_ARGS)
    err = fn(plane.data_ptr(), plane.shape[1], pad, xs.data_ptr(), nx,
             ys.data_ptr(), ny, out.data_ptr(), w, h, bit_depth,
             *_k4_tables(t), kernels.stream_ptr(out))
    kernels.check("presel_costs", err)
    kernels.count("presel_costs")
    return out


# optional device mesh (parallel.mesh.Mesh): when set, FramePresel runs
# every class through parallel.mesh.sharded_presel_costs on the
# reference's gathered inputs; the tables are the same for any mesh shape
# (chip-count invariance).  Read at call time.
MESH = None


class FramePresel:
    """Per-frame device-computed intra preselection cost tables.

    The source plane goes to the device once; every class is launched
    into one device buffer before the one fetch (with MESH set, each
    class is gathered, sharded over the mesh and collected into that
    buffer).

    lookup(x, y, w, h) -> int32 costs[67] or None (position not in the
    class grid — caller falls back to the exact host sweep)."""

    PAD = 80

    def __init__(self, src_y: np.ndarray, bit_depth: int, shapes,
                 device="cuda"):
        from ..device import resolve_device
        from ..utils.devclock import DEV
        self.device = resolve_device(device)
        with DEV.section():
            self._build(src_y, bit_depth, shapes)

    def _build(self, src_y: np.ndarray, bit_depth: int, shapes):
        from ..utils.profiler import PROF
        H, W = src_y.shape
        if isinstance(shapes, tuple):
            shapes, mtt = shapes
        else:
            mtt = True
        dev = self.device
        pad = self.PAD
        plane = torch.from_numpy(
            np.pad(src_y, pad, mode="edge").astype(np.int16)).to(dev)
        grids = []
        for (w, h) in shapes:
            if w > W or h > H:
                continue
            xs, ys, ax, ay = _class_grid(W, H, w, h, mtt)
            grids.append(((w, h), xs, ys, ax, ay))
        total = sum(len(g[1]) * len(g[2]) for g in grids)
        costs_d = torch.empty((total, NUM_MODES), dtype=torch.int32,
                              device=dev)
        mesh = MESH
        if mesh is not None:
            from ..parallel.mesh import check_mesh_device, sharded_presel_costs
            check_mesh_device(mesh, dev)
        off = 0
        for (w, h), xs, ys, _ax, _ay in grids:
            n = len(xs) * len(ys)
            if mesh is not None:
                costs, _tot = sharded_presel_costs(
                    mesh, *plane_inputs(plane, pad, xs, ys, w, h), w=w, h=h,
                    bit_depth=bit_depth)
                costs_d[off:off + n].copy_(costs)
            else:
                presel_costs_plane(plane, pad, torch.from_numpy(xs).to(dev),
                                   torch.from_numpy(ys).to(dev), w, h,
                                   bit_depth, out=costs_d[off:off + n])
            off += n
        with PROF.section("device.frame_presel.fetch"):
            # one fetch, which waits for every class's launch; on the card
            # into pinned memory (PyTorch caches the pinned block for the
            # next picture), several times faster than a pageable copy
            if dev.type == "cuda":
                host = torch.empty(costs_d.shape, dtype=costs_d.dtype,
                                   pin_memory=True)
                host.copy_(costs_d, non_blocking=True)
                torch.cuda.current_stream(dev).synchronize()
                costs = host.numpy()
            else:
                costs = costs_d.numpy()
        self.tables = {}
        off = 0
        for (w, h), xs, ys, ax, ay in grids:
            n = len(xs) * len(ys)
            self.tables[(w, h)] = (xs, ys, ax, ay, len(xs),
                                   costs[off:off + n])
            off += n

    def lookup(self, x, y, w, h):
        ent = self.tables.get((w, h))
        if ent is None:
            return None
        xs, ys, ax, ay, nx, costs = ent
        if x % ax or y % ay:
            return None
        ix, iy = x // ax, y // ay
        if ix >= nx or iy >= len(ys):
            return None
        return costs[iy * nx + ix]

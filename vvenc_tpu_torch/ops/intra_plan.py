"""Device-batched intra RD planning: the GPU decides the coding tree.

The SURVEY §7 "batch everything" inversion of the sequential EncCu
recursion (reference anchor: EncCu.cpp:717 xCompressCU +
IntraSearch.cpp estIntraPredLumaQT): for every partition size class, the
card evaluates ALL candidate CUs of a batch of frames —

  the 67-mode SATD: prediction and Hadamard SATD of every mode, fused
     (ops/intra_presel.presel_costs, K4's gathered entry,
     csrc/presel_costs.cu; the reference's predict_all_modes then
     satd_batch, with no [B, 67, h, w] prediction buffer)
  K3 top-K mode selection, the K survivors' predictions from the
     references, then a full trial of each (forward transform with the
     implicit-MTS type, scalar quantization, dequant, inverse, clipped
     reconstruction, SSE) + rate proxy -> RD cost per (block, mode)
     (plan_trial_refs, csrc/plan_trial.cu)

The host then runs the (tiny) quadtree dynamic program over the per-class
leaf costs to pick the split tree, and hands the native CTU driver a
*plan*: forced split decisions + a 2-mode shortlist per leaf.  The native
driver (entropy.cpp vte_search_ctu) codes the planned tree with exact
reconstruction references, exact RDOQ and exact CABAC estimation, so the
bitstream stays fully conformant and closed-loop; only the tree/mode
*selection* uses device-approximate costs (same trade vvenc's
EncModeCtrl save/load heuristics make, EncModeCtrl.h:268).

Prediction references come from SOURCE samples (see ops/intra_presel.py
for why that is what makes frame-level batching legal).

Rate proxy: bits(TU) ~ c0 + c1*nnz + c2*sum(log2(1+|level|)), fitted
against the exact estimator path; good enough to rank split decisions —
mode ranking is dominated by SATD/SSE.
"""

from __future__ import annotations

import ctypes
import os as _os
from functools import lru_cache

import numpy as np
import torch

from . import intra as I
from . import kernels
from .intra_presel import (NUM_MODES, _class_chunk, _class_grid,
                           predict_all_modes, predict_all_modes_ref,
                           presel_costs, satd_batch)
from .tables import device_tables
from .transforms import (DCT2, DST7, _dequant_params, _fwd_tr_ref,
                         _inv_tr_ref, _quant_params, dequant_batch_ref,
                         quant_batch_ref)

# rate-proxy coefficients (frac bits), env-overridable for calibration
# sweeps (the same variables as the JAX package)
RATE_C0 = float(_os.environ.get("VVENC_TPU_PLAN_C0", "3.0"))
RATE_C1 = float(_os.environ.get("VVENC_TPU_PLAN_C1", "1.0"))
RATE_C2 = float(_os.environ.get("VVENC_TPU_PLAN_C2", "1.4"))
SPLIT_BITS = float(_os.environ.get("VVENC_TPU_PLAN_SPLIT", "6.0"))
PLAN_K = int(_os.environ.get("VVENC_TPU_PLAN_K", "2"))
# exact-retrial margin: the native driver re-trials the 2nd shortlist
# mode only when its device cost is within MARGIN of the best (vvenc
# numIntraModesFullRD=1 analog, vvencCfg.cpp:2689 — most blocks get one
# exact trial)
PLAN_MARGIN = float(_os.environ.get("VVENC_TPU_PLAN_MARGIN", "1.06"))

# approximate luma mode-signalling bits used for top-K selection
# (MPM list is context-dependent and unknown on device: planar is almost
# always MPM[0]; angular/DC average between MPM hits and the 6-bit
# truncated-binary escape)
_MODE_BITS = np.full(NUM_MODES, 5.5, np.float32)
_MODE_BITS[I.PLANAR_IDX] = 1.5
_MODE_BITS[I.DC_IDX] = 4.5


def _trial_params(w, h, qp, bit_depth, implicit_mts):
    """Static integer parameters of one class's trial (as the reference's
    _plan_class_core derives them)."""
    trh = DST7 if (implicit_mts and 4 <= w <= 16) else DCT2
    trv = DST7 if (implicit_mts and 4 <= h <= 16) else DCT2
    qscale, qadd, qbits = _quant_params(w, h, qp, bit_depth, True)
    dscale, dshift = _dequant_params(w, h, qp, bit_depth)
    return dict(
        trh=trh, trv=trv,
        shift1=(w.bit_length() - 1) + bit_depth + 6 - 15,
        shift2=(h.bit_length() - 1) + 6,
        ishift2=20 - bit_depth,
        qbits=qbits, qscale=qscale, qadd=qadd, dshift=dshift, dscale=dscale,
        maxval=(1 << bit_depth) - 1)


def plan_trial_ref(src_blocks, preds, satd, lmbda, lmbda_sad, w: int,
                   h: int, qp: int, bit_depth: int = 10,
                   implicit_mts: bool = True, k: int = 2):
    """Plain PyTorch version of plan_trial: the reference's
    _plan_class_core after the SATD, op for op.  Top-k takes the lowest
    mode index on ties (jax.lax.top_k), hence a stable sort."""
    p = _trial_params(w, h, qp, bit_depth, implicit_mts)
    dev = preds.device
    B = preds.shape[0]
    mode_bits_t = torch.from_numpy(_MODE_BITS.copy()).to(dev)
    bias = mode_bits_t[None, :] * lmbda_sad[:, None]
    scores = satd.to(torch.float32) + bias
    top_idx = torch.sort(scores, dim=1, stable=True).indices[:, :k]
    costs = []
    for i in range(k):
        sel = top_idx[:, i].view(B, 1, 1, 1).expand(B, 1, h, w)
        pred = preds.gather(1, sel)[:, 0].to(torch.int32)  # [B, h, w]
        resi = src_blocks - pred
        coeff = _fwd_tr_ref(resi, w, h, p["trh"], p["trv"], bit_depth)
        q = quant_batch_ref(coeff, w, h, qp, bit_depth)
        mag = q.abs()
        d = dequant_batch_ref(q, w, h, qp, bit_depth)
        r = _inv_tr_ref(d, w, h, p["trh"], p["trv"], bit_depth)
        rec = torch.clamp(pred + r, 0, p["maxval"])
        err = (src_blocks - rec).to(torch.float32)
        sse = (err * err).sum(dim=(1, 2))
        nnz = (q != 0).to(torch.float32).sum(dim=(1, 2))
        slog = torch.log2(1.0 + mag.to(torch.float32)).sum(dim=(1, 2))
        bits = torch.where(nnz > 0, RATE_C0 + RATE_C1 * nnz + RATE_C2 * slog,
                           1.0)
        costs.append(sse + lmbda * (bits + mode_bits_t[top_idx[:, i]]))
    return top_idx.to(torch.int32), torch.stack(costs, dim=1)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_K3_ARGS = ([_P] * 10 + [_I] * 14 + [_F] * 3 + [_P])


def plan_trial(src_blocks, preds, satd, lmbda, lmbda_sad, w: int, h: int,
               qp: int, bit_depth: int = 10, implicit_mts: bool = True,
               k: int = 2):
    """Top-k modes by SATD + mode-bit bias, then a transform/quant trial
    of each survivor: src [B, h, w] int32, preds [B, M, h, w] int16,
    satd [B, M] int32, lmbda / lmbda_sad [B] float32 -> modes [B, k]
    int32, costs [B, k] float32.  K3 on a CUDA device, the plain version
    on the CPU."""
    devs = {x.device.type for x in (src_blocks, preds, satd, lmbda,
                                    lmbda_sad)}
    if devs == {"cpu"}:
        return plan_trial_ref(src_blocks, preds, satd, lmbda, lmbda_sad, w,
                              h, qp, bit_depth, implicit_mts, k)
    dev = preds.device
    if dev.type != "cuda":
        raise ValueError(f"plan_trial: no kernel for {dev}")
    B, M = preds.shape[0], preds.shape[1]
    kernels.require(src_blocks, "src_blocks", torch.int32, 3, dev)
    kernels.require(preds, "preds", torch.int16, 4, dev)
    kernels.require(satd, "satd", torch.int32, 2, dev)
    kernels.require(lmbda, "lmbda", torch.float32, 1, dev)
    kernels.require(lmbda_sad, "lmbda_sad", torch.float32, 1, dev)
    if tuple(src_blocks.shape) != (B, h, w) or \
            tuple(preds.shape[2:]) != (h, w) or tuple(satd.shape) != (B, M) \
            or lmbda.shape[0] != B or lmbda_sad.shape[0] != B:
        raise ValueError("plan_trial: shapes do not match")
    if not (1 <= k <= M <= NUM_MODES) or \
            not (w in (4, 8, 16, 32, 64) and h in (4, 8, 16, 32, 64)):
        raise ValueError(f"plan_trial: k={k}, M={M}, block {w}x{h}")
    p = _trial_params(w, h, qp, bit_depth, implicit_mts)
    tab = device_tables(w, h, dev)
    tw = tab["tr"][(w, p["trh"])]
    th = tab["tr"][(h, p["trv"])]
    modes = torch.empty((B, k), dtype=torch.int32, device=dev)
    costs = torch.empty((B, k), dtype=torch.float32, device=dev)
    if B == 0:
        return modes, costs
    fn = kernels.function("plan_trial", "vt_plan_trial", _K3_ARGS)
    err = fn(src_blocks.data_ptr(), preds.data_ptr(), satd.data_ptr(),
             lmbda.data_ptr(), lmbda_sad.data_ptr(),
             tab["mode_bits"].data_ptr(), tw.data_ptr(),
             th.data_ptr(), modes.data_ptr(), costs.data_ptr(),
             B, M, w, h, k, p["shift1"], p["shift2"], p["ishift2"],
             p["qbits"], p["qscale"], p["qadd"], p["dshift"], p["dscale"],
             p["maxval"], RATE_C0, RATE_C1, RATE_C2,
             kernels.stream_ptr(costs))
    kernels.check("plan_trial", err)
    kernels.count("plan_trial")
    return modes, costs


def plan_trial_refs_ref(src_blocks, tops, lefts, satd, lmbda, lmbda_sad,
                        w: int, h: int, qp: int, bit_depth: int = 10,
                        implicit_mts: bool = True, k: int = 2):
    """Plain PyTorch version of plan_trial_refs: plan_trial_ref on the
    67 predictions of the references (predict_all_modes_ref), in steps of
    _class_chunk candidates (the rows are independent)."""
    B = src_blocks.shape[0]
    dev = src_blocks.device
    modes = torch.empty((B, k), dtype=torch.int32, device=dev)
    costs = torch.empty((B, k), dtype=torch.float32, device=dev)
    step = _class_chunk(w, h)
    for c0 in range(0, B, step):
        c1 = min(c0 + step, B)
        preds = predict_all_modes_ref(tops[c0:c1], lefts[c0:c1], w, h,
                                      bit_depth)
        modes[c0:c1], costs[c0:c1] = plan_trial_ref(
            src_blocks[c0:c1], preds, satd[c0:c1], lmbda[c0:c1],
            lmbda_sad[c0:c1], w, h, qp, bit_depth, implicit_mts, k)
    return modes, costs


_K3R_ARGS = ([_P, _P, _I, _P, _I] + [_P] * 8 + [_I] * 14 + [_F] * 3
             + [_I] + [_P] * 6 + [_I] * 4 + [_P])
# vt_plan_trial_refs_p: the parameter block, src, tops, Lt, lefts, Ll,
# satd, lmbda, lmbda_sad, modes, costs, B, stream
_K3P_ARGS = [_P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _P]
# plan_trial_refs' inputs: (name, dtype, rank)
_K3R_INPUTS = (("src_blocks", torch.int32, 3), ("tops", torch.int32, 2),
               ("lefts", torch.int32, 2), ("satd", torch.int32, 2),
               ("lmbda", torch.float32, 1), ("lmbda_sad", torch.float32, 1))


class _RefsParams(ctypes.Structure):
    """One class's constants of K3's reference entry: the parameter block
    of vt_plan_trial_refs_p (csrc/plan_trial.cu RefsParams)."""
    _fields_ = ([(n, _P) for n in ("mode_bits", "tw", "th", "rm_flat",
                                   "row_start", "filt", "mode_info",
                                   "pdpc_wl", "side_flat")]
                + [(n, _I) for n in ("M", "w", "h", "k", "shift1", "shift2",
                                     "ishift2", "qbits", "qscale", "qadd",
                                     "dshift", "dscale", "maxval")]
                + [(n, _F) for n in ("c0", "c1", "c2")]
                + [(n, _I) for n in ("bit_depth", "LPAD", "LR", "TM", "B0")])


@lru_cache(maxsize=None)
def _refs_params(dev, w, h, qp, bit_depth, implicit_mts, k, M, rates):
    """(the parameter block, its address, the class's LPAD) of one class
    on device dev; kept for the life of the process, as the device tables
    it points into."""
    t = device_tables(w, h, dev)
    p = _trial_params(w, h, qp, bit_depth, implicit_mts)
    prm = _RefsParams(
        t["mode_bits"].data_ptr(), t["tr"][(w, p["trh"])].data_ptr(),
        t["tr"][(h, p["trv"])].data_ptr(), t["rm_flat"].data_ptr(),
        t["row_start"].data_ptr(), t["filt"].data_ptr(),
        t["mode_info"].data_ptr(), t["pdpc_wl"].data_ptr(),
        t["side_flat"].data_ptr(), M, w, h, k, p["shift1"], p["shift2"],
        p["ishift2"], p["qbits"], p["qscale"], p["qadd"], p["dshift"],
        p["dscale"], p["maxval"], *rates, bit_depth, t["LPAD"], t["LR"],
        t["TM"], t["B0"])
    return prm, ctypes.addressof(prm), t["LPAD"]


def refs_launch_args(src_blocks, tops, lefts, satd, lmbda, lmbda_sad, modes,
                     costs, w: int, h: int, qp: int, bit_depth: int = 10,
                     implicit_mts: bool = True, k: int = 2) -> tuple:
    """The arguments of the C entry vt_plan_trial_refs (_K3R_ARGS, every
    constant on its own, from the class's parameter block) for
    plan_trial_refs' inputs and outputs, for a caller of that entry: the
    card tests and chip_smoke.py's comparison with an older build."""
    B, M = satd.shape
    q = _refs_params(src_blocks.device, w, h, qp, bit_depth,
                     bool(implicit_mts), k, M,
                     (RATE_C0, RATE_C1, RATE_C2))[0]
    return (src_blocks.data_ptr(), tops.data_ptr(), tops.shape[1],
            lefts.data_ptr(), lefts.shape[1], satd.data_ptr(),
            lmbda.data_ptr(), lmbda_sad.data_ptr(), q.mode_bits, q.tw, q.th,
            modes.data_ptr(), costs.data_ptr(), B, q.M, q.w, q.h, q.k,
            q.shift1, q.shift2, q.ishift2, q.qbits, q.qscale, q.qadd,
            q.dshift, q.dscale, q.maxval, q.c0, q.c1, q.c2, q.bit_depth,
            q.rm_flat, q.row_start, q.filt, q.mode_info, q.pdpc_wl,
            q.side_flat, q.LPAD, q.LR, q.TM, q.B0,
            kernels.stream_ptr(costs))


def plan_trial_refs(src_blocks, tops, lefts, satd, lmbda, lmbda_sad, w: int,
                    h: int, qp: int, bit_depth: int = 10,
                    implicit_mts: bool = True, k: int = 2):
    """plan_trial with the candidates' references in place of their 67
    predictions: src [B, h, w], tops / lefts [B, >=LPAD] (LPAD =
    max(2w, 2h) + 3), all int32, satd [B, 67] int32, lmbda / lmbda_sad
    [B] float32 -> modes [B, k] int32, costs [B, k] float32.  K3's
    reference entry (which predicts only the k survivors, with K1's
    arithmetic) on a CUDA device, the plain version on the CPU.  The
    class's constants go to the kernel as one parameter block, built once
    per (device, class, QP, bit depth, transform types, k)."""
    ins = (src_blocks, tops, lefts, satd, lmbda, lmbda_sad)
    if {x.device.type for x in ins} == {"cpu"}:
        return plan_trial_refs_ref(*ins, w, h, qp, bit_depth, implicit_mts,
                                   k)
    dev = src_blocks.device
    if dev.type != "cuda":
        raise ValueError(f"plan_trial_refs: no kernel for {dev}")
    for x, (name, dtype, ndim) in zip(ins, _K3R_INPUTS):
        if x.dtype != dtype or x.dim() != ndim or x.device != dev or \
                not x.is_contiguous():
            kernels.require(x, name, dtype, ndim, dev)     # raises
    if not (w in (4, 8, 16, 32, 64) and h in (4, 8, 16, 32, 64)):
        raise ValueError(f"plan_trial_refs: block {w}x{h}")
    B, M = satd.shape
    if not 1 <= k <= M <= NUM_MODES:
        raise ValueError(f"plan_trial_refs: k={k}, M={M}")
    _, prm, lpad = _refs_params(dev, w, h, qp, bit_depth, bool(implicit_mts),
                                k, M, (RATE_C0, RATE_C1, RATE_C2))
    if tuple(src_blocks.shape) != (B, h, w) or tops.shape[0] != B or \
            lefts.shape[0] != B or lmbda.shape[0] != B or \
            lmbda_sad.shape[0] != B or min(tops.shape[1], lefts.shape[1]) \
            < lpad:
        raise ValueError(f"plan_trial_refs: shapes do not match (src "
                         f"{tuple(src_blocks.shape)}, tops "
                         f"{tuple(tops.shape)}, lefts {tuple(lefts.shape)}"
                         f", satd {tuple(satd.shape)}; LPAD {lpad})")
    modes = torch.empty((B, k), dtype=torch.int32, device=dev)
    costs = torch.empty((B, k), dtype=torch.float32, device=dev)
    if B == 0:
        return modes, costs
    fn = kernels.function("plan_trial", "vt_plan_trial_refs_p", _K3P_ARGS)
    err = fn(prm, src_blocks.data_ptr(), tops.data_ptr(), tops.shape[1],
             lefts.data_ptr(), lefts.shape[1], satd.data_ptr(),
             lmbda.data_ptr(), lmbda_sad.data_ptr(), modes.data_ptr(),
             costs.data_ptr(), B, kernels.stream_ptr(costs))
    kernels.check("plan_trial", err)
    kernels.count("plan_trial_refs")
    return modes, costs


def _plan_class_core(src_blocks, tops, lefts, lmbda, lmbda_sad, w: int,
                     h: int, qp: int, bit_depth: int = 10,
                     implicit_mts: bool = True, k: int = 2):
    """One size class: modes [B, k] int32 + RD costs [B, k] float32.

    On a CUDA device two launches, neither of which writes the 67
    predictions: the fused 67-mode SATD (presel_costs, K4's gathered
    entry; equal to satd_batch(predict_all_modes(...)) on square classes
    with references LPAD wide) and K3's reference entry
    (plan_trial_refs).  On the CPU the plain route: predict_all_modes ->
    satd_batch -> plan_trial (their plain versions).

    lmbda / lmbda_sad: per-block float32 [B] (frames with different
    lambdas batch together).  The returned cost includes the approximate
    mode-signalling bits, so min over k is directly the leaf cost for
    the tree DP."""
    if {x.device.type for x in (src_blocks, tops, lefts)} == {"cpu"}:
        preds = predict_all_modes(tops, lefts, w, h, bit_depth)
        satd = satd_batch(src_blocks, preds, w, h)           # [B, 67]
        return plan_trial(src_blocks, preds, satd, lmbda, lmbda_sad, w, h,
                          qp, bit_depth, implicit_mts, k)
    satd = presel_costs(src_blocks, tops, lefts, w, h, bit_depth)
    return plan_trial_refs(src_blocks, tops, lefts, satd, lmbda, lmbda_sad,
                           w, h, qp, bit_depth, implicit_mts, k)


PAD = 80  # edge padding of the plane fed to _plan_batch_core


def _class_inputs(planes, s: int, W: int, H: int):
    """The QT-only candidate blocks of size class s in a batch of padded
    planes [F, H+2*PAD, W+2*PAD] int16, on the planes' device: block
    tiling is a reshape (QT-only grids are non-overlapping), reference
    rows/columns are gathers with arange-built indices.  Returns blocks
    [F*ny*nx, s, s], tops and lefts [F*ny*nx, 2s+3], all int32, ordered
    (frame, block row, block column)."""
    F, Wp = planes.shape[0], planes.shape[2]
    dev = planes.device
    nx, ny = W // s, H // s
    core = planes[:, PAD:PAD + ny * s, PAD:PAD + nx * s]
    blocks = core.reshape(F, ny, s, nx, s).permute(0, 1, 3, 2, 4) \
                 .reshape(F * ny * nx, s, s).to(torch.int32)
    by = (torch.arange(ny, device=dev) * s)[:, None]
    bx = (torch.arange(nx, device=dev) * s)[None, :]
    base = ((by + PAD - 1) * Wp + bx + PAD - 1).reshape(-1)      # [ny*nx]
    jt = torch.arange(2 * s + 3, device=dev)
    flatp = planes.reshape(F, -1)
    tops = flatp[:, base[:, None] + jt[None, :]] \
        .reshape(F * ny * nx, 2 * s + 3).to(torch.int32)
    lefts = flatp[:, base[:, None] + jt[None, :] * Wp] \
        .reshape(F * ny * nx, 2 * s + 3).to(torch.int32)
    return blocks, tops, lefts


def _plan_batch_core(planes, lmbda, lmbda_sad, sizes, W: int, H: int,
                     qp: int, bit_depth: int = 10, implicit_mts: bool = True,
                     k: int = 2, mesh=None):
    """All size classes of a batch of frames, on the planes' device, or
    with a mesh (the MESH hook) each class sharded over it by
    parallel.mesh.sharded_plan_class.

    planes: [F, H+2*PAD, W+2*PAD] int16 edge-padded source planes (the
    only h2d transfer).  Returns (modes [N, k] int32, costs [N, k]
    float32) flat over (class, frame, block) in `sizes` order, on the
    planes' device or the mesh's home device."""
    out_modes, out_costs = [], []
    for s in sizes:
        blocks, tops, lefts = _class_inputs(planes, s, W, H)
        n1 = (W // s) * (H // s)
        args = (blocks, tops, lefts, lmbda.repeat_interleave(n1),
                lmbda_sad.repeat_interleave(n1))
        if mesh is None:
            m, c = _plan_class_core(*args, s, s, qp, bit_depth,
                                    implicit_mts, k)
        else:
            from ..parallel.mesh import sharded_plan_class
            m, c = sharded_plan_class(mesh, *args, w=s, h=s, qp=qp,
                                      bit_depth=bit_depth,
                                      implicit_mts=implicit_mts, k=k)
        out_modes.append(m)
        out_costs.append(c)
    return torch.cat(out_modes), torch.cat(out_costs)


# ---------------------------------------------------------------------------
# host orchestration: frame-batched plan tables + quadtree DP
# ---------------------------------------------------------------------------

def _plan_sizes(W, H, ctu_size, min_qt):
    unit = min(64, ctu_size)
    return [s for s in (4, 8, 16, 32, 64)
            if min_qt <= s <= unit and s <= min(W, H)]


def _dp_tables(sizes, grids, leaf_modes, leaf_cost, lmbda, margins=None):
    """Quadtree DP bottom-up: cost(s) = min(leaf + split0_bits,
    sum(children) + split1_bits).  Grids are size-aligned (QT-only) so
    child (i, j) of node (y, x) at size s is at (2y+i, 2x+j) in the s/2
    grid; children outside the frame (grid) cost 0 (the searcher skips
    them — out-of-picture parts of implicit splits).  margins, when a
    dict, receives per size the relative gap |split - leaf| / leaf of
    each split decision (a near-tie check for comparisons of two
    planners)."""
    split_bit = lmbda * SPLIT_BITS
    best, split = {}, {}
    prev = None
    for s in sizes:                       # ascending
        lc = leaf_cost[s]
        ny, nx = lc.shape
        if prev is None:
            best[s] = lc
            split[s] = np.zeros((ny, nx), np.int32)
        else:
            pc = best[prev]
            csum = np.zeros((ny, nx))
            for i in (0, 1):
                for j in (0, 1):
                    sub = pc[i::2, j::2][:ny, :nx]
                    csum[:sub.shape[0], :sub.shape[1]] += sub
            sc = csum + split_bit
            leaf = lc + split_bit
            split[s] = (sc < leaf).astype(np.int32)
            if margins is not None:
                margins[s] = np.abs(sc - leaf) / np.maximum(leaf, 1e-30)
            best[s] = np.minimum(leaf, sc)
        prev = s

    tables = {}
    for s in sizes:
        xs, ys, ax, ay = grids[s]
        ny, nx = len(ys), len(xs)
        plan = np.empty((ny * nx, 3), np.int32)
        lm2 = leaf_modes[s].reshape(ny * nx, -1)
        plan[:, 0] = lm2[:, 0]
        plan[:, 1] = lm2[:, 1] if lm2.shape[1] > 1 else lm2[:, 0]
        plan[:, 2] = split[s].reshape(-1)
        tables[(s, s)] = (xs, ys, ax, ay, nx, plan)
    return tables


class FramePlan:
    """Per-frame device-planned coding tree for the QT-only intra path.

    tables[(w, h)] = (xs, ys, ax, ay, nx, plan) with plan [ny*nx, 3] int32
    rows {mode0, mode1, split} — the layout the native driver's
    plan_lookup reads (split: 0 = NO_SPLIT leaf, 1 = QT split; node sizes
    below min_qt always 0)."""

    def __init__(self, src_y: np.ndarray, bit_depth: int, ctu_size: int,
                 min_qt: int, qp: int, lmbda: float, lmbda_sad: float,
                 implicit_mts: bool = True, k: int | None = None,
                 device="cuda"):
        self.tables = build_plans(
            [src_y], bit_depth, ctu_size, min_qt, qp, [lmbda],
            [lmbda_sad], implicit_mts, k, device=device)[0].tables

    def lookup(self, x, y, w, h):
        ent = self.tables.get((w, h))
        if ent is None:
            return None
        xs, ys, ax, ay, nx, plan = ent
        if x % ax or y % ay:
            return None
        ix, iy = x // ax, y // ay
        if ix >= nx or iy >= len(ys):
            return None
        return plan[iy * nx + ix]


class _PlanView(FramePlan):
    def __init__(self, tables):                 # noqa: super-init
        self.tables = tables


# optional device mesh (parallel.mesh.Mesh): when set, build_plans runs
# every class through parallel.mesh.sharded_plan_class, gathering the
# candidates on the encoder's device and handing each position its shard;
# the plans are the same for any mesh shape (chip-count invariance).  Read
# at call time, from the plan-prefill thread too.
MESH = None


def build_plans(srcs, bit_depth: int, ctu_size: int, min_qt: int, qp: int,
                lmbdas, lmbda_sads, implicit_mts: bool = True,
                k: int | None = None, device="cuda"):
    """Device RD plans for a BATCH of frames.

    All frames' candidate blocks of a size class are stacked into one
    batch per kernel launch (per position with MESH set), and the (tiny)
    mode/cost results come back in one fetch per batch.  Frames may have
    different lambdas (per-block inputs).  device: "cuda" (the kernels)
    or "cpu" (their plain versions); "cuda" without a card raises.

    Returns [FramePlan] per frame."""
    from ..device import resolve_device
    dev = resolve_device(device)
    mesh = MESH
    if mesh is not None:
        from ..parallel.mesh import check_mesh_device
        check_mesh_device(mesh, dev)
    if k is None:
        k = PLAN_K
    F = len(srcs)
    H, W = srcs[0].shape
    sizes = tuple(_plan_sizes(W, H, ctu_size, min_qt))
    planes = np.stack([np.pad(s, PAD, mode="edge")
                       for s in srcs]).astype(np.int16)
    modes_d, costs_d = _plan_batch_core(
        torch.from_numpy(planes).to(dev),
        torch.tensor(lmbdas, dtype=torch.float32, device=dev),
        torch.tensor(lmbda_sads, dtype=torch.float32, device=dev),
        sizes, W, H, qp, bit_depth, implicit_mts, k, mesh)
    # the .cpu() fetches synchronise (with a mesh, the collection waits
    # on every position): the caller's PROF span covers the kernels
    modes = modes_d.cpu().numpy()
    costs = costs_d.cpu().numpy()
    return _plan_tables(modes, costs, sizes, W, H, lmbdas)


def _plan_tables(modes, costs, sizes, W: int, H: int, lmbdas,
                 margins=None):
    """[FramePlan] per frame from the flat (class, frame, block) modes
    and costs of _plan_batch_core: the PLAN_MARGIN drop of the second
    mode, then the quadtree DP (margins: see _dp_tables)."""
    F = len(lmbdas)
    grids = {s: _class_grid(W, H, s, s, mtt=False) for s in sizes}
    per_frame_tabs = [({}, {}) for _ in range(F)]
    off = 0
    for s in sizes:
        xs, ys, ax, ay = grids[s]
        nx, ny = len(xs), len(ys)
        B1 = nx * ny
        for f in range(F):
            m = modes[off + f * B1:off + (f + 1) * B1].copy()
            c = costs[off + f * B1:off + (f + 1) * B1]
            if m.shape[1] > 1:
                # decisive margin -> single exact trial (m1 := m0)
                drop = c[:, 1] > c[:, 0] * PLAN_MARGIN
                m[drop, 1] = m[drop, 0]
            leaf_modes, leaf_cost = per_frame_tabs[f]
            leaf_modes[s] = m.reshape(ny, nx, -1)
            leaf_cost[s] = c.min(axis=1).reshape(ny, nx)
        off += F * B1
    return [_PlanView(_dp_tables(sizes, grids, per_frame_tabs[f][0],
                                 per_frame_tabs[f][1], float(lmbdas[f]),
                                 None if margins is None else margins[f]))
            for f in range(F)]

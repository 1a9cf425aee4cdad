"""The plain reference of device planning (the port's K4 gathered entry
then K3's reference entry): every QT size class of a batch of pictures,
67-mode prediction, Hadamard SATD, top-k by SATD plus mode bits, and a
transform / quantisation trial of each survivor, on the CPU.

It is the CPU route of the port's _plan_class_core (predict_all_modes ->
satd_batch -> plan_trial, their plain versions, in vvc/), run in chunks
of candidates.  `dtype` is the precision of the scores and costs: float32
as the configuration states; the control of the comparison computes them
in bfloat16, the nearest precision below.
"""

from __future__ import annotations

import numpy as np
import torch

from .vvc.ops import intra_plan as IP
from .vvc.ops.intra_presel import (_class_chunk, predict_all_modes_ref,
                                   satd_batch_ref)
from .vvc.ops.transforms import (_fwd_tr_ref, _inv_tr_ref,
                                 dequant_batch_ref, quant_batch_ref)

PAD = IP.PAD


def padded_planes(lumas, shift: int) -> torch.Tensor:
    """[F, H + 2 PAD, W + 2 PAD] int16 edge-padded planes of 8-bit luma
    pictures raised to the internal bit depth."""
    return torch.from_numpy(np.stack([
        np.pad(y.astype(np.int32) << shift, PAD, mode="edge")
        for y in lumas]).astype(np.int16))


def trial(src, preds, satd, lmbda, lmbda_sad, w, h, qp, bit_depth,
          implicit_mts, k, dtype):
    """plan_trial_ref with the scores and costs in `dtype`."""
    p = IP._trial_params(w, h, qp, bit_depth, implicit_mts)
    B = preds.shape[0]
    mode_bits = torch.from_numpy(IP._MODE_BITS.copy()).to(dtype)
    lmbda = lmbda.to(dtype)
    scores = satd.to(dtype) + mode_bits[None, :] * lmbda_sad.to(dtype)[:, None]
    top = torch.sort(scores, dim=1, stable=True).indices[:, :k]
    costs = []
    for i in range(k):
        sel = top[:, i].view(B, 1, 1, 1).expand(B, 1, h, w)
        pred = preds.gather(1, sel)[:, 0].to(torch.int32)
        coeff = _fwd_tr_ref(src - pred, w, h, p["trh"], p["trv"], bit_depth)
        q = quant_batch_ref(coeff, w, h, qp, bit_depth)
        d = dequant_batch_ref(q, w, h, qp, bit_depth)
        r = _inv_tr_ref(d, w, h, p["trh"], p["trv"], bit_depth)
        rec = torch.clamp(pred + r, 0, p["maxval"])
        err = (src - rec).to(dtype)
        sse = (err * err).sum(dim=(1, 2))
        nnz = (q != 0).to(dtype).sum(dim=(1, 2))
        slog = torch.log2(1.0 + q.abs().to(dtype)).sum(dim=(1, 2))
        bits = torch.where(nnz > 0,
                           IP.RATE_C0 + IP.RATE_C1 * nnz + IP.RATE_C2 * slog,
                           torch.ones((), dtype=dtype))
        costs.append(sse + lmbda * (bits + mode_bits[top[:, i]]))
    return top.to(torch.int32), torch.stack(costs, dim=1).to(torch.float32)


def plan_batch(planes, lmbdas, lmbda_sads, sizes, W, H, qp, bit_depth,
               implicit_mts=True, k=2, dtype=torch.float32):
    """(modes [N, k] int32, costs [N, k] float32), flat over (class,
    picture, block) in `sizes` order, as the port's _plan_batch_core
    returns them."""
    lm = torch.tensor(lmbdas, dtype=torch.float32)
    lms = torch.tensor(lmbda_sads, dtype=torch.float32)
    modes, costs = [], []
    for s in sizes:
        blocks, tops, lefts = IP._class_inputs(planes, s, W, H)
        n1 = (W // s) * (H // s)
        lmb, lmsb = lm.repeat_interleave(n1), lms.repeat_interleave(n1)
        step = _class_chunk(s, s)
        for c0 in range(0, blocks.shape[0], step):
            c1 = min(c0 + step, blocks.shape[0])
            preds = predict_all_modes_ref(tops[c0:c1], lefts[c0:c1], s, s,
                                          bit_depth)
            satd = satd_batch_ref(blocks[c0:c1], preds, s, s)
            m, c = trial(blocks[c0:c1], preds, satd, lmb[c0:c1],
                         lmsb[c0:c1], s, s, qp, bit_depth, implicit_mts, k,
                         dtype)
            modes.append(m)
            costs.append(c)
    return torch.cat(modes), torch.cat(costs)


def plan_lambda(qp_plan: int) -> float:
    """The planning λ of a picture whose planning QP (slice QP plus 6 per
    bit above 8) is qp_plan: vvenc's 0.57 * 2^((QP - 12) / 3), scaled to
    the internal bit depth's SSE."""
    return 0.57 * 2.0 ** ((qp_plan - 12) / 3.0)

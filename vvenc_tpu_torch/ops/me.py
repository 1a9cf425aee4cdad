"""Frame-level integer motion estimation on the card.

One device program per (picture, reference) computes the best integer MV
of every 16x16 block — a quarter-resolution search over the full +-R
range, then a full-resolution +-3 refine around 4x the coarse winner —
and the host RD loop uses it as its search centre (reference anchor
InterSearch::xTZSearch, InterSearch.h:506; ME_BS/ME_PAD/FrameMe mirror
the JAX package's ops/me.py).

  frame_me -> K5, csrc/frame_me.cu; frame_me_ref is its plain version
  full_search_sse_batch -> K9, csrc/full_search.cu (best_mv_batch = K9
      and the first argmin); full_search_sse_batch_ref is its plain version

Both compute every SSE exactly in integers: stage 1 in units of 1/16 on
the 4x4 pooled *sums* (int64; K5 sums each pooled row in uint32, exact
for samples of up to 11 bits), stage 2 in int32.  The reference computes
the same quantities in float32 (pooled means, sums in XLA's order), which
is exact for stage 1's samples but not for its sums; the argmins agree
except at a near tie of the reference's rounded costs.  Ties go to the
lowest candidate index, as jnp.argmin does.  The returned cost is the
float32 of the exact stage-2 SSE.

full_search_sse_batch likewise computes every displacement's SSE exactly
as an integer (int64) and returns its float32; the reference computes
sum(a^2) + sum(b^2) - 2 corr(a, b) in float32, which cancels (ROADMAP.md
section 3).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import kernels

ME_BS = 16      # pre-ME block size (luma)
ME_PAD = 96     # plane padding (>= R + bs)
REFINE = 3      # full-resolution refine radius

_P, _I = ctypes.c_void_p, ctypes.c_int


def full_search_sse_np(block: np.ndarray, area: np.ndarray) -> np.ndarray:
    """Reference: SSE of `block` [h, w] at every displacement inside
    `area` [h + 2R, w + 2R] -> costs [(2R+1), (2R+1)]."""
    h, w = block.shape
    ah, aw = area.shape
    out = np.zeros((ah - h + 1, aw - w + 1), dtype=np.int64)
    for dy in range(ah - h + 1):
        for dx in range(aw - w + 1):
            d = area[dy:dy + h, dx:dx + w].astype(np.int64) - block
            out[dy, dx] = (d * d).sum()
    return out


_FS_CHUNK = 1 << 24     # int64 samples of a plain-version step


def _check_search(blocks, areas, h, w):
    """(gh, gw) of the displacement grid after checking the shapes."""
    if blocks.dim() != 3 or areas.dim() != 3 or \
            blocks.shape[0] != areas.shape[0] or \
            tuple(blocks.shape[1:]) != (h, w):
        raise ValueError(f"blocks {tuple(blocks.shape)} / areas "
                         f"{tuple(areas.shape)}: need [B, {h}, {w}] and "
                         f"[B, {h} + 2R, {w} + 2R]")
    gh, gw = areas.shape[1] - h + 1, areas.shape[2] - w + 1
    if gh < 1 or gw < 1:
        raise ValueError(f"areas {tuple(areas.shape)} smaller than the "
                         f"{w}x{h} block")
    return gh, gw


def full_search_sse_batch_ref(blocks: torch.Tensor, areas: torch.Tensor,
                              h: int, w: int) -> torch.Tensor:
    """Plain PyTorch version of full_search_sse_batch: the exact int64 SSE
    of every displacement (integer unfold, no convolution: cuDNN would
    take TF32), a chunk of blocks at a time, as float32."""
    gh, gw = _check_search(blocks, areas, h, w)
    B = blocks.shape[0]
    out = torch.empty((B, gh, gw), dtype=torch.float32, device=blocks.device)
    step = max(1, _FS_CHUNK // (gw * h * w))
    for b0 in range(0, B, step):
        b1 = min(b0 + step, B)
        a = areas[b0:b1].long()
        blk = blocks[b0:b1].long()[:, None, :, :]
        for dy in range(gh):
            # [n, gw, h, w] windows of one row of displacements
            win = a[:, dy:dy + h, :].unfold(2, w, 1).permute(0, 2, 1, 3)
            d = win - blk
            out[b0:b1, dy] = (d * d).sum(dim=(2, 3)).to(torch.float32)
    return out


_K9_ARGS = [_P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P]


def full_search_sse_batch(blocks: torch.Tensor, areas: torch.Tensor, h: int,
                          w: int) -> torch.Tensor:
    """SSE over all integer displacements for a batch of blocks.

    blocks: [B, h, w] int32; areas: [B, h+2R, w+2R] int32 -> costs [B,
    2R+1, 2R+1] float32, each the exact integer SSE rounded once.  K9 on a
    CUDA device, the plain version on the CPU."""
    if blocks.device.type == "cpu" and areas.device.type == "cpu":
        return full_search_sse_batch_ref(blocks, areas, h, w)
    dev = blocks.device
    if dev.type != "cuda":
        raise ValueError(f"full_search_sse_batch: no kernel for {dev}")
    kernels.require(blocks, "blocks", torch.int32, 3, dev)
    kernels.require(areas, "areas", torch.int32, 3, dev)
    gh, gw = _check_search(blocks, areas, h, w)
    B = blocks.shape[0]
    out = torch.empty((B, gh, gw), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    fn = kernels.function("full_search", "vt_full_search_sse", _K9_ARGS)
    err = fn(blocks.data_ptr(), areas.data_ptr(), out.data_ptr(), B, h, w,
             areas.shape[1], areas.shape[2], kernels.stream_ptr(out))
    kernels.check("full_search", err)
    kernels.count("full_search_sse")
    return out


def best_mv_batch(blocks, areas, h, w, lambda_mv=0.0, center_bias=None):
    """Argmin over the displacement grid -> integer MVs relative to the
    window top-left.  Returns (mv_y [B], mv_x [B], cost [B]); ties go to
    the lowest index (torch.argmin returns the first minimum, as
    jnp.argmin).  lambda_mv and center_bias are unused, as in the
    reference."""
    costs = full_search_sse_batch(blocks, areas, h, w)
    bsz, gh, gw = costs.shape
    flat = costs.reshape(bsz, -1)
    idx = torch.argmin(flat, dim=1)
    return idx // gw, idx % gw, torch.gather(flat, 1, idx[:, None])[:, 0]


def _check_planes(src_pad, ref_pad, W, H, R):
    shape = (H + 2 * ME_PAD, W + 2 * ME_PAD)
    if tuple(src_pad.shape) != shape or tuple(ref_pad.shape) != shape:
        raise ValueError(f"planes {tuple(src_pad.shape)} / "
                         f"{tuple(ref_pad.shape)}: need {shape}")
    if W % ME_BS or H % ME_BS or W <= 0 or H <= 0:
        raise ValueError(f"{W}x{H}: sides must be positive multiples of "
                         f"{ME_BS}")
    if not 0 <= R <= 64:
        raise ValueError(f"search range {R}: must be 0..64")


def frame_me_ref(src_pad: torch.Tensor, ref_pad: torch.Tensor, W: int,
                 H: int, R: int = 64):
    """Plain PyTorch version of frame_me: (mv [ny*nx, 2] int32 (x, y),
    cost [ny*nx] float32), every SSE exact in integers."""
    _check_planes(src_pad, ref_pad, W, H, R)
    bs, P, q = ME_BS, ME_PAD, 4
    ny, nx = H // bs, W // bs
    B = ny * nx
    Rq, bq = R // q, bs // q
    D = 2 * Rq + 1
    sp = src_pad.to(torch.int64)
    rp = ref_pad.to(torch.int64)
    Hp, Wp = rp.shape

    # ---- stage 1: 4x4 pooled sums (the reference's means times 16) ----
    core = sp[P:P + H, P:P + W]
    src_q = core.reshape(H // q, q, W // q, q).sum(dim=(1, 3))
    ref_q = rp.reshape(Hp // q, q, Wp // q, q).sum(dim=(1, 3))
    blocks_q = src_q.reshape(ny, bq, nx, bq).permute(0, 2, 1, 3) \
        .reshape(B, 1, bq, bq)
    wins_q = ref_q.unfold(0, bq, 1).unfold(1, bq, 1)   # [.., .., bq, bq]
    Pq = P // q
    y0 = (torch.arange(ny, device=sp.device) * bq + Pq - Rq)[:, None]
    x0 = (torch.arange(nx, device=sp.device) * bq + Pq - Rq)[None, :]
    yb = y0.expand(ny, nx).reshape(B)
    xb = x0.expand(ny, nx).reshape(B)
    ox = torch.arange(D, device=sp.device)
    cost_q = torch.empty((B, D * D), dtype=torch.int64, device=sp.device)
    for oy in range(D):                     # one row of displacements
        cand = wins_q[(yb + oy)[:, None], xb[:, None] + ox[None, :]]
        d = cand - blocks_q                                 # [B, D, bq, bq]
        cost_q[:, oy * D:(oy + 1) * D] = (d * d).sum(dim=(2, 3))
    bi = torch.argmin(cost_q, dim=1)        # first minimum: lowest index
    cy = bi // D - Rq
    cx = bi % D - Rq

    # ---- stage 2: full-resolution +-REFINE around (4 cx, 4 cy) ----
    r2 = REFINE
    D2 = 2 * r2 + 1
    blocks = core.reshape(ny, bs, nx, bs).permute(0, 2, 1, 3) \
        .reshape(B, 1, bs, bs)
    wins = rp.unfold(0, bs, 1).unfold(1, bs, 1)
    fy = (torch.arange(ny, device=sp.device) * bs)[:, None] \
        .expand(ny, nx).reshape(B)
    fx = (torch.arange(nx, device=sp.device) * bs)[None, :] \
        .expand(ny, nx).reshape(B)
    by2 = fy + P + q * cy - r2
    bx2 = fx + P + q * cx - r2
    o2 = torch.arange(D2, device=sp.device)
    cost2 = torch.empty((B, D2 * D2), dtype=torch.int64, device=sp.device)
    for oy in range(D2):
        cand = wins[(by2 + oy)[:, None], bx2[:, None] + o2[None, :]]
        d = cand - blocks
        cost2[:, oy * D2:(oy + 1) * D2] = (d * d).sum(dim=(2, 3))
    bi2 = torch.argmin(cost2, dim=1)
    ry = bi2 // D2 - r2
    rx = bi2 % D2 - r2
    mv = torch.stack([q * cx + rx, q * cy + ry], dim=1).to(torch.int32)
    best = torch.gather(cost2, 1, bi2[:, None])[:, 0].to(torch.float32)
    return mv, best


_K5_ARGS = [_P, _P, _I, _I, _I, _I, _P, _P, _P]


def frame_me(src_pad: torch.Tensor, ref_pad: torch.Tensor, W: int, H: int,
             R: int = 64):
    """Best integer MV per 16x16 block of the frame vs one reference.

    src_pad/ref_pad: [H + 2*ME_PAD, W + 2*ME_PAD] int16 edge-padded
    planes of samples in 0 .. 2047 (K5's exact arithmetic), W and H
    multiples of 16, R <= 64.  Returns (mv [ny*nx, 2] int32 full-pel
    (x, y), cost [ny*nx] float32).  K5 on a CUDA device, the plain
    version on the CPU."""
    if src_pad.device.type == "cpu" and ref_pad.device.type == "cpu":
        return frame_me_ref(src_pad, ref_pad, W, H, R)
    dev = src_pad.device
    if dev.type != "cuda":
        raise ValueError(f"frame_me: no kernel for {dev}")
    kernels.require(src_pad, "src_pad", torch.int16, 2, dev)
    kernels.require(ref_pad, "ref_pad", torch.int16, 2, dev)
    _check_planes(src_pad, ref_pad, W, H, R)
    B = (H // ME_BS) * (W // ME_BS)
    mv = torch.empty((B, 2), dtype=torch.int32, device=dev)
    cost = torch.empty((B,), dtype=torch.float32, device=dev)
    fn = kernels.function("frame_me", "vt_frame_me", _K5_ARGS)
    err = fn(src_pad.data_ptr(), ref_pad.data_ptr(), src_pad.shape[1],
             W // ME_BS, H // ME_BS, R, mv.data_ptr(), cost.data_ptr(),
             kernels.stream_ptr(mv))
    kernels.check("frame_me", err)
    kernels.count("frame_me")
    return mv, cost


class FrameMe:
    """Per-(picture, reference) device pre-ME table.

    lookup(x, y) -> (mv_x, mv_y) full-pel best for the 16x16 block
    containing (x, y)."""

    def __init__(self, src_y: np.ndarray, ref_y: np.ndarray, R: int = 64,
                 device="cuda"):
        from ..device import resolve_device
        dev = resolve_device(device)
        H, W = src_y.shape
        self.bs = ME_BS
        Hc, Wc = (H // self.bs) * self.bs, (W // self.bs) * self.bs
        sp = np.pad(src_y, ME_PAD, mode="edge").astype(np.int16)
        rp = np.pad(ref_y, ME_PAD, mode="edge").astype(np.int16)
        # pad to the block multiple INSIDE the padded plane view
        mv, _cost = frame_me(
            torch.from_numpy(np.ascontiguousarray(
                sp[:Hc + 2 * ME_PAD, :Wc + 2 * ME_PAD])).to(dev),
            torch.from_numpy(np.ascontiguousarray(
                rp[:Hc + 2 * ME_PAD, :Wc + 2 * ME_PAD])).to(dev),
            Wc, Hc, R)
        # .cpu() waits for this thread's stream: the caller's PROF span
        # covers the kernel
        self.mv = mv.cpu().numpy().reshape(Hc // self.bs, Wc // self.bs, 2)

    def lookup(self, x: int, y: int):
        iy = min(max(y // self.bs, 0), self.mv.shape[0] - 1)
        ix = min(max(x // self.bs, 0), self.mv.shape[1] - 1)
        return int(self.mv[iy, ix, 0]), int(self.mv[iy, ix, 1])

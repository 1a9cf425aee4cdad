"""Single-process device mesh and the sharded programs of the mesh path.

The port of vvenc_tpu/parallel/mesh.py.  The reference's mesh is
single-controller: one process owns every device and runs a shard_map'ed
program on all of them, and the MESH hooks of ops/intra_plan and
ops/intra_presel are read inside one encoder process, from its
plan-prefill thread too.  The port keeps that shape.  A Mesh is an array
of *positions* with named axes ("tiles", or ("gops", "tiles")); a
position is a torch device and, on a card, its own CUDA stream, so that
several positions on one card run on separate streams and positions on
several cards run on their own cards.  One host thread drives them all:
it enqueues each position's work under that position's stream, and every
read of a tensor by another position waits on an event recorded on the
sender's stream:

  psum      -> an explicit sum onto one position
  ppermute  -> a copy to the receiving position (a peer copy across two
               cards)

There is no torch.distributed process group: a group needs every rank to
enter each collective, and the encoder's build_plans / FramePresel calls
are made by one process.  Positions are placed on the devices the caller
lists; a mesh of n positions on one card is built as [cuda:0] * n and
describe() says how many cards it occupies.

Per block the programs compute what the unsharded kernels compute, so
every output is the same for any mesh shape (chip-count invariance).
Where the reference's values are int32 because JAX runs with x64 off (the
SSE of search_step, the keep-better comparison and the psum totals of
sharded_encode_step2d and sharded_presel_costs), the port computes int64
(ROADMAP.md section 3).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..device import resolve_device
from ..ops import intra_presel as S
from ..ops import transforms as T


class Position:
    """One place of a mesh: a device and, on a card, a CUDA stream (its
    own, or the caller's current one for Position.caller)."""

    __slots__ = ("device", "stream")

    def __init__(self, device, stream=None):
        self.device = device
        self.stream = stream

    @classmethod
    def new(cls, device) -> "Position":
        dev = resolve_device(device)
        if dev.type == "cpu":
            return cls(dev)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return cls(dev, torch.cuda.Stream(dev))

    @classmethod
    def caller(cls, device) -> "Position":
        """The calling thread's side of `device`: its current stream."""
        dev = torch.device(device)
        return cls(dev, torch.cuda.current_stream(dev)
                   if dev.type == "cuda" else None)

    def run(self):
        """Context under which work is enqueued on this position."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)


class Mesh:
    """Positions in an array with named axes, as jax.sharding.Mesh holds
    devices.  devices: an array-like of device names or torch.devices,
    one per position, of one device type."""

    def __init__(self, devices, axis_names):
        devs = np.array(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if devs.ndim != len(self.axis_names) or devs.size == 0:
            raise ValueError(f"mesh of shape {devs.shape} with axes "
                             f"{self.axis_names}")
        self.positions = np.empty(devs.shape, dtype=object)
        for idx in np.ndindex(devs.shape):
            self.positions[idx] = Position.new(devs[idx])
        if len({p.device.type for p in self.flat}) != 1:
            raise ValueError("a mesh's positions share one device type")
        self.shape = dict(zip(self.axis_names, devs.shape))

    @property
    def flat(self) -> list:
        """The positions in row-major order (shard i lives on flat[i])."""
        return list(self.positions.reshape(-1))

    @property
    def size(self) -> int:
        return self.positions.size

    @property
    def home(self) -> torch.device:
        """The device sharded outputs are collected on (position 0's)."""
        return self.flat[0].device

    def describe(self) -> str:
        axes = " x ".join(f"{a} {n}" for a, n in self.shape.items())
        devs = sorted({str(p.device) for p in self.flat})
        where = ("the CPU" if devs == ["cpu"] else
                 f"{len(devs)} card{'s' if len(devs) > 1 else ''} "
                 f"({', '.join(devs)})")
        return f"{self.size} positions ({axes}) on {where}"


def _cards() -> list:
    resolve_device("cuda")                 # raises without a card
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices=None, axis: str = "tiles") -> Mesh:
    """1-D mesh over `devices` (default: every visible card)."""
    devices = _cards() if devices is None else list(devices)
    return Mesh(np.array(devices, dtype=object), (axis,))


def make_mesh2d(devices=None, shape=None,
                axes=("gops", "tiles")) -> Mesh:
    """2-D mesh: GOP/frame parallelism (data axis) x tile columns (spatial
    axis).  Default shape: 4 or else 2 GOP rows when that leaves more
    than one tile column (the reference's rule), else (1, n)."""
    devices = _cards() if devices is None else list(devices)
    n = len(devices)
    if shape is None:
        g = 1
        for cand in (4, 2):
            if n % cand == 0 and n // cand > 1:
                g = cand
                break
        shape = (g, n // g)
    return Mesh(np.array(devices, dtype=object).reshape(shape), axes)


def check_mesh_device(mesh: Mesh, device) -> None:
    """Raise unless the mesh's positions are on `device`'s device type: a
    MESH hook never moves an encode between the card and the CPU."""
    kind = torch.device(device).type
    if mesh.home.type != kind:
        raise ValueError(f"the mesh ({mesh.describe()}) is not on the "
                         f"encoder's device {kind!r}")


# ---------------------------------------------------------------------------
# moving tensors between positions
# ---------------------------------------------------------------------------

def _send(t: torch.Tensor, src: Position, dst: Position) -> torch.Tensor:
    """t, made on src's stream, as a tensor that dst's stream may read on
    dst's device: on one card the same tensor once dst's stream waits on
    an event of src's stream; across two cards a peer copy ordered after
    src's work and before dst's; to or from the host a copy."""
    if dst.stream is None:
        if src.stream is None:
            return t.to(dst.device)
        with src.run():
            return t.to(dst.device)       # synchronises src's stream
    if t.device.type == "cpu":
        with dst.run():
            return t.to(dst.device, non_blocking=True)
    if t.device == dst.device:
        if src.stream != dst.stream:
            dst.stream.wait_event(src.stream.record_event())
            t.record_stream(dst.stream)
        return t
    with src.run(), dst.run():
        return t.to(dst.device, non_blocking=True)


def _psum(parts, root: Position) -> torch.Tensor:
    """Sum of the (position, tensor) parts onto position root."""
    with root.run():
        return torch.stack([_send(t, p, root) for p, t in parts]).sum(dim=0)


def _pad_rows(x: torch.Tensor, n: int, fill) -> torch.Tensor:
    """x [B, ...] padded with `fill` rows to a multiple of n."""
    pad = (-x.shape[0]) % n
    if not pad:
        return x
    return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                    dtype=x.dtype, device=x.device)])


def _scatter(mesh: Mesh, x: torch.Tensor) -> list:
    """x [N, ...] (N a multiple of the positions) in equal shards, shard i
    on position i, each ready on its position's stream."""
    per = x.shape[0] // mesh.size
    here = Position.caller(x.device)
    return [_send(x[i * per:(i + 1) * per], here, p)
            for i, p in enumerate(mesh.flat)]


def _collect(mesh: Mesh, parts: list) -> torch.Tensor:
    """The positions' parts (part i from position i) concatenated on the
    mesh's home device, ready on the caller's current stream there (which
    waits on every position)."""
    here = Position.caller(mesh.home)
    return torch.cat([_send(t, p, here) for p, t in zip(mesh.flat, parts)])


def shard_batch(mesh: Mesh, arr: torch.Tensor, axis_name="tiles") -> list:
    """A [B, ...] tensor split along its batch axis over every position
    of the mesh (B a multiple of their number), shard i on position i of
    the row-major order; returns the shards.  axis_name names the mesh's
    axes (one name for a 1-D mesh): the port shards over whole meshes."""
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    if names != mesh.axis_names:
        raise ValueError(f"shard_batch over {names}: the mesh's axes are "
                         f"{mesh.axis_names}")
    if arr.shape[0] % mesh.size:
        raise ValueError(f"batch {arr.shape[0]} does not divide over "
                         f"{mesh.size} positions")
    return _scatter(mesh, arr)


# ---------------------------------------------------------------------------
# the partition-level trial
# ---------------------------------------------------------------------------

def _trial(src, tops, lefts, w, h, qp, bit_depth, plain):
    if plain:
        pred_all, satd, fwd, quant, dequant, inv = (
            S.predict_all_modes_ref, S.satd_batch_ref,
            T.fwd_transform_batch_ref, T.quant_batch_ref,
            T.dequant_batch_ref, T.inv_transform_batch_ref)
    else:
        pred_all, satd, fwd, quant, dequant, inv = (
            S.predict_all_modes, S.satd_batch, T.fwd_transform_batch,
            T.quant_batch, T.dequant_batch, T.inv_transform_batch)
    B = src.shape[0]
    preds = pred_all(tops, lefts, w, h, bit_depth)          # [B, 67, h, w]
    best = satd(src, preds, w, h).argmin(dim=1)             # first minimum
    pred = preds.gather(1, best.view(B, 1, 1, 1).expand(B, 1, h, w))[:, 0] \
        .to(torch.int32)
    coeff = fwd(src - pred, w, h, bit_depth)
    q = quant(coeff, w, h, qp, bit_depth)
    bits = q.abs().sum(dim=(1, 2), dtype=torch.int32)
    rec = torch.clamp(pred + inv(dequant(q, w, h, qp, bit_depth), w, h,
                                 bit_depth), 0, (1 << bit_depth) - 1)
    sse = (src - rec).to(torch.int64).pow(2).sum(dim=(1, 2))
    return best.to(torch.int32), q, rec, bits, sse


def search_step(src, tops, lefts, *, w, h, qp, bit_depth=10):
    """One partition-level RD trial for a batch of blocks, on their
    device: 67-mode prediction (K1) -> SATD (K2) -> the first minimum ->
    residual -> DCT-2 (K6) -> quant (K7) -> sum |level| (rate proxy) ->
    dequant (K7) -> inverse (K6) -> clipped reconstruction -> SSE.

    src [B, h, w], tops [B, >=LPAD], lefts [B, >=LPAD], all int32.
    Returns (best_mode [B] int32, levels [B, h, w], recon [B, h, w],
    bits_proxy [B] int32, sse [B] int64)."""
    return _trial(src, tops, lefts, w, h, qp, bit_depth, plain=False)


def search_step_ref(src, tops, lefts, *, w, h, qp, bit_depth=10):
    """search_step through the kernels' plain versions on any device (the
    path's plain route)."""
    return _trial(src, tops, lefts, w, h, qp, bit_depth, plain=True)


# ---------------------------------------------------------------------------
# the sharded programs
# ---------------------------------------------------------------------------

def sharded_search_step(mesh: Mesh, axis="tiles", *, w, h, qp,
                        bit_depth=10):
    """The trial step over the mesh: step(src, tops, lefts) takes the
    shards of shard_batch (or whole tensors, which it shards) and returns
    (best_mode, levels, recon, total_bits): the per-block outputs
    collected on the home device, the rate total psum'ed (int64)."""
    def step(src, tops, lefts):
        shards = [x if isinstance(x, list) else shard_batch(mesh, x, axis)
                  for x in (src, tops, lefts)]
        outs, totals = [], []
        for i, p in enumerate(mesh.flat):
            with p.run():
                best, q, rec, bits, _sse = search_step(
                    shards[0][i], shards[1][i], shards[2][i], w=w, h=h,
                    qp=qp, bit_depth=bit_depth)
                outs.append((best, q, rec))
                totals.append((p, bits.sum(dtype=torch.int64)))
        root = mesh.flat[0]
        total = _send(_psum(totals, root), root, Position.caller(mesh.home))
        best, q, rec = (_collect(mesh, [o[k] for o in outs])
                        for k in range(3))
        return best, q, rec, total

    return step


def sharded_encode_step2d(mesh: Mesh, *, w, h, qp, bit_depth=10):
    """The encode step over a (gops, tiles) mesh with the two patterns of
    the tiled, pipelined encoder: the reconstructed right-edge apron of
    each position's tile columns goes to the next position along "tiles"
    (ppermute, cyclic), which re-trials its blocks with the received
    samples as the left reference and keeps the better trial per block
    (lower SSE + rate proxy); per-GOP rate is psum'ed over "tiles" and the
    total over both axes.

    step(src, rm, tops, lefts) takes [G, T, B, ...] tensors, G split over
    "gops" and T over "tiles" (rm is unused, as in the reference), and
    returns (best [G, T, B], levels and recon [G, T, B, h, w], per-GOP
    bits [G], total bits) on the home device, the sums int64.  A position
    holds Tl = T / tiles tile columns and sends them all, so tile column
    t receives the apron of column t - Tl (mod T): the permutation moves
    whole shards, as the reference's does."""
    if mesh.axis_names != ("gops", "tiles"):
        raise ValueError(f"sharded_encode_step2d needs a (gops, tiles) "
                         f"mesh, not {mesh.axis_names}")
    gm, tm = mesh.positions.shape
    P = mesh.positions

    def step(src, rm, tops, lefts):
        del rm
        G, Tn, B = src.shape[:3]
        if G % gm or Tn % tm:
            raise ValueError(f"[G, T] = [{G}, {Tn}] does not divide over "
                             f"the {gm} x {tm} mesh")
        gl, tl = G // gm, Tn // tm
        n = gl * tl * B
        here = Position.caller(mesh.home)

        def local(x, i, j):
            part = x[i * gl:(i + 1) * gl, j * tl:(j + 1) * tl].contiguous()
            return _send(part, Position.caller(x.device), P[i, j]) \
                .reshape((n,) + tuple(x.shape[3:]))

        first = {}
        for i, j in np.ndindex(gm, tm):
            s_, t_, l_ = (local(x, i, j) for x in (src, tops, lefts))
            with P[i, j].run():
                r1 = search_step(s_, t_, l_, w=w, h=h, qp=qp,
                                 bit_depth=bit_depth)
                apron = r1[2][:, :, -1].contiguous()            # [n, h]
            first[i, j] = (s_, t_, l_, r1, apron)

        out, gop_parts, tot_parts = {}, {}, []
        for i, j in np.ndindex(gm, tm):
            s_, t_, l_, r1, _ = first[i, j]
            sender = (i, (j - 1) % tm)
            nbr = _send(first[sender][4], P[sender], P[i, j])
            with P[i, j].run():
                L = l_.shape[1]
                lefts_new = torch.cat(
                    [nbr[:, :1], nbr, nbr[:, -1:].expand(n, L - (h + 1))],
                    dim=1)
                r2 = search_step(s_, t_, lefts_new, w=w, h=h, qp=qp,
                                 bit_depth=bit_depth)
                better = r2[4] + r2[3].to(torch.int64) < \
                    r1[4] + r1[3].to(torch.int64)
                best = torch.where(better, r2[0], r1[0])
                q = torch.where(better[:, None, None], r2[1], r1[1])
                rec = torch.where(better[:, None, None], r2[2], r1[2])
                bits = torch.where(better, r2[3], r1[3])
                out[i, j] = (best.reshape(gl, tl, B),
                             q.reshape(gl, tl, B, h, w),
                             rec.reshape(gl, tl, B, h, w))
                gop_parts[i, j] = bits.reshape(gl, tl * B).sum(
                    dim=1, dtype=torch.int64)
                tot_parts.append((P[i, j], bits.sum(dtype=torch.int64)))

        per_gop = torch.cat([
            _send(_psum([(P[i, j], gop_parts[i, j]) for j in range(tm)],
                        P[i, 0]), P[i, 0], here) for i in range(gm)])
        total = _send(_psum(tot_parts, P[0, 0]), P[0, 0], here)
        best, q, rec = (torch.cat([
            torch.cat([_send(out[i, j][k], P[i, j], here)
                       for j in range(tm)], dim=1)
            for i in range(gm)]) for k in range(3))
        return best, q, rec, per_gop, total

    return step


def sharded_presel_costs(mesh: Mesh, blocks, tops, lefts, *, w, h,
                         bit_depth=10):
    """The frame-level preselection (ops/intra_presel.presel_costs, K4 on
    the reference's gathered inputs) over every position of the mesh: the
    batch, zero-padded to a multiple of the positions, splits evenly; the
    frame total of the per-block best SATD is psum'ed.  Returns (costs
    [B, 67] int32, total int64) on the home device."""
    B = blocks.shape[0]
    shards = [_scatter(mesh, _pad_rows(x, mesh.size, 0))
              for x in (blocks, tops, lefts)]
    costs, mins = [], []
    for i, p in enumerate(mesh.flat):
        with p.run():
            c = S.presel_costs(shards[0][i], shards[1][i], shards[2][i], w,
                               h, bit_depth)
            costs.append(c)
            mins.append((p, c.min(dim=1).values.sum(dtype=torch.int64)))
    root = mesh.flat[0]
    total = _send(_psum(mins, root), root, Position.caller(mesh.home))
    return _collect(mesh, costs)[:B], total


def sharded_plan_class(mesh: Mesh, blocks, tops, lefts, lmb, lms, *, w, h,
                       qp, bit_depth=10, implicit_mts=True, k=2):
    """The device RD planning of one size class (ops/intra_plan
    _plan_class_core: the fused SATD, then K3's reference entry) over
    every position of the mesh:
    the candidate batch, padded to a multiple of the positions (blocks
    and references with zeros, the lambdas with ones), splits evenly.
    Returns (modes [B, k] int32, costs [B, k] float32) on the home
    device."""
    from ..ops.intra_plan import _plan_class_core
    B = blocks.shape[0]
    shards = [_scatter(mesh, _pad_rows(x, mesh.size, fill)) for x, fill in
              ((blocks, 0), (tops, 0), (lefts, 0), (lmb, 1), (lms, 1))]
    modes, costs = [], []
    for i, p in enumerate(mesh.flat):
        with p.run():
            m, c = _plan_class_core(*(s[i] for s in shards), w, h, qp,
                                    bit_depth, implicit_mts, k)
            modes.append(m)
            costs.append(c)
    return _collect(mesh, modes)[:B], _collect(mesh, costs)[:B]

"""The port's graft entry points: a single-device compile check and the
mesh dry run (the counterpart of the repository root's __graft_entry__.py,
which belongs to the JAX reference).

entry():             (fn, example_args) of the production device kernel
                     of the reference's check: the frame-level 67-mode
                     intra preselection on gathered inputs
                     (ops/intra_presel.presel_costs, K4's gathered entry),
                     32x32 blocks, B = 64.
dryrun_multichip(n): builds an n-position (gops x tiles) mesh on the
                     visible cards (several positions share a card when
                     there are fewer cards, and the run says so) and
                     1. shards the preselection over it, costs and the
                        psum'ed total equal to the unsharded run,
                     2. runs the real e2e encode (IntraEncoder with the
                        device RD planning dispatching every class through
                        parallel.mesh.sharded_plan_class, the intra_plan
                        MESH hook) and holds its stream byte-identical to
                        the unsharded encode and to a 1-position mesh's,
                        and decodes it,
                     3. runs the partition-level trial with the
                        recon-apron ppermute across tile columns
                        (sharded_encode_step2d) against a replay on the
                        unsharded search_step.
Both run on "cuda" unless the caller asks for "cpu".
"""

from __future__ import annotations

import time
from functools import partial

import numpy as np
import torch

from .device import resolve_device


def _example_inputs(batch, w, h, seed=0):
    rng = np.random.RandomState(seed)
    src = rng.randint(0, 1024, size=(batch, h, w)).astype(np.int32)
    tops = rng.randint(0, 1024, size=(batch, 2 * w + 3)).astype(np.int32)
    lefts = rng.randint(0, 1024, size=(batch, 2 * h + 3)).astype(np.int32)
    lefts[:, 0] = tops[:, 0]
    return src, tops, lefts


def entry(device="cuda"):
    """(fn, example_args) for the single-device compile check."""
    from .ops.intra_presel import presel_costs
    dev = resolve_device(device)
    w = h = 32
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in _example_inputs(batch=64, w=w, h=h))
    return partial(presel_costs, w=w, h=h, bit_depth=10), args


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {msg}")


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    from . import native
    from .decoder import decode_stream
    from .encoder.intra_encoder import EncoderConfig, IntraEncoder
    from .ops import intra_plan
    from .ops.intra_presel import presel_costs
    from .parallel.mesh import (make_mesh2d, search_step,
                                sharded_encode_step2d, sharded_presel_costs)
    from .utils.devclock import DEV

    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        devices = [torch.device("cuda", i % cards) for i in range(n_devices)]
    else:
        devices = [dev] * n_devices
    mesh = make_mesh2d(devices)                    # (gops, tiles)
    home = mesh.home
    print(f"dryrun_multichip: {mesh.describe()}", flush=True)

    def put(arrays):
        return tuple(torch.from_numpy(a).to(home) for a in arrays)

    # 1. the production preselection sharded, with the psum of the
    #    per-block minima
    for (w, h) in ((8, 8), (16, 16)):
        src, tops, lefts = put(_example_inputs(4 * n_devices, w, h))
        costs, total = sharded_presel_costs(mesh, src, tops, lefts, w=w,
                                            h=h, bit_depth=10)
        ref = presel_costs(src, tops, lefts, w, h, 10)
        _check(tuple(costs.shape) == (4 * n_devices, 67),
               f"costs {tuple(costs.shape)}")
        _check(torch.equal(costs, ref),
               f"sharded presel diverges from the unsharded run at {w}x{h}")
        _check(int(total) == int(ref.min(dim=1).values.sum()),
               f"psum'ed total at {w}x{h}")

    # 2. the real e2e encode with the device RD planning sharded over the
    #    mesh: byte-identical to the unsharded encode (chip-count-invariant
    #    streams); the native library is required, not skipped
    if not native.available():
        raise RuntimeError("dryrun_multichip: the native library did not "
                           f"build:\n{native.BUILD_ERROR}")
    rng = np.random.RandomState(11)
    W2, H2, N2 = 192, 128, 2 * n_devices
    base = rng.randint(0, 255, (H2 + 32, W2 + 32)).astype(np.float32)
    frames = []
    for i in range(N2):
        y8 = base[i:i + H2, 2 * i:2 * i + W2].astype(np.uint8)
        frames.append({0: y8, 1: (y8[::2, ::2] // 2 + 60).astype(np.uint8),
                       2: (128 - y8[::2, ::2] // 3).astype(np.uint8)})

    def e2e(mesh_or_none):
        cfg = EncoderConfig(width=W2, height=H2, qp=35, ctu_size=64,
                            intra_period=1, gop_size=1, dual_tree=True,
                            num_full_rd_modes=2, mts=True, sao=False,
                            alf=False, deblocking=True, device_rd="on",
                            me_mode="host", device=device)
        intra_plan.MESH = mesh_or_none
        DEV.reset()
        t0 = time.time()
        try:
            stream = IntraEncoder(cfg).encode_sequence(frames)
        finally:
            intra_plan.MESH = None
        return stream, time.time() - t0, DEV.seconds

    s1, _, d1 = e2e(None)
    sN, _, dN = e2e(mesh)
    s1m, _, _ = e2e(make_mesh2d(devices[:1], shape=(1, 1)))
    _check(sN == s1, "the mesh-sharded e2e encode diverges from the "
           "unsharded one")
    _check(s1m == s1, "the 1-position-mesh e2e encode diverges")
    _check(len(decode_stream(sN)) == N2, "the stream does not decode")
    print(f"dryrun e2e: encode_sequence over the {n_devices}-position mesh "
          f"byte-identical to the unsharded encode ({len(sN)} bytes, {N2} "
          f"frames); device plan seconds unsharded {d1:.3f}, mesh "
          f"{dN:.3f}", flush=True)

    # 3. the partition-level trial over the (gops x tiles) mesh with the
    #    reconstruction-apron ppermute, against a replay: one tile column
    #    per position, so the permutation is a roll by one column
    w = h = 16
    g_ax, t_ax = mesh.positions.shape
    gg, tt, b = 2 * g_ax, t_ax, 2
    src, tops, lefts = put(_example_inputs(gg * tt * b, w, h, seed=4))

    def grid(x):
        return x.reshape((gg, tt, b) + tuple(x.shape[1:]))

    step = sharded_encode_step2d(mesh, w=w, h=h, qp=40)
    best, q, rec, per_gop, total = step(grid(src), grid(src), grid(tops),
                                        grid(lefts))
    _b1, _q1, r1, bits1, sse1 = search_step(src, tops, lefts, w=w, h=h,
                                            qp=40)
    nbr = torch.roll(grid(r1)[..., -1], 1, dims=1).reshape(-1, h)
    L = lefts.shape[1]
    lefts2 = torch.cat([nbr[:, :1], nbr,
                        nbr[:, -1:].expand(-1, L - (h + 1))], dim=1)
    _b2, _q2, r2, bits2, sse2 = search_step(src, tops, lefts2, w=w, h=h,
                                            qp=40)
    better = sse2 + bits2.to(torch.int64) < sse1 + bits1.to(torch.int64)
    _check(torch.equal(rec, grid(torch.where(better[:, None, None], r2,
                                             r1))),
           "the sharded trial with the recon-apron ppermute diverges from "
           "the replay")
    _check(int(total) == int(torch.where(better, bits2, bits1).sum()),
           "the psum'ed total bits")
    print(f"dryrun_multichip ok: {mesh.describe()}, production presel "
          f"kernel + e2e encode + partition-level trial with recon-apron "
          f"ppermute verified", flush=True)

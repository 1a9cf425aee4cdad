"""What decides `correct`: the port's outputs on the timed path, judged
by the benchmark's plain reference (benchmark/reference, which imports
nothing of the port).

Numbers, each held to a limit of limits/<cell>.json (larger is worse):

  stream_differs       encodes of one clip in the window whose stream
                       differs from the judged one (file cells)
  recon_mismatch       judged pictures that the reference decoder does
                       not decode to the encoder's reconstruction, or
                       does not decode at all
  plan_input_mismatch  judged pictures whose plane on the card is not
                       the reference's plane of that picture of the
                       clip, or whose λ is not vvenc's λ of the QP
  plan_mode_mismatch   planned (block, survivor) modes that differ from
                       the reference's
  plan_cost_gap        the largest gap of a survivor's cost from the
                       reference's, as a share of the reference's
  plans_missing        judged pictures fewer than the sample drawn
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import plan as ref_plan
from .reference.vvc.bitstream.nal import VCL_NAL_TYPES, NalUnitType
from .reference.vvc.decoder import decode_stream

PARAM_SETS = (NalUnitType.VPS, NalUnitType.SPS, NalUnitType.PPS)
APS = (NalUnitType.PREFIX_APS, NalUnitType.SUFFIX_APS)
LAMBDA_RTOL = 1e-6


def nal_units(stream: bytes):
    """[(type, bytes with its start code)] of an Annex-B stream."""
    starts = []
    i, n = 0, len(stream)
    while i + 2 < n:
        if stream[i] == 0 and stream[i + 1] == 0 and stream[i + 2] == 1:
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    out = []
    for k, s in enumerate(starts):
        end = starts[k + 1] - 3 if k + 1 < len(starts) else n
        while end > s and stream[end - 1] == 0:
            end -= 1
        if end - s >= 2:
            out.append((NalUnitType((stream[s + 1] >> 3) & 0x1F),
                        b"\x00\x00\x00\x01" + stream[s:end]))
    return out


def decode_in_order(stream: bytes):
    """The reference decoder's pictures in display order: POC restarts
    at each IDR, so a picture's index is its segment's base plus its POC
    (as the port's CLI --verify maps them)."""
    out, base, seen = [], 0, 0
    for fr in decode_stream(stream):
        if fr.poc == 0 and seen:
            base += seen
            seen = 0
        seen += 1
        out.append((base + fr.poc, fr.planes))
    out.sort(key=lambda t: t[0])
    return [p for _, p in out]


def au_alone(aus, i: int) -> bytes:
    """Access unit i of an all-intra stream made decodable by itself: the
    parameter sets of the first access unit and every APS sent before
    it, then the access unit."""
    if i == 0:
        return aus[0]
    head = [b for t, b in nal_units(aus[0]) if t in PARAM_SETS]
    aps = [b for a in aus[:i] for t, b in nal_units(a) if t in APS]
    return b"".join(head + aps) + aus[i]


def access_units(stream: bytes):
    """The access units of a stream of single-slice pictures: each slice
    with the non-VCL units sent since the slice before it."""
    out, pending = [], []
    for t, b in nal_units(stream):
        pending.append(b)
        if t in VCL_NAL_TYPES:
            out.append(b"".join(pending))
            pending = []
    return out


def decode_each(pieces, workers: int):
    """The planes of the one picture that each piece holds, decoded by
    the reference in `workers` child processes (benchmark.decode_worker,
    started with subprocess and waited for before the return, on every
    path out); None for a piece that does not decode to one picture."""
    import os
    import subprocess
    import sys
    import tempfile
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    n = max(1, min(workers, len(pieces)))
    with tempfile.TemporaryDirectory(prefix="bench-decode-") as where:
        for i, p in enumerate(pieces):
            with open(os.path.join(where, f"au{i}.266"), "wb") as f:
                f.write(p)
        procs = []
        try:
            for w in range(n):
                idx = [str(i) for i in range(w, len(pieces), n)]
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "benchmark.decode_worker", where,
                     *idx], cwd=repo, stdin=subprocess.DEVNULL))
            for p in procs:
                p.wait()
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        out = []
        for i in range(len(pieces)):
            f = os.path.join(where, f"planes{i}.npz")
            if not os.path.exists(f):
                out.append(None)
                continue
            with np.load(f) as z:
                out.append([z[f"arr_{c}"] for c in range(len(z.files))])
    return out


def judge_intra_pictures(aus, recons, which, workers: int) -> int:
    """Pictures among `which` (indices of all-intra access units `aus`)
    that the reference decoder, reading each alone, does not decode to
    the encoder's reconstruction; decoded in parallel."""
    pieces = [au_alone(aus, i) for i in which]
    dec = decode_each(pieces, workers)
    return sum(d is None or not same_picture(d, recons[i])
               for d, i in zip(dec, which))


def same_picture(a, b) -> bool:
    return all(np.array_equal(np.asarray(a[c]), np.asarray(b[c]))
               for c in range(3))


def sse(rec, src, shift: int) -> int:
    return int(sum(((np.asarray(rec[c]).astype(np.int64)
                     - (src[c].astype(np.int64) << shift)) ** 2).sum()
                   for c in range(3)))


def rd_cost(recons, srcs, shift: int, lam: float, nbytes: int) -> float:
    """rd_cost_per_frame of pictures: (sum of SSE + λ * bits) / pictures,
    the stream's bits counted whole (parameter sets included)."""
    return (sum(sse(r, s, shift) for r, s in zip(recons, srcs))
            + lam * 8 * nbytes) / len(srcs)


def judge_stream(stream: bytes, recons, expected: int):
    """(mismatching pictures, decoded pictures or None): the reference
    decoder's pictures of `stream` against the encoder's reconstructions
    (display order).  A stream that does not decode, or decodes to
    another number of pictures, fails every picture."""
    try:
        dec = decode_in_order(stream)
    except Exception:                       # noqa: BLE001 - any parse fault
        return expected, None
    if len(dec) != expected or len(recons) != expected:
        return expected, None
    return sum(not same_picture(d, r) for d, r in zip(dec, recons)), dec


def plan_control(call, plane, lam):
    """The control in the program's place: the reference's plan of the
    kept picture with its scores and costs in bfloat16."""
    return ref_plan.plan_batch(plane[None], [lam], [lam ** 0.5],
                               call["sizes"], call["W"], call["H"],
                               int(call["qp"]), int(call["bit_depth"]),
                               bool(call["implicit_mts"]), int(call["k"]),
                               dtype=torch.bfloat16)


def rows_of(sizes, W: int, H: int, F: int, frames):
    """Indices, in the flat (class, picture, block) layout of a planning
    batch of F pictures, of the rows of `frames` (in that order)."""
    rows, off = [], 0
    for s in sizes:
        b1 = (W // s) * (H // s)
        for f in frames:
            rows.extend(range(off + f * b1, off + (f + 1) * b1))
        off += F * b1
    return torch.tensor(rows, dtype=torch.long)


def judge_plans(calls, lumas, shift: int, only=None, control=False):
    """The kept planning records (probes.Probes.plans, one a picture)
    against the reference's plans of the same pictures, for the pictures
    of the clip in `only` (indices into lumas, the benchmark's own 8-bit
    luma pictures; None: all).  control: judge plan_control's output in
    the program's place.  Returns the plan numbers; plans_judged counts
    distinct pictures."""
    nums = {"plan_input_mismatch": 0, "plan_mode_mismatch": 0,
            "plan_cost_gap": 0.0, "plans_judged": 0}
    own = ref_plan.padded_planes(lumas, shift)
    judged = set()
    for call in calls:
        idx, f = call["picture"], call["f"]
        if only is not None and idx not in only:
            continue
        want = ref_plan.plan_lambda(int(call["qp"]))
        lm = float(call["lmbda"][f])
        lms = float(call["lmbda_sad"][f])
        if not torch.equal(own[idx], call["plane"].cpu()) \
                or abs(lm - want) > LAMBDA_RTOL * want \
                or abs(lms - want ** 0.5) > LAMBDA_RTOL * want ** 0.5:
            nums["plan_input_mismatch"] += 1
            continue
        sizes, W, H = call["sizes"], call["W"], call["H"]
        rows = rows_of(sizes, W, H, call["F"], [f])
        modes = call["modes"].cpu()[rows]
        costs = call["costs"].cpu()[rows]
        rm, rc = ref_plan.plan_batch(own[idx][None], [want], [want ** 0.5],
                                     sizes, W, H, int(call["qp"]),
                                     int(call["bit_depth"]),
                                     bool(call["implicit_mts"]),
                                     int(call["k"]))
        if control:
            modes, costs = plan_control(call, own[idx], want)
        nums["plan_mode_mismatch"] += int((modes != rm).sum())
        same = modes == rm
        gap = (costs - rc).abs() / rc.abs().clamp_min(1.0)
        if bool(same.any()):
            nums["plan_cost_gap"] = max(nums["plan_cost_gap"],
                                        float(gap[same].max()))
        judged.add(idx)
    nums["plans_judged"] = len(judged)
    return nums


def verdict(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]) for every number with a limit."""
    rows = [(k, numbers.get(k), lim) for k, lim in limits.items()]
    ok = all(v is not None and v <= lim for _, v, lim in rows)
    return ok, rows

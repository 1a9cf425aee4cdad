#!/usr/bin/env python3
"""BD-rate harness: vvenc_tpu_torch vs the reference encoder (vvencFFapp).

The twin of tools/bdrate.py for the PyTorch port.  The mandate's quality
gate is BD-rate <= 0% vs `--preset medium` at matched settings
(BASELINE.md).  This script encodes one or more YUV clips at a QP ladder
with BOTH encoders, computes PSNR-YUV per point against the source, and
reports the Bjontegaard-delta rate (piecewise cubic in log-rate, the
standard JVET convention).

Usage:
  python -m vvenc_tpu_torch.tools.bdrate --clip clip.yuv --size 416x240 \\
      --frames 10 --preset faster --qps 27 32 37 42 \\
      [--ref-bin path/to/vvencFFapp] [--intra-period 1] [--gop 8] \\
      [--device cuda|cpu]

The reference encoder is not part of the repository: --ref-bin names it
(a path, or a program on PATH; vvencFFapp by default), and the run
raises before it encodes anything when it is not there.

Output: per-point table + one JSON line
  {"bdrate_psnr_yuv": pct, "points_ours": [...], "points_ref": [...]}
(negative = we need fewer bits than the reference for equal quality).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np


def psnr(a, b, maxval):
    d = a.astype(np.float64) - b.astype(np.float64)
    mse = (d * d).mean()
    return 99.99 if mse == 0 else 10 * np.log10(maxval * maxval / mse)


def psnr_yuv(src_frames, rec_frames, bit_depth):
    """JVET PSNR-YUV = (6*Y + U + V) / 8, averaged over frames."""
    maxval = (1 << bit_depth) - 1
    ps = []
    for (sy, su, sv), (ry, ru, rv) in zip(src_frames, rec_frames):
        py, pu, pv = (psnr(sy, ry, maxval), psnr(su, ru, maxval),
                      psnr(sv, rv, maxval))
        ps.append((6 * py + pu + pv) / 8.0)
    return float(np.mean(ps))


def bd_rate(r1, p1, r2, p2):
    """Bjontegaard delta-rate of curve 2 vs curve 1 (%, negative = curve 2
    cheaper).  r*: bitrates, p*: quality (PSNR); piecewise-cubic-integral
    convention (JCTVC-E137 / the classic Excel macro)."""
    lr1, lr2 = np.log(np.asarray(r1)), np.log(np.asarray(r2))
    p1, p2 = np.asarray(p1, float), np.asarray(p2, float)
    f1 = np.polyfit(p1, lr1, 3)
    f2 = np.polyfit(p2, lr2, 3)
    lo = max(p1.min(), p2.min())
    hi = min(p1.max(), p2.max())
    if hi <= lo:
        raise ValueError("quality ranges do not overlap")
    i1 = np.polyint(f1)
    i2 = np.polyint(f2)
    int1 = np.polyval(i1, hi) - np.polyval(i1, lo)
    int2 = np.polyval(i2, hi) - np.polyval(i2, lo)
    avg_diff = (int2 - int1) / (hi - lo)
    return float((np.exp(avg_diff) - 1) * 100)


def read_yuv8(path, w, h, n):
    ysz, csz = w * h, (w // 2) * (h // 2)
    out = []
    with open(path, "rb") as f:
        for _ in range(n):
            y = np.frombuffer(f.read(ysz), np.uint8).reshape(h, w)
            u = np.frombuffer(f.read(csz), np.uint8).reshape(h // 2, w // 2)
            v = np.frombuffer(f.read(csz), np.uint8).reshape(h // 2, w // 2)
            out.append((y, u, v))
    return out


def read_yuv10(path, w, h, n):
    ysz, csz = w * h, (w // 2) * (h // 2)
    out = []
    with open(path, "rb") as f:
        for _ in range(n):
            y = np.frombuffer(f.read(2 * ysz), "<u2").reshape(h, w)
            u = np.frombuffer(f.read(2 * csz), "<u2").reshape(h // 2, w // 2)
            v = np.frombuffer(f.read(2 * csz), "<u2").reshape(h // 2, w // 2)
            out.append((y, u, v))
    return out


def run_ours(clip, w, h, n, qp, preset, intra_period, gop, tmp,
             device="cuda"):
    """One point of the port's curve: (bits, 10-bit reconstruction)."""
    from vvenc_tpu_torch.__main__ import main
    out = os.path.join(tmp, f"ours_q{qp}.266")
    rec = os.path.join(tmp, f"ours_q{qp}.yuv")
    argv = ["-i", clip, "-o", out, "-s", f"{w}x{h}", "-q", str(qp),
            "-f", str(n), "--preset", preset, "--recon", rec,
            "--intra-period", str(intra_period), "--device", device]
    if gop:
        argv += ["--gop-size", str(gop)]
    rc = main(argv)
    if rc not in (0, None):
        raise RuntimeError(f"our encoder failed at qp {qp} (exit {rc})")
    bits = os.path.getsize(out) * 8
    return bits, read_yuv10(rec, w, h, n)


def find_ref_bin(ref_bin):
    """The reference encoder's path: ref_bin itself when it is a file,
    else the program of that name on PATH; raises FileNotFoundError
    naming what it looked for."""
    if os.path.isfile(ref_bin):
        return ref_bin
    found = None if os.sep in ref_bin else shutil.which(ref_bin)
    if found is None:
        raise FileNotFoundError(
            f"reference encoder not found: {ref_bin!r} is not a file"
            + ("" if os.sep in ref_bin else " and not a program on PATH")
            + " (pass --ref-bin with the path of a vvencFFapp binary)")
    return found


def run_ref(ref_bin, clip, w, h, n, qp, preset, intra_period, gop, fr, tmp):
    out = os.path.join(tmp, f"ref_q{qp}.266")
    rec = os.path.join(tmp, f"ref_q{qp}.yuv")
    cmd = [find_ref_bin(ref_bin), "-i", clip, "-s", f"{w}x{h}", "-fr",
           str(fr), "--preset", preset, "-q", str(qp), "-f", str(n),
           "--Threads=1", "-b", out, "-o", rec]
    if intra_period == 1:
        cmd += ["--IntraPeriod=1"]
    elif gop:
        # the reference only supports GOP 16/32 with picture reordering
        # (vvencCfg.cpp:1617 rejects GOPSize=8 unless low-delay)
        if gop not in (16, 32):
            raise ValueError(
                f"reference RA comparison needs --gop 16 or 32, got {gop}")
        cmd += [f"--GOPSize={gop}", f"--IntraPeriod={intra_period}"]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=3600)
    if r.returncode != 0:
        raise RuntimeError(r.stdout + r.stderr)
    bits = os.path.getsize(out) * 8
    return bits, read_yuv10(rec, w, h, n)  # ref recon is 10-bit planar


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clip", required=True)
    ap.add_argument("--size", required=True)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--preset", default="faster")
    ap.add_argument("--qps", type=int, nargs="+", default=[27, 32, 37, 42])
    ap.add_argument("--intra-period", type=int, default=1)
    ap.add_argument("--gop", type=int, default=0)
    ap.add_argument("--framerate", type=int, default=15)
    ap.add_argument("--ref-bin", default="vvencFFapp",
                    help="the reference encoder: a path or a program on "
                         "PATH")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the port's device kernels run (cpu: their "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)
    ref_bin = find_ref_bin(args.ref_bin)
    w, h = (int(t) for t in args.size.lower().split("x"))
    src8 = read_yuv8(args.clip, w, h, args.frames)
    src10 = [tuple(p.astype(np.uint16) << 2 for p in f) for f in src8]

    ours, ref = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for qp in args.qps:
            b, rec = run_ours(args.clip, w, h, args.frames, qp, args.preset,
                              args.intra_period, args.gop, tmp, args.device)
            ours.append((b, psnr_yuv(src10, rec, 10)))
            b, rec = run_ref(ref_bin, args.clip, w, h, args.frames, qp,
                             args.preset, args.intra_period, args.gop,
                             args.framerate, tmp)
            ref.append((b, psnr_yuv(src10, rec, 10)))
            print(f"qp {qp}: ours {ours[-1][0]:9d} bits "
                  f"{ours[-1][1]:7.3f} dB | ref {ref[-1][0]:9d} bits "
                  f"{ref[-1][1]:7.3f} dB", file=sys.stderr)

    bd = bd_rate([r for r, _ in ref], [p for _, p in ref],
                 [r for r, _ in ours], [p for _, p in ours])
    print(json.dumps({"bdrate_psnr_yuv": round(bd, 2),
                      "points_ours": ours, "points_ref": ref}))


if __name__ == "__main__":
    main()

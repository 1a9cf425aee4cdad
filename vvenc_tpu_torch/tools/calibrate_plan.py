"""Calibrate the device RD plan's rate proxy / split bias.

The twin of tools/calibrate_plan.py for the PyTorch port.  Encodes a clip
at several QPs with the exact native search (ground truth) and with the
device plan under different constant settings (the VVENC_TPU_PLAN_*
variables that vvenc_tpu_torch/ops/intra_plan.py reads), and prints
(bits, PSNR) pairs + a BD-rate-style delta so the constants in
ops/intra_plan.py can be pinned to the best setting.

Usage: python -m vvenc_tpu_torch.tools.calibrate_plan [clip.yuv WxH frames]
           [--device cuda|cpu]

Without a clip it encodes the repository benchmark's 416x240 10-frame
clip (config 1's), made in a temporary directory.  Every encode writes
its stream into a temporary directory of its own.
"""

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

QPS = (32, 37, 42)

# variant -> the environment it encodes under; "exact" runs the native
# search alone (device_rd=off)
VARIANTS = {
    "exact": {},
    "plan-default": {},
    "plan-k3": {"VVENC_TPU_PLAN_K": "3"},
    "plan-split2": {"VVENC_TPU_PLAN_SPLIT": "2.0"},
    "plan-split4": {"VVENC_TPU_PLAN_SPLIT": "4.0"},
    "plan-c2lo": {"VVENC_TPU_PLAN_C2": "1.4"},
    "plan-c2hi": {"VVENC_TPU_PLAN_C2": "2.6"},
}


def encode(clip, w, h, n, qp, env, device_rd="on", device="cuda"):
    """(kbps, Y PSNR) of one all-intra faster encode in a process of its
    own (the plan's constants are read when its module is imported)."""
    e = dict(os.environ, **env)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, f"cal_{qp}.266")
        r = subprocess.run(
            [sys.executable, "-m", "vvenc_tpu_torch", "-i", clip, "-o", out,
             "-s", f"{w}x{h}", "-q", str(qp), "-f", str(n),
             "--preset", "faster", "--intra-period", "1",
             "--set", "device_rd=" + device_rd, "--device", device],
            capture_output=True, env=e, cwd=REPO, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"encode at qp {qp} failed: "
                           + r.stderr.decode()[-500:])
    lines = [ln for ln in r.stdout.decode().splitlines()
             if ln.startswith("summary:")]
    if not lines:
        raise RuntimeError(f"encode at qp {qp} printed no summary line")
    parts = lines[0].split("|")
    kbps = float(parts[1].split()[0])
    ypsnr = float(parts[2].split()[1])
    return kbps, ypsnr


def bd_delta(pts_ref, pts_test):
    """Crude BD-rate: average log-bitrate delta at matched PSNR via
    piecewise-linear interpolation over the overlapping PSNR range."""
    pr = sorted(pts_ref, key=lambda p: p[1])
    pt = sorted(pts_test, key=lambda p: p[1])
    lo = max(pr[0][1], pt[0][1])
    hi = min(pr[-1][1], pt[-1][1])
    if hi <= lo:
        return float("nan")
    xs = np.linspace(lo, hi, 50)

    def lr(pts, y):
        ys = [p[1] for p in pts]
        bs = [np.log(p[0]) for p in pts]
        return np.interp(y, ys, bs)
    d = np.mean([lr(pt, y) - lr(pr, y) for y in xs])
    return float(np.expm1(d) * 100)


def make_clip(path, w, h, frames):
    """The repository benchmark's smooth 8-bit 4:2:0 clip (bench.py)."""
    import scipy.ndimage as ndi
    rng = np.random.RandomState(7)
    base = ndi.gaussian_filter(
        rng.randint(0, 255, (h + 4 * frames, w + 4 * frames)
                    ).astype(np.float32), 3)
    base = (base - base.min()) / (base.max() - base.min()) * 200 + 20
    with open(path, "wb") as f:
        for i in range(frames):
            y = base[i:i + h, 2 * i:2 * i + w].astype(np.uint8)
            u = (y[::2, ::2] // 2 + 60).astype(np.uint8)
            v = (128 - y[::2, ::2] // 3).astype(np.uint8)
            f.write(y.tobytes())
            f.write(u.tobytes())
            f.write(v.tobytes())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("clip", nargs="?", default=None)
    ap.add_argument("size", nargs="?", default="416x240")
    ap.add_argument("frames", nargs="?", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the device kernels run (cpu: their plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    w, h = (int(t) for t in args.size.split("x"))
    with tempfile.TemporaryDirectory() as tmp:
        clip = args.clip
        if clip is None:
            clip = os.path.join(tmp, "bench_clip.yuv")
            make_clip(clip, w, h, args.frames)
        results = {}
        for name, env in VARIANTS.items():
            pts = [encode(clip, w, h, args.frames, qp, env,
                          device_rd="off" if name == "exact" else "on",
                          device=args.device)
                   for qp in QPS]
            results[name] = pts
            print(name, [(round(b, 1), round(p, 3)) for b, p in pts],
                  flush=True)
    ref = results["exact"]
    for name, pts in results.items():
        if name == "exact":
            continue
        print("%-14s BD-rate vs exact: %+.2f%%" % (name,
                                                   bd_delta(ref, pts)))


if __name__ == "__main__":
    main()

"""End-to-end encoder benchmark of the PyTorch port on one NVIDIA card.

The twin of the repository's bench.py for vvenc_tpu_torch: the same three
runs (BASELINE configs 1-3) on the same clips with the same options, each
encoded in this process through the port's CLI
(`vvenc_tpu_torch.__main__.main`), on the card unless --device cpu is
given.

    python -m vvenc_tpu_torch.bench [--device cuda|cpu] [--ref-bin PATH]

Each stage first runs a warm encode with --verify (the decoder held equal
to the reconstruction; the first one also builds the kernels and the
native library), then its timed passes without --verify, each the wall
time of one CLI call.  Every timed stream must equal the warm stream, or,
where the warm encode is shorter than the timed one (config 3), decode to
the encoder's reconstruction.  A stage runs under a wall limit; a stage
that fails raises and one that overruns its limit ends the process with a
non-zero code naming it: no JSON line is printed then.

Prints one JSON line last, in the shape of bench.py's: "metric", "value"
(config 1's median frames/s), "unit", "vs_baseline", "vs_baseline_1t",
"device_time_fraction", "secondary" (configs 2 and 3: frames/s, the
reference's and the ratio), plus "runs" (per run every pass's frames/s,
median, spread, the median pass's device-time share and kernel launches),
"card" (nvidia-smi's name and power limit) and "host" (CPU count, the
frame-parallel pool's size per run).  The reference encoder is measured
only when --ref-bin names one; without it every reference rate and ratio
is null.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from . import __main__ as cli
from .decoder import decode_stream
from .device import resolve_device
from .ops import kernels
from .tools.bdrate import find_ref_bin
from .tools.calibrate_plan import make_clip
from .utils.devclock import DEV

REF_BIN = "/tmp/refbuild/vvencFFapp"


@dataclasses.dataclass(frozen=True)
class Stage:
    key: str              # its rate's key in the summary and in "runs"
    w: int
    h: int
    frames: int
    qp: int
    preset: str
    extra: tuple          # CLI options past size, QP, frames and preset
    warm_frames: int
    passes: int
    limit_s: float        # wall limit: the warm encode and the passes
    ref_extra: tuple      # the reference encoder's options beside ours
    ref_timeout: float


# bench.py's three runs; config 2 warms on its whole clip (bench.py: 9
# frames) so that its timed stream is held to a verified one, config 3 on
# 3 frames (a pass takes minutes)
STAGES = (
    Stage("ai_416x240_faster_fps", 416, 240, 10, 37, "faster",
          ("--intra-period", "1"), 10, 3, 300.0, ("--IntraPeriod=1",),
          120.0),
    Stage("ra_832x480_gop8_faster_fps", 832, 480, 17, 37, "faster",
          ("--gop-size", "8", "--intra-period", "0"), 17, 3, 300.0,
          ("--IntraPeriod=64",), 240.0),
    Stage("ra_1080p_gop4_medium_qpa_fps", 1920, 1080, 9, 32, "medium",
          ("--gop-size", "2", "--intra-period", "0", "--qpa", "1", "--wpp",
           "--threads", "2"), 3, 1, 620.0,
          ("--IntraPeriod=64", "--PerceptQPA=1"), 300.0),
)


def encode_once(clip, out, w, h, frames, qp, preset, extra=(),
                device="cuda", verify=False):
    """One run of the port's CLI in this process: (wall seconds of the
    call, the encoder it built).  Raises if the CLI fails."""
    built = []

    class Recorded(cli.IntraEncoder):
        def __init__(self, cfg):
            super().__init__(cfg)
            built.append(self)

    argv = ["-i", clip, "-o", out, "-s", f"{w}x{h}", "-q", str(qp),
            "-f", str(frames), "--preset", preset, *extra,
            "--device", device] + (["--verify"] if verify else [])
    orig = cli.IntraEncoder
    cli.IntraEncoder = Recorded
    try:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        dt = time.perf_counter() - t0
    finally:
        cli.IntraEncoder = orig
    if rc != 0:
        raise RuntimeError(f"the CLI returned {rc} for {' '.join(argv)}")
    return dt, built[-1]


def check_decodes(stream: bytes, enc, frames: int) -> None:
    """The stream decodes to `frames` pictures equal to the encoder's
    reconstruction (one IDR: POCs are unique)."""
    dec = decode_stream(stream)
    if len(dec) != frames:
        raise RuntimeError(f"decoded {len(dec)} pictures, expected {frames}")
    for fr in dec:
        for c in range(3):
            if not np.array_equal(fr.planes[c], enc.recs_by_poc[fr.poc][c]):
                raise RuntimeError(f"decoded POC {fr.poc} plane {c} differs "
                                   "from the reconstruction")


@contextlib.contextmanager
def wall_limit(key: str, seconds: float, cleanup: str):
    """Ends the process (exit code 1) with a message naming the stage if
    the block runs past `seconds`, removing `cleanup` first: the
    encoder's worker threads cannot be stopped from outside, so nothing
    short of an exit ends an overrun."""
    def overrun():
        sys.stderr.write(f"bench: FAIL: stage {key} overran its wall limit "
                         f"of {seconds} s\n")
        sys.stderr.flush()
        shutil.rmtree(cleanup, ignore_errors=True)
        os._exit(1)
    timer = threading.Timer(seconds, overrun)
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()


def run_stage(st: Stage, clip: str, workdir: str, device: str = "cuda"):
    """The stage on `clip`: the warm encode with --verify, then st.passes
    timed passes, kernel launch counts and the device clock set to 0
    before each and read after it.  Returns (record, stream, encoder):
    record = {"fps": every pass's frames/s, "median_fps", "spread"
    ((max - min) / median), "device_share" (the median pass's; None on
    the CPU), "launches" (the median pass's nonzero counts)}."""
    warm_out = os.path.join(workdir, f"{st.key}_warm.266")
    out = os.path.join(workdir, f"{st.key}.266")
    with wall_limit(st.key, st.limit_s, workdir):
        encode_once(clip, warm_out, st.w, st.h, st.warm_frames, st.qp,
                    st.preset, st.extra, device, verify=True)
        passes = []
        stream = None
        for _ in range(st.passes):
            kernels.reset_launches()
            DEV.reset()
            dt, enc = encode_once(clip, out, st.w, st.h, st.frames, st.qp,
                                  st.preset, st.extra, device)
            passes.append((st.frames / dt, DEV.seconds / dt,
                           {k: v for k, v in kernels.launches.items() if v}))
            with open(out, "rb") as f:
                got = f.read()
            if stream is not None and got != stream:
                raise RuntimeError(f"{st.key}: timed passes wrote different "
                                   "streams")
            stream = got
        if st.warm_frames == st.frames:
            with open(warm_out, "rb") as f:
                if f.read() != stream:
                    raise RuntimeError(f"{st.key}: the timed stream differs "
                                       "from the verified warm stream")
        else:
            check_decodes(stream, enc, st.frames)
    fps = [p[0] for p in passes]
    mid = sorted(range(len(passes)), key=lambda i: fps[i])[len(passes) // 2]
    record = {"fps": fps, "median_fps": fps[mid],
              "spread": (max(fps) - min(fps)) / fps[mid],
              "device_share": passes[mid][1] if device == "cuda" else None,
              "launches": passes[mid][2]}
    return record, stream, enc


def ref_fps(ref_bin, st: Stage, clip, out, extra, runs=1) -> float:
    """frames/s of the reference encoder on the stage's clip and options
    (the last of `runs` runs timed, as bench.py measures it)."""
    cmd = [ref_bin, "-i", clip, "-s", f"{st.w}x{st.h}", "-fr", "15",
           "--preset", st.preset, "-q", str(st.qp), "-f", str(st.frames),
           "-b", out, *extra]
    for _ in range(runs):
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, timeout=st.ref_timeout)
        dt = time.perf_counter() - t0
        if r.returncode != 0:
            raise RuntimeError(f"the reference encoder returned "
                               f"{r.returncode}: {r.stderr[-300:]!r}")
    return st.frames / dt


def card_line(device: str) -> str:
    if device == "cpu":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def ratio(a, b):
    return None if a is None or b is None else a / b


def summary(card, runs, refs, host) -> dict:
    """The JSON line: bench.py's keys, then "runs", "card" and "host".
    refs: the reference's frames/s per stage key (config 1's at
    --Threads=1 under "<key>_1t"), None without a reference encoder."""
    c1, *sec = STAGES
    fps = runs[c1.key]["median_fps"]
    secondary = {}
    for st in sec:
        secondary[st.key] = runs[st.key]["median_fps"]
        secondary[st.key + "_ref"] = refs[st.key]
        secondary[st.key + "_vs_ref"] = ratio(runs[st.key]["median_fps"],
                                              refs[st.key])
    return {
        "metric": (
            "e2e all-intra 416x240 QP37 preset-faster encode through "
            "vvenc_tpu_torch's CLI in process, frames/s, median of "
            f"{c1.passes} warm passes on {card} (BASELINE config 1; "
            f"secondaries: config 2 the median of {sec[0].passes} warm "
            f"passes, config 3 {sec[1].passes} warm in-process pass after "
            f"a {sec[1].warm_frames}-frame warm encode, not bench.py's "
            "cold subprocess rate; vs_baseline against the reference "
            "encoder at its default threads, vs_baseline_1t at "
            "--Threads=1, null without a reference encoder)"),
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": ratio(fps, refs[c1.key]),
        "vs_baseline_1t": ratio(fps, refs[c1.key + "_1t"]),
        "device_time_fraction": runs[c1.key]["device_share"],
        "secondary": secondary,
        "runs": runs,
        "card": card,
        "host": host,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the device kernels run (cpu: their plain "
                         "PyTorch versions)")
    ap.add_argument("--ref-bin", default=REF_BIN,
                    help="the reference encoder (vvencFFapp), measured on "
                         "the same clips when it is there")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    card = card_line(args.device)
    try:
        ref_bin = find_ref_bin(args.ref_bin)
    except FileNotFoundError:
        ref_bin = None
    runs = {}
    refs = dict.fromkeys([st.key for st in STAGES]
                         + [STAGES[0].key + "_1t"])
    host = {"cpu_count": os.cpu_count(), "max_parallel_frames": {}}
    with tempfile.TemporaryDirectory(prefix="vvenc_bench_") as tmp:
        for st in STAGES:
            clip = os.path.join(tmp, f"{st.key}.yuv")
            make_clip(clip, st.w, st.h, st.frames)
            rec, _, enc = run_stage(st, clip, tmp, args.device)
            runs[st.key] = rec
            host["max_parallel_frames"][st.key] = \
                enc.cfg.max_parallel_frames
            sys.stderr.write(f"bench: {st.key} {json.dumps(rec)}\n")
            ref_out = os.path.join(tmp, f"{st.key}_ref.266")
            if ref_bin is None:
                continue
            if st is STAGES[0]:
                refs[st.key] = ref_fps(ref_bin, st, clip, ref_out,
                                       st.ref_extra, runs=2)
                refs[st.key + "_1t"] = ref_fps(
                    ref_bin, st, clip, ref_out,
                    st.ref_extra + ("--Threads=1",), runs=2)
            else:
                refs[st.key] = ref_fps(ref_bin, st, clip, ref_out,
                                       st.ref_extra)
    print(json.dumps(summary(card, runs, refs, host)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

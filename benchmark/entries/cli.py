"""The `cli` entry: whole clips encoded back to back through the port's
CLI, vvenc_tpu_torch.__main__.main, in this process (traffic/file.json).

An entry is a file of benchmark/entries/, found by the `entry` that a
traffic mix names: a `Driver(run)` with warm() and measure(seconds,
on_start), and `judge(run, driver, result)`, which gives the compared
numbers of the window.  The driver makes its pictures in set-up, warms
the entry with the same options on `warm_frames` pictures, then
measures; the window's readings and what the comparison needs are
returned, never judged inside the window.

Every encode of the window codes the same clip, so every stream must be
the same as the first's, which is judged in full: its stream decoded by
the reference, and the plans of a seeded sample of its pictures.
"""

from __future__ import annotations

import contextlib
import io
import os
import time

from .. import check
from .. import clip as clipgen
from .. import window as win


def cli_argv(cfg: dict, src: str, out: str, frames: int, device: str):
    argv = ["-i", src, "-o", out, "-s", f"{cfg['width']}x{cfg['height']}",
            "-q", str(cfg["qp"]), "-f", str(frames), "--preset",
            cfg["preset"], "-r", str(cfg["framerate"]),
            "--input-bitdepth", str(cfg["input_bit_depth"]),
            "--internal-bitdepth", str(cfg["internal_bit_depth"]),
            "--intra-period", str(cfg["intra_period"]),
            "--gop-size", str(cfg["gop_size"]), "--device", device]
    for k, v in cfg.get("set", {}).items():
        argv += ["--set", f"{k}={v}"]
    return argv


class Driver:
    def __init__(self, run):
        self.run = run
        cfg = run.cfg
        self.frames = cfg["clip_frames"]
        self.pictures = clipgen.make_clip(run.seed, cfg["width"],
                                          cfg["height"], self.frames,
                                          cfg.get("clip"))
        self.src = os.path.join(run.tmp, "clip.yuv")
        clipgen.write_yuv(self.src, self.pictures)

    def _encode(self, out: str, frames: int, keep: bool):
        from vvenc_tpu_torch import __main__ as cli
        built = []
        if keep:
            class Kept(cli.IntraEncoder):
                def __init__(self, c):
                    super().__init__(c)
                    built.append(self)
            orig, cli.IntraEncoder = cli.IntraEncoder, Kept
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(cli_argv(self.run.cfg, self.src, out, frames,
                                       self.run.device))
        finally:
            if keep:
                cli.IntraEncoder = orig
        if rc != 0:
            raise RuntimeError(f"the CLI returned {rc}")
        return built[0] if keep else None

    def warm(self):
        self._encode(os.path.join(self.run.tmp, "warm.266"),
                     self.run.cfg["warm_frames"], False)

    def measure(self, seconds: float, on_start=None):
        probes = self.run.probes
        ends, outs, failed = [], [], 0
        kept = None
        t0 = time.perf_counter()
        if on_start:
            on_start()
        i = 0
        while time.perf_counter() - t0 < seconds:
            keep = i == 0
            probes.keep = keep
            out = os.path.join(self.run.tmp, f"enc{i}.266")
            try:
                enc = self._encode(out, self.frames, keep)
            except Exception as exc:          # noqa: BLE001 - counted
                failed += 1
                self.run.log(f"encode {i} failed: {exc!r}")
                break
            ends.append(time.perf_counter() - t0)
            outs.append(out)
            if keep:
                kept = enc
            i += 1
        probes.keep = False
        streams = []
        for out in outs:
            with open(out, "rb") as f:
                streams.append(f.read())
        fps = win.encode_fps([(t, self.frames) for t in ends], 0.0,
                             float(seconds))
        return {"attempted": i + failed, "failed": failed,
                "streams": streams, "kept": kept,
                "encode_s": [b - a for a, b in zip([0.0] + ends, ends)],
                "frames_traced": self.frames * len(ends),
                "e2e": {"encode_fps": fps}}


def judge(run, drv, res) -> dict:
    """The compared numbers of the window, and "_rd_cost", the window's
    rd_cost_per_frame, from pictures that the comparison judged."""
    cfg = run.cfg
    shift = cfg["internal_bit_depth"] - cfg["input_bit_depth"]
    streams, kept = res["streams"], res["kept"]
    pics = drv.pictures
    nums = {"stream_differs": sum(s != streams[0] for s in streams)
            if kept else 1}
    run.kept_stream = streams[0] if kept else b""
    recons = [kept.recs_by_poc[p] for p in sorted(kept.recs_by_poc)] \
        if kept else []
    if cfg["intra_period"] == 1:
        # all-intra: every picture decodes alone, in parallel
        aus = check.access_units(run.kept_stream)
        ok = len(aus) == len(recons) == len(pics)
        bad = check.judge_intra_pictures(
            aus, recons, range(len(pics)), run.workers) if ok else len(pics)
        dec = recons if bad == 0 else None
    else:
        bad, dec = check.judge_stream(run.kept_stream, recons, len(pics))
    nums["recon_mismatch"] = bad
    nums["_rd_cost"] = None if dec is None else check.rd_cost(
        dec, pics, shift, run.lam, len(run.kept_stream))
    if "plans_missing" in run.limits:
        only = run.plan_sample
        p = check.judge_plans(run.probes.plans, [s[0] for s in pics], shift,
                              only)
        nums.update(p)
        nums["plans_missing"] = len(only) - p["plans_judged"]
    return nums

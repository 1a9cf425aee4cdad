"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the metrics; used by run.py on the card and by the
tests on the CPU (device="cpu": the kernels' plain versions, a rehearsal
of the control flow whose numbers are no device metrics).

The run's order is fixed by the contract: build and warm up (set-up),
measure for `seconds` (traced by torch.profiler with trace=True), read
the peak device memory, free the program's state, then judge what the
window produced with the reference, and last read the per-layer
metrics.
"""

from __future__ import annotations

import gc
import os
import sys
import tempfile
import time

import numpy as np
import torch

from . import check, spec
from .probes import Probes

# processes that decode all-intra pictures for the comparison, once the
# window has closed
WORKERS = len(os.sched_getaffinity(0))


class Run:
    def __init__(self, bench, cell, seed, seconds, trace, device="cuda",
                 cfg_override=None, mix_override=None, limits=None):
        self.bench = bench
        self.cell = spec.workload(bench, cell)
        self.name = cell
        self.cfg = dict(spec.config(bench, self.cell["config"]))
        self.cfg.update(cfg_override or {})
        self.mix = spec.traffic(self.cell["traffic"], self.cell["config"])
        self.mix.update(mix_override or {})
        self.limits = limits if limits is not None else spec.limits(cell)
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.probes = Probes()
        self.entry = spec.entry(self.mix["entry"])
        self.workers = WORKERS
        self.lam = spec.reader("rd_cost_per_frame").lambda_for(self.cfg)
        # the pictures whose plans are judged, drawn from the seed
        n = self.cfg["clip_frames"]
        k = min(int(self.mix.get("plan_sample", 0)), n)
        self.plan_sample = set(
            int(i) for i in seed_rng(self.seed, 4).choice(n, k,
                                                          replace=False))
        self.tmp = None
        self.kept_stream = None   # the judged stream of a file cell

    @staticmethod
    def log(msg: str) -> None:
        sys.stderr.write(f"bench: {msg}\n")
        sys.stderr.flush()


def seed_rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64([int(seed) & ((1 << 63) - 1),
                                                salt]))


def build(device: str) -> None:
    """The port's kernels and native library, built into its fixed
    _build/ directories at the first run of a checkout."""
    from vvenc_tpu_torch import native
    if not native.available():
        raise RuntimeError("the native library did not build: "
                           f"{native.BUILD_ERROR}")
    if device == "cuda":
        from vvenc_tpu_torch.ops import kernels
        kernels.build()


def run_cell(run: Run, t_start: float) -> dict:
    """The result of one run (the JSON line's keys), with "checks":
    [(name, value, limit)] last."""
    from . import timeline as tr
    build(run.device)
    prof_obj = None
    undo_marks = None
    host_spans, marks = [], {}
    if run.trace:
        from vvenc_tpu_torch.utils.profiler import PROF
        if not PROF.enabled:
            raise RuntimeError("the traced run needs VVENC_TPU_PROFILE=1 "
                               "before the port is imported")
        prof_obj = PROF
        host_spans, undo_marks = tr.note_prof_spans(PROF)
    with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
        run.tmp = tmp
        drv = run.entry.Driver(run)
        run.driver_pictures = drv.pictures
        shift = run.cfg["internal_bit_depth"] - run.cfg["input_bit_depth"]
        run.probes.targets = [
            (i, drv.pictures[i][0].astype(np.int32) << shift)
            for i in sorted(run.plan_sample)]
        drv.warm()
        run.probes.install()
        cuda = run.device == "cuda"
        if cuda:
            torch.cuda.synchronize()
        spans0 = {}

        def on_start():
            marks["setup_s"] = time.time() - t_start
            if prof_obj is not None:
                spans0.update(_spans(prof_obj))

        prof = tr.profiler() if run.trace else None
        try:
            if prof is not None:
                prof.start()
                marks["window_ns"] = time.time_ns()
                with torch.profiler.record_function(tr.WINDOW):
                    res = drv.measure(run.seconds, on_start)
                    if cuda:
                        torch.cuda.synchronize()
                prof.stop()
            else:
                res = drv.measure(run.seconds, on_start)
                if cuda:
                    torch.cuda.synchronize()
        finally:
            run.probes.uninstall()
            if undo_marks:
                undo_marks()
        counts = run.probes.counts()
        device = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                  "count": 1,
                  "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
                  if cuda else 0}
        timeline = tr.Timeline.from_profiler(
            prof, host_spans, marks["window_ns"]) if prof is not None \
            else None
        spans = {}
        if prof_obj is not None:
            s1 = _spans(prof_obj)
            spans = {k: v - spans0.get(k, 0.0) for k, v in s1.items()}
        del prof
        numbers = run.entry.judge(run, drv, res)
        res.pop("kept", None)
        gc.collect()
    metrics = {}
    if not run.trace:
        e2e = dict(res["e2e"])
        e2e["setup_s"] = marks["setup_s"]
        e2e["rd_cost_per_frame"] = numbers.pop("_rd_cost")
        for m in spec.metrics_for(run.bench, run.name, "end_to_end"):
            v = e2e.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        numbers.pop("_rd_cost")
        ctx = LayerContext(run, timeline, spans, res, counts)
        for m in spec.metrics_for(run.bench, run.name, "per_layer"):
            v = spec.reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device["busy_s"] = timeline.busy_s
        device["window_s"] = timeline.window_s
    correct, rows = check.verdict(numbers, run.limits)
    out = {"correct": bool(correct and res["failed"] == 0),
           "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": device}
    if run.trace:
        out["breakdown"] = {
            "device_ops": [[n, s] for n, s in timeline.device_ops()],
            "idle_gaps": [[n, s] for n, s in timeline.idle_gaps()]}
    out["info"] = {k: v for k, v in numbers.items() if k not in run.limits}
    out["info"].update(counts)
    if "encode_s" in res:
        out["info"]["encode_s"] = res["encode_s"]
    out["checks"] = rows
    return out


def _spans(prof_obj) -> dict:
    with prof_obj._lock:
        return {k: v[0] for k, v in prof_obj._acc.items()}


class LayerContext:
    """What a per-layer reader reads: the traced window's timeline, the
    PROF spans' seconds inside it, the pictures coded in it, the probes'
    counts and work, and the cell's configuration."""

    def __init__(self, run, timeline, spans, res, counts):
        self.run = run
        self.cfg = run.cfg
        self.timeline = timeline
        self.spans = spans
        self.frames = res["frames_traced"]
        self.counts = counts
        self.plan_work = run.probes.plan_work

    def span_ms_per_frame(self, name: str):
        s = self.spans.get(name)
        if not s or not self.frames:
            return None
        return s * 1000.0 / self.frames

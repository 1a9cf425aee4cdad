"""The traced run's readings: torch.profiler over the window, and the
port's PROF spans laid on the profiler's timeline.

PROF (vvenc_tpu_torch.utils.profiler, on with VVENC_TPU_PROFILE=1) sums
seconds per span name over all threads.  In the traced run the harness
also notes each PROF section's start and end on the host clock, in
every thread (the frame-parallel pool's threads too), so that an idle
stretch of the device can be named by the host span that was open
during it.  The window is the profiler range "bench.window"; its start
on the host clock aligns the spans with the profiler's timeline.
"""

from __future__ import annotations

import time

WINDOW = "bench.window"


class _Noted:
    __slots__ = ("inner", "name", "spans", "t0")

    def __init__(self, inner, name, spans):
        self.inner, self.name, self.spans = inner, name, spans

    def __enter__(self):
        self.inner.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.spans.append((self.name, self.t0, time.time_ns()))
        return self.inner.__exit__(*exc)


def note_prof_spans(prof_obj):
    """Note every PROF section's (name, start ns, end ns) on the host
    clock; returns (the list they go to, an undo)."""
    orig = prof_obj.section
    spans = []

    def section(name):
        return _Noted(orig(name), name, spans)

    prof_obj.section = section
    return spans, lambda: setattr(prof_obj, "section", orig)


def profiler():
    import torch
    from torch.profiler import ProfilerActivity
    return torch.profiler.profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
        record_shapes=False, with_stack=False, profile_memory=False)


def union(intervals):
    """Merged, sorted [(start, end)] of possibly overlapping intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


class Timeline:
    """The traced window's device and host intervals, in seconds on the
    profiler's clock: device = [(name, start, end)] of every kernel,
    copy and set on the card; spans = [(name, start, end)] of the PROF
    sections; window = (start, end) of "bench.window"."""

    def __init__(self, device, spans, window):
        self.window = window
        lo, hi = window
        self.device = [(n, max(s, lo), min(e, hi)) for n, s, e in device
                       if e > lo and s < hi]
        self.spans = spans

    @classmethod
    def from_profiler(cls, prof, host_spans=(), host_window_ns=None):
        """host_spans: (name, start ns, end ns) on the host clock, whose
        window started at host_window_ns."""
        from torch.autograd import DeviceType
        device, window = [], None
        for ev in prof.profiler.kineto_results.events():
            s = ev.start_ns() * 1e-9
            e = s + ev.duration_ns() * 1e-9
            name = ev.name()
            if ev.device_type() == DeviceType.CUDA:
                # host ranges show on the device's timeline too, as
                # annotations: they are no device work
                if name != WINDOW and not getattr(
                        ev, "is_user_annotation", lambda: False)():
                    device.append((name, s, e))
            elif name == WINDOW:
                window = (s, e)
        if window is None:
            raise RuntimeError("the trace holds no window range")
        off = 0.0 if host_window_ns is None else \
            window[0] - host_window_ns * 1e-9
        spans = [(n, a * 1e-9 + off, b * 1e-9 + off)
                 for n, a, b in host_spans]
        return cls(device, spans, window)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self):
        return union((s, e) for _, s, e in self.device)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def device_seconds(self, match) -> float:
        """Summed device time of the operations whose name `match`
        accepts (overlaps count once)."""
        return sum(e - s for s, e in union(
            (s, e) for n, s, e in self.device if match(n)))

    def device_ops(self, top: int = 10):
        """[(name, seconds)] of the device operations that took most
        time, summed by name."""
        tot = {}
        for n, s, e in self.device:
            tot[n] = tot.get(n, 0.0) + (e - s)
        return sorted(tot.items(), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10):
        """[(name, seconds)] of the longest stretches in which the device
        ran nothing, each named by the PROF span that covers most of it
        ("host" when none is open)."""
        lo, hi = self.window
        gaps, t = [], lo
        for s, e in self.busy():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for g0, g1 in gaps[:top]:
            cover = {}
            for n, s, e in self.spans:
                ov = min(e, g1) - max(s, g0)
                if ov > 0:
                    cover[n] = cover.get(n, 0.0) + ov
            name = max(cover, key=cover.get) if cover else "host"
            out.append((name, g1 - g0))
        return out

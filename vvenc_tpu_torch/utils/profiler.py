"""Span recorder of the encoder's host stages (vvenc TimeProfiler analog).

Reference: vvenc CommonLib/TimeProfiler.h:124 (ENABLE_TIME_PROFILING) —
compile-gated stage timers with a report table.  Here: env-gated
(`VVENC_TPU_PROFILE=1`) and thread-safe.  Every `section(name)` appends
one `Span` record: its name, its id and the id of the span still open on
the same thread (its parent), the thread, the picture the thread is
coding (`picture(poc)`, else None), its start and end on `time.time_ns()`
(the clock torch.profiler stamps its events with, so spans and device
work share one timeline) and the thread's CPU time over it
(`time.thread_time_ns()`).  Wall minus CPU is the time the thread was
off the CPU: waiting for the GIL, a lock, a device fetch, the scheduler.

The buffer holds at most `max_records` records and counts what it drops;
`records()` gives a copy.  `_acc` keeps, per name, the wall seconds
summed over threads and the calls; the benchmark's harness reads it.
When disabled, `section` and `picture` return a shared no-op and read no
clock and take no lock.

Usage:
    from vvenc_tpu_torch.utils.profiler import PROF
    with PROF.picture(poc):
        with PROF.section("slice.ctu_search"):
            ...
    PROF.report()   # prints the table when enabled
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import NamedTuple, Optional

# records kept before dropping: a 416x240 all-intra picture writes about
# 80, so a traced minute of the benchmark (about 11,000) keeps under a
# twentieth
MAX_RECORDS = 1 << 18
PICTURE = "pic.encode"


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]     # the span open on the thread when it opened
    thread: int               # threading.get_ident()
    thread_name: str
    poc: Optional[int]        # the picture the thread was coding
    start_ns: int             # time.time_ns()
    end_ns: int
    cpu_ns: int               # time.thread_time_ns() over the span


class _NullSection:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NULL = _NullSection()


class _ThreadState(threading.local):
    def __init__(self):
        self.open = []        # ids of the spans open, innermost last
        self.poc = None


class _Section:
    __slots__ = ("prof", "name", "poc", "prev_poc", "id", "parent", "t0",
                 "c0")

    def __init__(self, prof, name, poc=None):
        self.prof = prof
        self.name = name
        self.poc = poc        # set for a picture's span only

    def __enter__(self):
        st = self.prof._tls
        self.parent = st.open[-1] if st.open else None
        self.id = next(self.prof._ids)
        st.open.append(self.id)
        if self.poc is not None:
            self.prev_poc, st.poc = st.poc, self.poc
        self.c0 = time.thread_time_ns()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *a):
        t1 = time.time_ns()
        c1 = time.thread_time_ns()
        st = self.prof._tls
        st.open.pop()
        poc = st.poc
        if self.poc is not None:
            st.poc = self.prev_poc
        th = threading.current_thread()
        self.prof._record(Span(self.name, self.id, self.parent, th.ident,
                               th.name, poc, self.t0, t1, c1 - self.c0))
        return False


class Profiler:
    def __init__(self, enabled: bool, max_records: int = MAX_RECORDS):
        self.enabled = enabled
        self.max_records = max_records
        self.dropped = 0
        self._lock = threading.Lock()
        self._acc = {}     # name -> [wall seconds summed over threads, calls]
        self._cpu = {}     # name -> thread CPU seconds summed
        self._records = []
        self._ids = itertools.count(1)
        self._tls = _ThreadState()
        self._t0 = time.time() if enabled else 0.0

    def section(self, name: str):
        """A span named `name`, nested in the span open on this thread."""
        if not self.enabled:
            return _NULL
        return _Section(self, name)

    def picture(self, poc: int):
        """The span of coding picture `poc` on this thread (`pic.encode`):
        every span opened inside it carries the POC.  Recorded by the
        profiler itself, not through `section`, so that a wrapper of
        `section` sees only the stages."""
        if not self.enabled:
            return _NULL
        return _Section(self, PICTURE, poc)

    def _record(self, span: Span) -> None:
        with self._lock:
            ent = self._acc.setdefault(span.name, [0.0, 0])
            ent[0] += (span.end_ns - span.start_ns) * 1e-9
            ent[1] += 1
            self._cpu[span.name] = self._cpu.get(span.name, 0.0) \
                + span.cpu_ns * 1e-9
            if len(self._records) < self.max_records:
                self._records.append(span)
            else:
                self.dropped += 1

    def records(self) -> list:
        """A copy of the records kept, in the order the spans ended."""
        if not self.enabled:
            return []
        with self._lock:
            return list(self._records)

    def report(self, out=None) -> str:
        """The table per span name: wall seconds summed over threads,
        thread CPU seconds, the share of the wall off the CPU, calls and
        the wall sum against the profiler's lifetime (above 100 % when
        threads overlap); printed to `out`."""
        if not self.enabled or not self._acc:
            return ""
        wall = time.time() - self._t0
        with self._lock:
            rows = sorted(((n, t, self._cpu.get(n, 0.0), c)
                           for n, (t, c) in self._acc.items()),
                          key=lambda r: -r[1])
            dropped, kept = self.dropped, len(self._records)
        lines = ["== vvenc_tpu_torch time profile (wall %.2fs) ==" % wall,
                 "%-36s %10s %10s %8s %8s %7s" % (
                     "stage", "wall[s]", "cpu[s]", "off-cpu", "calls",
                     "%wall")]
        for name, tot, cpu, calls in rows:
            off = 100.0 * (1.0 - cpu / tot) if tot > 0 else 0.0
            lines.append("%-36s %10.3f %10.3f %7.1f%% %8d %6.1f%%"
                         % (name, tot, cpu, off, calls,
                            100.0 * tot / max(wall, 1e-9)))
        lines.append("records kept %d, dropped %d (at most %d kept)"
                     % (kept, dropped, self.max_records))
        text = "\n".join(lines)
        print(text, file=out)
        return text


PROF = Profiler(os.environ.get("VVENC_TPU_PROFILE", "0") == "1")

"""The arithmetic of a measured window, on host-clock readings in
seconds, and the spread of a metric over runs."""

from __future__ import annotations

import statistics


def encode_fps(encodes, t0: float, t_close: float):
    """Frames a second over the window of back-to-back file encodes.

    encodes: [(t_end, frames)] in the order they finished.  The rate
    counts every frame of the encodes that ended by t_close, divided by
    the time from t0 to the end of the last of them, so a stall anywhere
    in that stretch lowers it.  None when no encode ended in the window.
    """
    done = [(t, n) for t, n in encodes if t <= t_close]
    if not done:
        return None
    return sum(n for _, n in done) / (max(t for t, _ in done) - t0)


def spread(values):
    """The distance between the first and third quartiles as a share of
    the median (statistics.quantiles with n=4)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med

"""The window arithmetic: encode_fps and the quartile spread."""

import statistics

import pytest

from benchmark import window as win


def test_encode_fps_counts_encodes_that_ended_in_the_window():
    # three 10-frame encodes end at 2, 4 and 6 s; a fourth ends past 7 s
    enc = [(2.0, 10), (4.0, 10), (6.0, 10), (8.0, 10)]
    assert win.encode_fps(enc, 0.0, 7.0) == pytest.approx(30 / 6.0)


def test_encode_fps_sees_a_stall_inside_a_clip():
    steady = win.encode_fps([(2.0, 10), (4.0, 10), (6.0, 10)], 0.0, 7.0)
    stalled = win.encode_fps([(2.0, 10), (5.0, 10), (7.0, 10)], 0.0, 7.0)
    assert stalled == pytest.approx(30 / 7.0)
    assert stalled < steady


def test_encode_fps_without_a_finished_encode_is_none():
    assert win.encode_fps([(9.0, 10)], 0.0, 7.0) is None


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [9.0, 10.0, 10.0, 10.0, 11.0, 12.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert win.spread(xs) == pytest.approx((q3 - q1) / med)

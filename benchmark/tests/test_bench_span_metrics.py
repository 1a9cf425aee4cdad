"""The readers of the port's PROF records (benchmark/spans.py and
metrics/pool_wait_share, host_cpu_ms_per_frame, cabac_cpu_ms_per_frame,
filters_cpu_ms_per_frame) on synthetic records: only pictures whose span
ended inside the window count, only spans under them, and a port whose
PROF keeps no records gives nothing."""

from types import SimpleNamespace

import pytest

from benchmark import spec
from vvenc_tpu_torch.utils import profiler
from vvenc_tpu_torch.utils.profiler import PICTURE, Profiler, Span

S = 1_000_000_000          # ns a second
WINDOW = (1000.0, 1010.0)  # seconds on time.time_ns()'s clock


def _span(name, id_, parent, poc, t0, t1, cpu_ms, thread=1):
    return Span(name, id_, parent, thread, f"t{thread}", poc,
                int(t0 * S), int(t1 * S), int(cpu_ms * 1e6))


def _records():
    """Pictures 0 and 1 end inside the window (1 on another thread),
    picture 2 before it and picture 3 after it; each has a CABAC span and
    filter spans, one nested a level deeper; one CABAC span has no
    picture."""
    out = []
    pics = [(0, 1001.0, 1002.0, 300.0, 1), (1, 1003.0, 1005.0, 500.0, 2),
            (2, 990.0, 999.0, 900.0, 1), (3, 1009.0, 1011.0, 700.0, 1)]
    nid = 100
    for poc, t0, t1, cpu, th in pics:
        pid = 10 + poc
        mid = t0 + 0.1
        out.append(_span("slice.ctu_encode", nid, pid, poc, mid, mid + 0.1,
                         20.0 + poc, th))
        out.append(_span("stage.deblock", nid + 1, pid, poc, mid, mid + 0.1,
                         5.0, th))
        # stage.alf under slice.write, itself under the picture
        out.append(_span("stage.alf", nid + 3, nid + 2, poc, mid, mid + 0.05,
                         7.0, th))
        out.append(_span("slice.write", nid + 2, pid, poc, mid, mid + 0.1,
                         9.0, th))
        out.append(_span("stage.sao", nid + 4, pid, poc, mid, mid + 0.1,
                         3.0, th))
        out.append(_span(PICTURE, pid, None, poc, t0, t1, cpu, th))
        nid += 10
    out.append(_span("slice.ctu_encode", 999, None, None, 1004.0, 1004.5,
                     1000.0))
    return out


@pytest.fixture
def prof(monkeypatch):
    p = Profiler(True)
    for r in _records():
        p._record(r)
    monkeypatch.setattr(profiler, "PROF", p)
    return p


def _ctx(window=WINDOW):
    return SimpleNamespace(timeline=SimpleNamespace(window=window))


def _read(name, ctx):
    return spec.reader(name).read(ctx)


def test_pool_wait_share_counts_the_window_pictures_wall_and_cpu(prof):
    # pictures 0 and 1: wall 1 s + 2 s, CPU 0.3 s + 0.5 s
    got = _read("pool_wait_share.file", _ctx())
    assert got == pytest.approx(100.0 * (1.0 - 0.8 / 3.0))


def test_host_cpu_ms_per_frame_is_the_pictures_cpu_over_their_count(prof):
    assert _read("host_cpu_ms_per_frame.file", _ctx()) == \
        pytest.approx((300.0 + 500.0) / 2)


def test_cabac_cpu_counts_only_spans_under_the_window_pictures(prof):
    # 20 + 21 ms under pictures 0 and 1; not picture 2's or 3's, nor the
    # 1000 ms span outside any picture
    assert _read("cabac_cpu_ms_per_frame.file", _ctx()) == \
        pytest.approx((20.0 + 21.0) / 2)


def test_filters_cpu_sums_deblock_sao_and_alf_at_any_depth(prof):
    assert _read("filters_cpu_ms_per_frame.file", _ctx()) == \
        pytest.approx((5.0 + 7.0 + 3.0) * 2 / 2)


@pytest.mark.parametrize("name", [
    "pool_wait_share.file", "host_cpu_ms_per_frame.file",
    "cabac_cpu_ms_per_frame.file", "filters_cpu_ms_per_frame.file"])
def test_readers_give_nothing_without_a_picture_in_the_window(prof, name):
    assert _read(name, _ctx((2000.0, 2010.0))) is None
    assert _read(name, SimpleNamespace(timeline=None)) is None


@pytest.mark.parametrize("name", [
    "pool_wait_share.file", "host_cpu_ms_per_frame.file",
    "cabac_cpu_ms_per_frame.file", "filters_cpu_ms_per_frame.file"])
def test_readers_give_nothing_from_a_prof_without_records(monkeypatch,
                                                          name):
    class Summing:              # PROF before it kept records: sums only
        enabled = True
        _acc = {"slice.ctu_encode": [1.0, 3]}

        def section(self, name):
            raise AssertionError("not called")
    monkeypatch.setattr(profiler, "PROF", Summing())
    assert _read(name, _ctx()) is None


def test_cabac_and_filters_give_nothing_when_their_spans_are_missing(
        monkeypatch):
    p = Profiler(True)
    p._record(_span(PICTURE, 1, None, 0, 1001.0, 1002.0, 300.0))
    monkeypatch.setattr(profiler, "PROF", p)
    assert _read("cabac_cpu_ms_per_frame.file", _ctx()) is None
    assert _read("filters_cpu_ms_per_frame.file", _ctx()) is None
    assert _read("host_cpu_ms_per_frame.file", _ctx()) == 300.0

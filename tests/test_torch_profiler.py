"""PROF, the port's span recorder (vvenc_tpu_torch/utils/profiler.py):
records with ids, parents, threads and pictures, thread CPU time, the
bound on its buffer, the disabled no-op, its clock against
torch.profiler's, and the spans of an all-intra encode (the
frame-parallel pool and the sequential loop).  One test needs a card and
skips without one; run it there with

    python -m pytest --noconftest -m cuda tests/test_torch_profiler.py -q
"""

import threading
import time

import numpy as np
import pytest
import torch

from benchmark.timeline import note_prof_spans
from vvenc_tpu_torch.encoder import intra_encoder as IE
from vvenc_tpu_torch.encoder import sequence as SQ
from vvenc_tpu_torch.encoder.intra_encoder import EncoderConfig, IntraEncoder
from vvenc_tpu_torch.utils import profiler as P
from vvenc_tpu_torch.utils.profiler import PICTURE, Profiler


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def test_nested_spans_inherit_parent_and_poc_on_their_thread_only():
    prof = Profiler(True)
    other = []

    def elsewhere():
        with prof.section("c"):
            other.append(threading.get_ident())

    with prof.picture(7):
        with prof.section("a"):
            with prof.section("b"):
                t = threading.Thread(target=elsewhere)
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
    with prof.section("d"):
        pass
    r = {k: v[0] for k, v in _by_name(prof.records()).items()}
    me = threading.get_ident()
    assert r[PICTURE].parent is None and r[PICTURE].poc == 7
    assert r["a"].parent == r[PICTURE].id and r["b"].parent == r["a"].id
    assert r["a"].poc == r["b"].poc == 7
    assert {r[n].thread for n in (PICTURE, "a", "b", "d")} == {me}
    # another thread starts with no parent and no picture
    assert r["c"].parent is None and r["c"].poc is None
    assert r["c"].thread == other[0] != me
    # the picture ended: neither its POC nor its id is left open
    assert r["d"].parent is None and r["d"].poc is None
    assert len({x.id for x in prof.records()}) == 5
    # each span lies inside its parent
    for child, par in (("a", PICTURE), ("b", "a")):
        assert r[par].start_ns <= r[child].start_ns \
            <= r[child].end_ns <= r[par].end_ns


def test_thread_cpu_time_separates_sleeping_from_working():
    """A sleep costs its thread almost no CPU; a busy loop's span holds
    the CPU the loop burnt (it spins until its thread has used 0.2 s),
    however long other processes kept it off a core.  The thread CPU
    clock may tick in 10 ms steps, hence the tolerance."""
    tick = 10_000_000
    prof = Profiler(True)
    with prof.section("sleep"):
        time.sleep(0.2)
    with prof.section("busy"):
        c0 = time.thread_time_ns()
        x = 0
        while time.thread_time_ns() - c0 < 200_000_000:
            x += 1
    r = {k: v[0] for k, v in _by_name(prof.records()).items()}
    wall = {n: r[n].end_ns - r[n].start_ns for n in ("sleep", "busy")}
    assert wall["sleep"] >= 0.19e9
    assert r["sleep"].cpu_ns < 0.10 * wall["sleep"]
    assert 200_000_000 <= r["busy"].cpu_ns <= 200_000_000 + 2 * tick
    assert r["busy"].cpu_ns <= wall["busy"] + tick


def test_disabled_profiler_returns_the_shared_noop_and_records_nothing(
        monkeypatch):
    prof = Profiler(False)
    # no clock and no lock on any entry point
    monkeypatch.setattr(P, "time", None)
    prof._lock = None
    assert prof.section("x") is P._NULL
    assert prof.picture(3) is P._NULL
    with prof.picture(3):
        with prof.section("x"):
            pass
    assert prof.records() == [] and prof._acc == {}
    assert prof.report() == ""


def test_buffer_bound_drops_records_and_counts_them(capsys):
    prof = Profiler(True, max_records=3)
    for i in range(5):
        with prof.section(f"s{i % 2}"):
            pass
    recs = prof.records()
    assert [r.name for r in recs] == ["s0", "s1", "s0"]
    assert prof.dropped == 2
    # the sums still count every span
    assert prof._acc["s0"][1] == 3 and prof._acc["s1"][1] == 2
    text = prof.report()
    assert "dropped 2" in text and "records kept 3" in text
    # a copy: the caller's list does not alias the buffer
    recs.clear()
    assert len(prof.records()) == 3


def test_report_has_thread_cpu_and_off_cpu_columns(capsys):
    prof = Profiler(True)
    with prof.section("sleep"):
        time.sleep(0.05)
    text = prof.report()
    assert text in capsys.readouterr().out
    head, row = text.splitlines()[1:3]
    assert head.split() == ["stage", "wall[s]", "cpu[s]", "off-cpu",
                            "calls", "%wall"]
    cells = row.split()
    assert cells[0] == "sleep" and cells[4] == "1"
    wall, cpu, off = float(cells[1]), float(cells[2]), float(cells[3][:-1])
    assert wall >= 0.05 and cpu < 0.01 and off > 80.0


def test_note_prof_spans_still_wraps_section_and_acc_sums_match_records():
    prof = Profiler(True)
    noted, undo = note_prof_spans(prof)
    try:
        with prof.picture(2):
            with prof.section("x"):
                time.sleep(0.01)
            with prof.section("y"):
                with prof.section("x"):
                    pass
    finally:
        undo()
    with prof.section("z"):       # after the undo: not noted
        pass
    # the picture span is not a section: the wrapper sees the stages only
    assert [n for n, _, _ in noted] == ["x", "x", "y"]
    recs = _by_name(prof.records())
    assert set(recs) == {PICTURE, "x", "y", "z"}
    for name, rs in recs.items():
        wall = sum(r.end_ns - r.start_ns for r in rs) * 1e-9
        assert prof._acc[name][0] == pytest.approx(wall, rel=1e-9, abs=1e-12)
        assert prof._acc[name][1] == len(rs)
    # each noted interval lies inside its record's
    for (n, a, b), r in zip(sorted(noted, key=lambda s: s[1]),
                            sorted(recs["x"] + recs["y"],
                                   key=lambda r: r.start_ns)):
        assert r.name == n and r.start_ns <= a <= b <= r.end_ns


def test_span_lies_within_its_record_function_event_on_the_cpu():
    from torch.profiler import ProfilerActivity, profile, record_function
    prof = Profiler(True)
    with profile(activities=[ProfilerActivity.CPU]) as tp:
        with record_function("outer"):
            with prof.section("inner"):
                time.sleep(0.01)
    evs = [e for e in tp.profiler.kineto_results.events()
           if e.name() == "outer"]
    assert len(evs) == 1
    s = evs[0].start_ns()
    e = s + evs[0].duration_ns()
    r = prof.records()[0]
    assert s <= r.start_ns <= r.end_ns <= e
    assert r.end_ns - r.start_ns >= 0.01e9


def _frames(n=4, w=64, h=64):
    rng = np.random.RandomState(5)
    out = []
    for _ in range(n):
        y = rng.randint(0, 255, (h, w)).astype(np.uint8)
        out.append((y, y[::2, ::2].copy(), y[1::2, 1::2].copy()))
    return out


def _encode(threads, prof):
    """An all-intra 64x64 encode of 4 pictures on the CPU with `prof` as
    the port's PROF; `threads` > 1 codes on the frame-parallel pool."""
    cfg = EncoderConfig(width=64, height=64, qp=37, ctu_size=32,
                        intra_period=1, gop_size=1, deblocking=True,
                        sao=True, alf=True, max_parallel_frames=threads,
                        device="cpu")
    saved = P.PROF, IE.PROF, SQ.PROF
    P.PROF = IE.PROF = SQ.PROF = prof
    try:
        return IntraEncoder(cfg).encode_sequence(_frames())
    finally:
        P.PROF, IE.PROF, SQ.PROF = saved


@pytest.fixture(scope="module", params=[4, 1], ids=["pool", "sequential"])
def encodes(request):
    on = Profiler(True)
    stream_on = _encode(request.param, on)
    stream_off = _encode(request.param, Profiler(False))
    return request.param, on, stream_on, stream_off


def test_encode_records_a_picture_span_per_poc(encodes):
    threads, prof, _, _ = encodes
    recs = prof.records()
    pics = [r for r in recs if r.name == PICTURE]
    assert sorted(p.poc for p in pics) == [0, 1, 2, 3]
    assert all(p.parent is None for p in pics)
    if threads > 1:
        # the pool's threads code the pictures
        assert all(p.thread != threading.get_ident() for p in pics)
        setup = [r for r in recs if r.name == "pic.setup"]
        assert sorted(r.poc for r in setup) == [0, 1, 2, 3]
    names = {r.name for r in recs}
    assert {"slice.ctu_search", "slice.ctu_encode", "slice.write",
            "stage.deblock", "stage.sao", "stage.alf"} <= names


def test_encode_spans_carry_their_pictures_poc(encodes):
    _, prof, _, _ = encodes
    recs = prof.records()
    by_id = {r.id: r for r in recs}
    leaves = [r for r in recs
              if r.name in ("slice.ctu_search", "slice.ctu_encode")]
    assert len(leaves) >= 2 * 4 * 4      # a search and a coding span a CTU
    for r in leaves:
        up = by_id[r.parent]
        while up.name != PICTURE:
            up = by_id[up.parent]
        assert r.poc == up.poc is not None and r.thread == up.thread
        assert up.start_ns <= r.start_ns <= r.end_ns <= up.end_ns


def test_encode_streams_byte_identical_with_prof_on_and_off(encodes):
    _, _, stream_on, stream_off = encodes
    assert len(stream_on) > 0 and stream_on == stream_off


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a kernel on the device timeline")
    return torch.device("cuda")


@pytest.mark.cuda
def test_span_covers_its_kernel_on_the_profiler_timeline(cuda):
    """A span around a known kernel (torch.cuda._sleep, about 5 ms) and
    its synchronise lies within 0.5 ms of that kernel's interval on
    torch.profiler's device timeline: PROF's clock is the profiler's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    prof = Profiler(True)
    torch.cuda._sleep(1000)            # context and launch path warm
    torch.cuda.synchronize(cuda)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tp:
        with prof.section("sleep"):
            torch.cuda._sleep(10_000_000)
            torch.cuda.synchronize(cuda)
    # the sleep kernel (spin_kernel): the one device event of milliseconds
    ks = [e for e in tp.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA
          and e.duration_ns() > 1_000_000]
    assert len(ks) == 1, [(e.name(), e.duration_ns()) for e in ks]
    k0 = ks[0].start_ns()
    k1 = k0 + ks[0].duration_ns()
    r = prof.records()[0]
    assert abs(k0 - r.start_ns) < 500_000, (k0 - r.start_ns)
    assert abs(r.end_ns - k1) < 500_000, (r.end_ns - k1)
    assert r.start_ns - 500_000 <= k0 <= k1 <= r.end_ns + 500_000

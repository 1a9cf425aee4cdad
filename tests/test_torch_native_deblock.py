"""The native deblocking filter (vvenc_tpu_torch/native/deblock.cpp)
against codec/deblock.py deblock_picture, its specification.

Every deblock_picture call that the port's decoder makes on the golden
streams is replayed on copies of its planes through the Python model and
through native/deblock.py: Y, Cb and Cr must come out equal, for the
whole picture and in CTU-row bands with full and partial CU lists.
Random CU lists (quad tree with binary splits, single tree with inter
CUs and every covered tool, dual tree, CTU 128 with max-TB units, 8 and
10 bits) add what the streams do not hold.  Encodes of both benchmark
cells' configurations, at small sizes, must give the same bytes with
VVENC_TPU_NATIVE=0, on one thread and on the pool of 4, with every
picture filtered natively; IBC, which the native filter does not cover,
sends its pictures to the Python model whole.  Needs only g++."""

import dataclasses
import os
import threading
import time

import numpy as np
import pytest

from test_device_plan import _clip
from test_torch_native_writer import _cli_config, _pictures
from vvenc_tpu_torch.codec import deblock as DB
from vvenc_tpu_torch.codec.ctu_syntax import CuData
from vvenc_tpu_torch.codec.motion import MotionInfo
from vvenc_tpu_torch.decoder import decode_stream
from vvenc_tpu_torch.encoder.intra_encoder import IntraEncoder
from vvenc_tpu_torch.native import deblock as ND

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(autouse=True)
def natives():
    if ND._lib() is None:
        pytest.skip("native library unavailable (no g++)")


def _counts():
    from vvenc_tpu_torch.utils.profiler import PROF
    return dict(PROF.counts().get(ND.COUNTER, {}))


def _delta(before):
    after = _counts()
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in ("native", "python")}


def _copy(rec):
    return {c: rec[c].copy() for c in range(3)}


def _same(a, b):
    return all(np.array_equal(a[c], b[c]) for c in range(3))


# ---- golden streams ---------------------------------------------------------

# stream -> what its pictures hold for the filter
STREAMS = {
    "golden_ai_preset_medium_416x240_qp30_f2.266": "dual tree, ISP",
    "golden_ai_dualtree_all_416x240_qp26_f2.266": "dual tree, IBC",
    "golden_ai_qpa_416x240_f2.266": "per-CU QP",
    "golden_ai_bdpcm_416x240_qp30_f2.266": "BDPCM",
    "golden_ai_isp_416x240_qp24_f2.266": "ISP",
    "golden_ai_sink_416x240_qp26_f2.266": "JCCR, dual tree",
    "golden_ra_preset_medium_416x240_qp30_f9.266":
        "SbTMVP / affine, GEO, max-TB, JCCR, ISP",
    "golden_ra_preset_slow_416x240_qp30_f5.266":
        "SBT, CIIP, affine, max-TB, JCCR",
    "golden_ra_10bit_medium_416x240_qp30_f5.266": "10-bit, max-TB",
    "golden_ra_sbt_416x240_qp27_f9.266": "SBT",
    "golden_ra_sbt_combo_416x240_qp24_f9.266": "SBT, CIIP, GEO, JCCR",
    "golden_ra_ciip_416x240_qp28_f9.266": "CIIP",
    "golden_ra_affine_sbtmvp_prof_416x240_qp28_f9.266": "affine, SbTMVP",
    "golden_ra_jccr_alf_416x240_qp28_f9.266": "JCCR",
    "golden_ra_qpa_416x240_q27_f9.266": "per-CU QP, B slices",
}
# banded over CTU rows as well
BANDED = ("golden_ai_preset_medium_416x240_qp30_f2.266",
          "golden_ai_qpa_416x240_f2.266",
          "golden_ra_preset_medium_416x240_qp30_f9.266",
          "golden_ra_preset_slow_416x240_qp30_f5.266",
          "golden_ra_sbt_combo_416x240_qp24_f9.266")
_CAPTURED = {}


def _captured(name):
    """The stream's deblock_picture calls: (planes before, CU list,
    positional arguments, keywords)."""
    if name not in _CAPTURED:
        calls = []
        orig = DB.deblock_picture

        def capture(rec, cu_list, *args, **kw):
            calls.append((_copy(rec), list(cu_list), args, dict(kw)))
            orig(rec, cu_list, *args, **kw)
        DB.deblock_picture = capture
        try:
            with open(os.path.join(DATA, name), "rb") as f:
                decode_stream(f.read())
        finally:
            DB.deblock_picture = orig
        assert calls, name
        _CAPTURED[name] = calls
    return _CAPTURED[name]


def _has_ibc(cus):
    return any(getattr(cu, "is_ibc", False) for cu in cus)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_golden_pictures_native_equals_python(name):
    calls = _captured(name)
    before = _counts()
    changed = 0
    for rec, cus, args, kw in calls:
        want, got = _copy(rec), _copy(rec)
        DB.deblock_picture(want, cus, *args, **kw)
        ND.deblock_picture(got, cus, *args, **kw)
        assert _same(want, got), name
        changed += not _same(want, rec)
    assert changed                        # the filter did work
    ibc = sum(_has_ibc(cus) for _, cus, _, _ in calls)
    assert _delta(before) == {"native": len(calls) - ibc, "python": ibc}


def _banded(fn, rec, cus, args, kw, partial):
    ctu = args[3]
    for y0 in range(0, rec[0].shape[0], ctu):
        band = [cu for cu in cus if cu.y < y0 + ctu] if partial else cus
        fn(rec, band, *args, y_band=(y0, y0 + ctu), **kw)


@pytest.mark.parametrize("partial", [False, True], ids=["full", "partial"])
@pytest.mark.parametrize("name", BANDED)
def test_golden_pictures_banded(name, partial):
    """Per-CTU-row bands, as the IFP pipeline calls the filter: native
    bands equal Python bands and the monolithic picture."""
    for rec, cus, args, kw in _captured(name):
        whole, want, got = _copy(rec), _copy(rec), _copy(rec)
        DB.deblock_picture(whole, cus, *args, **kw)
        _banded(DB.deblock_picture, want, cus, args, kw, partial)
        _banded(ND.deblock_picture, got, cus, args, kw, partial)
        assert _same(want, got) and _same(whole, got), name


# ---- random CU lists --------------------------------------------------------

_COEF = np.ones(1, np.int32)     # a coded block (the filter reads presence)


def _partition(rng, w, h, ctu, max_cu, min_cu):
    """Quad-tree leaves split at the picture's border, some split once
    more in two: (x, y, w, h) in coding order."""
    out = []

    def qt(x, y, s):
        if x >= w or y >= h:
            return
        if s > min_cu and (s > max_cu or x + s > w or y + s > h
                           or rng.rand() < 0.55):
            for dy in (0, s // 2):
                for dx in (0, s // 2):
                    qt(x + dx, y + dy, s // 2)
        elif s >= 8 and rng.rand() < 0.3:
            if rng.rand() < 0.5:
                out.extend([(x, y, s, s // 2), (x, y + s // 2, s, s // 2)])
            else:
                out.extend([(x, y, s // 2, s), (x + s // 2, y, s // 2, s)])
        else:
            out.append((x, y, s, s))
    for cy in range(0, h, ctu):
        for cx in range(0, w, ctu):
            qt(cx, cy, ctu)
    return out


def _maybe(rng, p=0.5):
    return _COEF if rng.rand() < p else None


_MVS = [-16, -9, -8, -7, 0, 4, 8, 12]


def _motion(rng, prev):
    if prev is not None and rng.rand() < 0.4:
        return prev
    ri = (int(rng.randint(-1, 2)), int(rng.randint(-1, 3)))
    if ri == (-1, -1):
        ri = (0, -1)
    mv = tuple((int(rng.choice(_MVS)), int(rng.choice(_MVS)))
               for _ in range(2))
    return MotionInfo(mv=mv, ref_idx=ri)


def _luma_cu(rng, x, y, w, h, inter, prev, luma_only=False):
    cu = CuData(x, y, w, h, luma_only=luma_only)
    cu.coeff_y = _maybe(rng)
    if not luma_only:
        cu.coeff_cb, cu.coeff_cr = _maybe(rng), _maybe(rng)
        cu.joint_cbcr = int(rng.choice([0, 0, 0, 1, 2, 3]))
    if inter and rng.rand() < 0.7:
        cu.is_inter = True
        mi = _motion(rng, prev)
        cu.mv, cu.ref_idx = mi.mv, mi.ref_idx
        cu.ciip = bool(rng.rand() < 0.1)
        kind = rng.rand()
        if kind < 0.25 and w >= 8 and h >= 8:
            # affine (or, without the flag, GEO): per-4x4 motion
            cu.affine = bool(rng.rand() < 0.7)
            cu.sub_mi = [[_motion(rng, mi) for _ in range(w >> 2)]
                         for _ in range(h >> 2)]
        elif kind < 0.5:
            sbt = [s for s, ok in ((1, w >= 8), (2, h >= 8), (3, w >= 16),
                                   (4, h >= 16)) if ok]
            if sbt:
                cu.sbt_idx = int(rng.choice(sbt))
                cu.sbt_pos = int(rng.randint(2))
        return cu, mi
    if w * h > 16 and rng.rand() < 0.25:
        cu.isp_mode = int(rng.randint(1, 3))
    cu.bdpcm_y = int(rng.rand() < 0.15)
    cu.bdpcm_c = int(rng.rand() < 0.1)
    return cu, prev


def _cu_list(rng, w, h, ctu, inter, dual):
    cus = []
    prev = None
    if not dual:
        for (x, y, cw, ch) in _partition(rng, w, h, ctu, ctu, 4):
            cu, prev = _luma_cu(rng, x, y, cw, ch, inter, prev)
            if cw > 64 or ch > 64:
                cu.mtb_tus = [(tx, ty, min(64, cw), min(64, ch),
                               _maybe(rng), _maybe(rng), _maybe(rng),
                               int(rng.choice([0, 0, 2, 3])), 0, 0)
                              for ty in range(0, ch, 64)
                              for tx in range(0, cw, 64)]
            cus.append(cu)
        return cus
    for uy in range(0, h, 64):
        for ux in range(0, w, 64):
            uw_, uh_ = min(64, w - ux), min(64, h - uy)
            for (x, y, cw, ch) in _partition(rng, uw_, uh_, 64, 64, 4):
                cus.append(_luma_cu(rng, ux + x, uy + y, cw, ch, False,
                                    None, luma_only=True)[0])
            for (x, y, cw, ch) in _partition(rng, uw_, uh_, 64, 64, 8):
                cu = CuData(ux + x, uy + y, cw, ch, chroma_only=True)
                cu.coeff_cb, cu.coeff_cr = _maybe(rng), _maybe(rng)
                cu.joint_cbcr = int(rng.choice([0, 0, 1, 2, 3]))
                cu.bdpcm_c = int(rng.rand() < 0.1)
                cus.append(cu)
    return cus


def _planes(rng, w, h, bd, cus):
    """Smooth planes with a step at every CU, so that most edges filter."""
    top = (1 << bd) - 1
    yy, xx = np.mgrid[0:h, 0:w]
    y = (xx * 3 + yy * 2).astype(np.float64) * (top / (5.0 * (w + h)))
    off = np.zeros((h, w))
    for cu in cus:
        off[cu.y:cu.y + cu.h, cu.x:cu.x + cu.w] += rng.randint(-6, 7) \
            * (1 << (bd - 8))
    y = y + off + rng.randint(-2, 3, (h, w)) * (1 << (bd - 8))
    c = y[::2, ::2] * 0.5 + top * 0.25
    return {0: np.clip(y, 0, top).astype(np.int32),
            1: np.clip(c + rng.randint(-2, 3, c.shape), 0, top)
            .astype(np.int32),
            2: np.clip(top - c, 0, top).astype(np.int32)}


def _qp_map(rng, w, h, cus):
    qm = np.zeros(((h + 3) // 4, (w + 3) // 4), np.int32)
    for cu in cus:
        if not getattr(cu, "chroma_only", False):
            qm[cu.y >> 2:(cu.y + cu.h) >> 2, cu.x >> 2:(cu.x + cu.w) >> 2] \
                = rng.randint(22, 43)
    return qm


def _chroma_qp(qp, comp, joint):
    return max(-12, min(63, qp - comp - (3 if joint else 0) + (qp > 30)))


# case -> (width, height, CTU, bit depth, inter slice, dual tree, QP map)
RANDOM = {
    "qt_intra_8bit": (200, 120, 64, 8, False, False, False),
    "qt_intra_qpmap_10bit": (200, 120, 64, 10, False, False, True),
    "inter_b_10bit": (200, 120, 64, 10, True, False, True),
    "inter_p_8bit": (136, 72, 32, 8, True, False, False),
    "dual_tree_8bit": (200, 120, 64, 8, False, True, True),
    "dual_tree_10bit": (192, 128, 64, 10, False, True, False),
    "ctu128_max_tb": (256, 136, 128, 10, True, False, True),
}


@pytest.mark.parametrize("case", sorted(RANDOM))
def test_random_cu_lists(case):
    w, h, ctu, bd, inter, dual, qpm = RANDOM[case]
    rng = np.random.RandomState(sorted(RANDOM).index(case) + 3)
    before = _counts()
    n = 0
    for seed in range(3):
        cus = _cu_list(rng, w, h, ctu, inter, dual)
        rec = _planes(rng, w, h, bd, cus)
        is_b = inter and "_b_" in case or case == "ctu128_max_tb"
        kw = dict(ref_pocs=[[8, 4, 16], [16, 8]] if inter else None,
                  is_b=is_b)
        if qpm:
            kw.update(qp_map=_qp_map(rng, w, h, cus),
                      chroma_qp_fn=_chroma_qp)
        args = (32, 31, 30, ctu, bd)
        want, got = _copy(rec), _copy(rec)
        DB.deblock_picture(want, cus, *args, **kw)
        ND.deblock_picture(got, cus, *args, **kw)
        assert _same(want, got), (case, seed)
        assert not _same(want, rec)
        for partial in (False, True):
            got = _copy(rec)
            _banded(ND.deblock_picture, got, cus, args, kw, partial)
            assert _same(want, got), (case, seed, partial)
        n += 1 + 2 * -(-h // ctu)
    assert _delta(before) == {"native": n, "python": 0}


# ---- the encoder ------------------------------------------------------------

class _Twin:
    """Installed as native.deblock.deblock_picture: every call of the
    encoder also runs the Python model on copies, and the planes must
    agree; records whether the picture held an IBC CU."""

    def __init__(self):
        self.orig = ND.deblock_picture
        self.calls = []

    def __call__(self, rec, cu_list, *args, **kw):
        want = _copy(rec)
        DB.deblock_picture(want, cu_list, *args, **kw)
        self.orig(rec, cu_list, *args, **kw)
        assert _same(want, rec)
        self.calls.append(_has_ibc(cu_list))


def _encode_twin(monkeypatch, ecfg, frames):
    twin = _Twin()
    monkeypatch.setattr(ND, "deblock_picture", twin)
    before = _counts()
    stream = IntraEncoder(ecfg).encode_sequence(frames)
    monkeypatch.setattr(ND, "deblock_picture", twin.orig)
    return stream, _delta(before), twin.calls


def _python_only(ecfg, frames):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VVENC_TPU_NATIVE", "0")
        before = _counts()
        stream = IntraEncoder(ecfg).encode_sequence(frames)
        return stream, _delta(before)


def _ai_cell():
    """ai_faster_d416's options: the CLI's faster preset, 416x240, QP 37,
    8-bit in, 10-bit internal, all-intra, the pool of 4."""
    return _cli_config(416, 240, 37), _pictures(4, 416, 240)


def _ra_cell():
    """ra_faster_c832's options at the smallest GOP that codes a CRA
    (4) and at 256x128: the CLI's faster preset, intra period 4 with a
    CRA, the device ME, a clip that moves."""
    e = dataclasses.replace(_cli_config(256, 128, 27), intra_period=4,
                            gop_size=4, decoding_refresh_type="cra",
                            me_mode="device")
    return e, [(f[0], f[1], f[2]) for f in _clip(n=9, w=256, h=128)]


@pytest.mark.parametrize("cell", ["ai", "ra"])
def test_cell_streams_equal_python_deblocking(cell, monkeypatch):
    """The pool of 4 and one thread code the stream that the Python
    deblocking gives (VVENC_TPU_NATIVE=0); every picture goes native."""
    ecfg, frames = _ai_cell() if cell == "ai" else _ra_cell()
    assert ecfg.max_parallel_frames == 4 and ecfg.deblocking
    assert ecfg.dual_tree
    one = dataclasses.replace(ecfg, max_parallel_frames=1)
    if cell == "ra":
        assert ecfg.dmvr
    pool, n_pool, calls = _encode_twin(monkeypatch, ecfg, frames)
    seq, n_seq, _ = _encode_twin(monkeypatch, one, frames)
    py, n_py = _python_only(ecfg, frames)
    assert pool == seq == py
    n = len(frames)
    assert len(calls) == n
    assert n_pool == n_seq == {"native": n, "python": 0}
    assert n_py == {"native": 0, "python": n}


def _screen(n, w, h):
    """Screen content: one 16x16 pattern repeated, so IBC finds copies."""
    rng = np.random.RandomState(3)
    tile = (rng.randint(0, 2, (16, 16)) * 200 + 20).astype(np.uint8)
    out = []
    for i in range(n):
        y = np.full((h, w), 128, np.uint8)
        for yy in range(0, h, 16):
            for xx in range(0, w, 16):
                if (xx // 16 + yy // 16 + i) % 3 == 0:
                    y[yy:yy + 16, xx:xx + 16] = tile
        c = np.full((h // 2, w // 2), 128, np.uint8)
        out.append((y, c, c.copy()))
    return out


def test_uncovered_ibc_pictures_fall_back_whole(monkeypatch):
    """A picture with an IBC CU goes to the Python model whole, counted
    "python"; the stream equals the Python deblocking's."""
    ecfg = dataclasses.replace(_cli_config(128, 64, 32), ibc=True,
                               scc_auto=False)
    frames = _screen(2, 128, 64)
    stream, n, calls = _encode_twin(monkeypatch, ecfg, frames)
    assert any(calls)
    assert n == {"native": calls.count(False), "python": calls.count(True)}
    assert stream == _python_only(ecfg, frames)[0]


# ---- threads ----------------------------------------------------------------

def _four_pictures():
    out = []
    for name in ("golden_ai_preset_medium_416x240_qp30_f2.266",
                 "golden_ai_qpa_416x240_f2.266"):
        out += _captured(name)
    return out[:4]


def test_four_threads_deblock_four_pictures_at_once():
    pics = _four_pictures()
    want = []
    for rec, cus, args, kw in pics:
        r = _copy(rec)
        ND.deblock_picture(r, cus, *args, **kw)
        want.append(r)
    for _ in range(3):
        got = [_copy(rec) for rec, _, _, _ in pics]
        go = threading.Barrier(4)

        def work(k):
            rec, cus, args, kw = pics[k]
            go.wait()
            for _ in range(5):
                r = _copy(rec)
                ND.deblock_picture(r, cus, *args, **kw)
            got[k] = r
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(_same(a, b) for a, b in zip(want, got))


class _Spy:
    """Stands for the loaded library: makes each native call `repeat`
    times and reads a Python thread's progress counter around each."""

    def __init__(self, lib, progress, repeat):
        self.lib, self.progress, self.repeat = lib, progress, repeat
        self.during = 0

    def vtd_deblock_picture(self, *a):
        for _ in range(self.repeat):
            p0 = self.progress[0]
            n = self.lib.vtd_deblock_picture(*a)
            self.during += self.progress[0] - p0
        return n


def _holding_gil(lib):
    """The same library called with the GIL held (ctypes.PyDLL): the
    control that shows what the checks below catch."""
    import ctypes
    held = ctypes.PyDLL(lib._name)
    f, g = held.vtd_deblock_picture, lib.vtd_deblock_picture
    f.argtypes, f.restype = g.argtypes, g.restype
    return held


def test_native_call_releases_the_gil(monkeypatch):
    """A Python thread makes progress while native calls run (none while
    the same calls hold the GIL), and both together take less wall time
    than one after the other (the best of up to five trials, as other
    tests may load the machine)."""
    rng = np.random.RandomState(7)
    w, h = 1024, 576
    cus = _cu_list(rng, w, h, 64, True, False)
    rec = _planes(rng, w, h, 10, cus)
    args = (32, 31, 30, 64, 10)
    kw = dict(ref_pocs=[[8, 4], [16]], is_b=True)
    progress = [0]

    def native(lib):
        spy = _Spy(lib, progress, 30)
        monkeypatch.setattr(ND, "_DLIB", spy)
        ND.deblock_picture(_copy(rec), cus, *args, **kw)
        return spy

    def python_work(n):
        for i in range(1, n + 1):
            progress[0] = i

    def together(lib, n_py):
        progress[0] = 0
        th = threading.Thread(target=python_work, args=(n_py,))
        t0 = time.perf_counter()
        th.start()
        spy = native(lib)
        th.join()
        return time.perf_counter() - t0, spy.during

    lib = ND._lib()
    assert together(_holding_gil(lib), 100_000)[1] == 0
    trials = []
    for _ in range(5):
        t0 = time.perf_counter()
        native(lib)
        t_native = time.perf_counter() - t0
        # as many Python steps as take about as long
        t0 = time.perf_counter()
        python_work(100_000)
        n_py = int(100_000 * t_native / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        python_work(n_py)
        t_python = time.perf_counter() - t0
        t_both, during = together(lib, n_py)
        assert during > 0, "no Python progress inside the native calls"
        trials.append((t_both / (t_native + t_python), t_both, t_native,
                       t_python))
        if trials[-1][0] < 0.9:
            break
    assert min(trials)[0] < 0.9, trials


def test_prof_report_counts_deblocked_pictures():
    from vvenc_tpu_torch.utils.profiler import Profiler
    prof = Profiler(True)
    for path in ("native", "native", "python"):
        prof.count(ND.COUNTER, path)
    with prof.section("stage.deblock"):
        pass
    assert prof.report().splitlines()[-1] == \
        "native.deblock.pictures: native 2, python 1"

"""The port's tool twins (vvenc_tpu_torch/tools) against the repository's
tools/bdrate.py and tools/calibrate_plan.py, which drive the JAX package:
the same numbers from the same curves and planes, the same bits and
reconstruction from the same encodes (on the CPU, --device cpu)."""

import importlib.util
import pathlib
import types

import numpy as np
import pytest

from vvenc_tpu_torch.tools import bdrate as TB
from vvenc_tpu_torch.tools import calibrate_plan as TC

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _original(name):
    """tools/<name>.py, loaded by its path."""
    spec = importlib.util.spec_from_file_location(
        f"original_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _curve(rng, lo_rate):
    rates = np.sort(rng.uniform(lo_rate, 8 * lo_rate, 4))
    return list(rates), list(np.sort(rng.uniform(30.0, 44.0, 4)))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_bd_rate_psnr_yuv_and_bd_delta_equal_the_originals(seed):
    ob, oc = _original("bdrate"), _original("calibrate_plan")
    rng = np.random.RandomState(seed)
    r1, p1 = _curve(rng, 100.0)
    r2, p2 = _curve(rng, 120.0)
    assert TB.bd_rate(r1, p1, r2, p2) == ob.bd_rate(r1, p1, r2, p2)
    pts1, pts2 = list(zip(r1, p1)), list(zip(r2, p2))
    assert TC.bd_delta(pts1, pts2) == oc.bd_delta(pts1, pts2)
    frames = [tuple(rng.randint(0, 1024, s).astype(np.uint16)
                    for s in ((16, 24), (8, 12), (8, 12))) for _ in range(3)]
    recs = [tuple(np.clip(p.astype(np.int32) + rng.randint(-9, 10, p.shape),
                          0, 1023).astype(np.uint16) for p in f)
            for f in frames]
    recs[0] = frames[0]                 # a lossless frame: 99.99 dB
    assert TB.psnr_yuv(frames, recs, 10) == ob.psnr_yuv(frames, recs, 10)


def _clip(tmp_path, w=64, h=64, n=2):
    path = tmp_path / "clip.yuv"
    TC.make_clip(str(path), w, h, n)
    return str(path)


def test_make_clip_is_the_benchmarks_clip(tmp_path):
    """The twin's default clip (and chip_smoke.py's clips) is bench.py's
    clip, which the port copies rather than imports."""
    spec = importlib.util.spec_from_file_location("bench_by_path",
                                                  ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    a, b = tmp_path / "a.yuv", tmp_path / "b.yuv"
    TC.make_clip(str(a), 48, 32, 3)
    bench.make_clip(str(b), 48, 32, 3)
    assert a.read_bytes() == b.read_bytes()


def test_run_ours_gives_the_originals_bits_and_reconstruction(tmp_path):
    ob = _original("bdrate")
    clip = _clip(tmp_path)
    (tmp_path / "o").mkdir()
    (tmp_path / "t").mkdir()
    bits_o, rec_o = ob.run_ours(clip, 64, 64, 2, 37, "faster", 1, 0,
                                str(tmp_path / "o"))
    bits_t, rec_t = TB.run_ours(clip, 64, 64, 2, 37, "faster", 1, 0,
                                str(tmp_path / "t"), device="cpu")
    assert bits_t == bits_o > 0
    assert len(rec_t) == len(rec_o) == 2
    for ft, fo in zip(rec_t, rec_o):
        for pt, po in zip(ft, fo):
            assert np.array_equal(pt, po)


def test_calibrate_encode_gives_the_originals_point(tmp_path):
    """One QP with the device plan (device_rd=on): the twin's (kbps, Y
    PSNR) equal the original's.  The original writes its stream to a
    fixed path; here its subprocess call is pointed at a directory of
    the test's own, nothing else changed."""
    oc = _original("calibrate_plan")
    clip = _clip(tmp_path)
    run = oc.subprocess.run

    def redirected(cmd, **kw):
        cmd = list(cmd)
        cmd[cmd.index("-o") + 1] = str(tmp_path / "original.266")
        return run(cmd, **kw)
    oc.subprocess = types.SimpleNamespace(run=redirected)
    want = oc.encode(clip, 64, 64, 2, 37, {}, device_rd="on")
    got = TC.encode(clip, 64, 64, 2, 37, {}, device_rd="on", device="cpu")
    assert got == want


def test_bdrate_without_the_reference_encoder_raises(tmp_path, monkeypatch):
    """A missing --ref-bin raises FileNotFoundError naming what it looked
    for, before any encode: no reference curve is skipped quietly."""
    clip = _clip(tmp_path)
    missing = str(tmp_path / "nowhere" / "vvencFFapp")
    argv = ["--clip", clip, "--size", "64x64", "--frames", "2", "--qps",
            "37", "--device", "cpu"]
    with pytest.raises(FileNotFoundError, match="nowhere/vvencFFapp"):
        TB.main(argv + ["--ref-bin", missing])
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="'vvencFFapp'.*PATH"):
        TB.main(argv)
    assert not list(tmp_path.glob("**/*.266"))

"""The port's bench twin (vvenc_tpu_torch/bench.py) against the repository's
bench.py, which drives the JAX package: the same clips, the same bytes
from the same options (on the CPU, --device cpu, at small sizes), the
same summary keys, and no fallback: no card, a failed encode or an
overrun stage ends the run without a JSON line."""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from vvenc_tpu_torch import bench as B
from vvenc_tpu_torch.encoder import IntraEncoder

ROOT = pathlib.Path(__file__).resolve().parents[1]
NO_REF = "/nonexistent/refbuild/vvencFFapp"


def _bench():
    """bench.py, loaded by its path."""
    spec = importlib.util.spec_from_file_location("bench_by_path",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _small_stages(limit_s=None):
    """The three stages, options kept, cut to 64x64 and 2-3 frames
    (config 3 still warms on fewer frames than it times)."""
    out = []
    for st in B.STAGES:
        n = min(st.frames, 3)
        cut = dict(w=64, h=64, frames=n,
                   warm_frames=n if st.warm_frames == st.frames else n - 1)
        if limit_s is not None:
            cut["limit_s"] = limit_s
        out.append(dataclasses.replace(st, **cut))
    return tuple(out)


@pytest.fixture(scope="module")
def summary_line():
    """stdout of the twin's main on the small stages, --device cpu,
    without a reference encoder."""
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(B, "STAGES", _small_stages())
        with contextlib.redirect_stdout(buf):
            assert B.main(["--device", "cpu", "--ref-bin", NO_REF]) == 0
    return buf.getvalue().splitlines()[-1]


@pytest.mark.parametrize("st", B.STAGES, ids=lambda s: s.key)
def test_clips_are_the_benchmarks_clips(tmp_path, st):
    a, b = tmp_path / "a.yuv", tmp_path / "b.yuv"
    B.make_clip(str(a), st.w, st.h, 2)
    _bench().make_clip(str(b), st.w, st.h, 2)
    assert a.read_bytes() == b.read_bytes()
    assert len(a.read_bytes()) == 2 * st.w * st.h * 3 // 2


@pytest.mark.parametrize("st", B.STAGES[:2], ids=lambda s: s.key)
def test_streams_equal_bench_py_under_the_jax_package(tmp_path, st):
    """Config 1's and config 2's options on a 3-frame 128x64 cut: the
    twin's encode_once writes bench.py's encode_once's bytes."""
    w, h, n = 128, 64, 3
    clip = str(tmp_path / "c.yuv")
    B.make_clip(clip, w, h, n)
    _bench().encode_once(clip, str(tmp_path / "j.266"), w, h, n, st.qp,
                         st.preset, list(st.extra))
    _, enc = B.encode_once(clip, str(tmp_path / "t.266"), w, h, n, st.qp,
                           st.preset, st.extra, device="cpu")
    want = (tmp_path / "j.266").read_bytes()
    assert len(want) > 0 and (tmp_path / "t.266").read_bytes() == want
    assert enc.cfg.device == "cpu" and len(enc.recs_by_poc) == n


def test_summary_has_bench_py_keys_and_the_records(summary_line):
    out = json.loads(summary_line)
    keys = ["metric", "value", "unit", "vs_baseline", "vs_baseline_1t",
            "device_time_fraction", "secondary"]
    assert list(out) == keys + ["runs", "card", "host"]
    c1, c2, c3 = (st.key for st in B.STAGES)
    assert list(out["secondary"]) == [
        k + s for k in (c2, c3) for s in ("", "_ref", "_vs_ref")]
    assert out["unit"] == "frames/s" and out["card"] == "cpu"
    assert "on cpu" in out["metric"] and "one chip" not in out["metric"]
    assert list(out["runs"]) == [c1, c2, c3]
    for st in B.STAGES:
        r = out["runs"][st.key]
        assert len(r["fps"]) == st.passes and all(f > 0 for f in r["fps"])
        assert r["median_fps"] == sorted(r["fps"])[st.passes // 2]
        assert r["spread"] == pytest.approx(
            (max(r["fps"]) - min(r["fps"])) / r["median_fps"])
        # the plain versions on the CPU: no launch; the twin reports no
        # device share on any device
        assert r["launches"] == {} and r["device_share"] is None
    assert out["value"] == out["runs"][c1]["median_fps"]
    assert out["secondary"][c2] == out["runs"][c2]["median_fps"]
    assert out["host"]["cpu_count"] == os.cpu_count()
    assert out["host"]["max_parallel_frames"][c3] == 2     # --threads 2


def test_without_a_reference_every_ratio_is_null(summary_line):
    out = json.loads(summary_line)
    assert out["vs_baseline"] is None and out["vs_baseline_1t"] is None
    nulls = [k for k in out["secondary"] if k.endswith(("_ref", "_vs_ref"))]
    assert len(nulls) == 4
    assert all(out["secondary"][k] is None for k in nulls)
    assert "11.6" not in summary_line
    assert "11.6" not in (ROOT / "vvenc_tpu_torch" / "bench.py").read_text()


def test_a_failed_encode_raises_and_prints_no_json(monkeypatch, capsys):
    def boom(self, frames):
        raise RuntimeError("encode failed on purpose")
    monkeypatch.setattr(IntraEncoder, "encode_sequence", boom)
    monkeypatch.setattr(B, "STAGES", _small_stages())
    with pytest.raises(RuntimeError, match="on purpose"):
        B.main(["--device", "cpu", "--ref-bin", NO_REF])
    assert not [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("{")]


def _run(code_or_module, tmp_path, *args):
    env = dict(os.environ, TMPDIR=str(tmp_path))
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *code_or_module, *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)


def test_an_overrun_stage_ends_the_run_naming_it(tmp_path):
    """The first stage's wall limit cut to 0.5 s: the process exits 1
    naming the stage, prints no JSON line and leaves no work directory."""
    code = ("import sys, dataclasses\n"
            "from vvenc_tpu_torch import bench as B\n"
            "B.STAGES = tuple(dataclasses.replace(s, limit_s=0.5) "
            "for s in B.STAGES)\n"
            f"sys.exit(B.main(['--device', 'cpu', '--ref-bin', {NO_REF!r}]))"
            "\n")
    r = _run(["-c", code], tmp_path)
    assert r.returncode == 1, r.stderr
    assert (f"stage {B.STAGES[0].key} overran its wall limit of 0.5 s"
            in r.stderr)
    assert '{"metric"' not in r.stdout
    assert not list(tmp_path.glob("vvenc_bench_*"))


def test_without_a_card_the_module_exits_nonzero_naming_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    r = _run(["-m", "vvenc_tpu_torch.bench"], tmp_path)
    assert r.returncode != 0
    assert "cuda" in r.stderr and '{"metric"' not in r.stdout
    # resolved before any clip is made
    assert not list(tmp_path.iterdir())

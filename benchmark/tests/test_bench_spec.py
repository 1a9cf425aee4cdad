"""Discovery of cells, configurations, mixes, metrics and limits by name,
and the shape BENCHMARK.json keeps."""

import json
import re

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # a full check fits in 12 hours, and would with the full 24 cells
    for n in (cells, 24):
        assert (2 + 14 * n) * (BENCH["run_seconds"] + 60) \
            + n * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_is_found_by_name(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
    cfg = spec.config(BENCH, c["name"])
    assert cfg["name"] == c["name"]
    for k in c["reduced"]:
        assert NAME.match(k) and k in cfg["reduced_from_source"]
    assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_finds_its_files(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and w["chips"] == 1
    assert 1 <= len(w["why"]) <= 200
    mix = spec.traffic(w["traffic"], w["config"])
    ent = spec.entry(mix["entry"])
    assert callable(ent.Driver) and callable(ent.judge)
    assert spec.limits(w["name"])
    e2e = {m["name"] for m in spec.metrics_for(BENCH, w["name"],
                                                "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = spec.metrics_for(BENCH, w["name"], "per_layer")
    assert layers
    for m in layers:
        assert m["moves"] in e2e
        assert callable(spec.reader(m["name"]).read)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_shape(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if "bound" in m:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", [])) <= cells
    if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
        assert m["unit"] == "%"


def test_traffic_files_hold_only_data():
    for p in (spec.HERE / "traffic").rglob("*"):
        assert p.is_dir() or p.suffix in (".json", ".jsonl", ".toml",
                                          ".txt", ".csv")


def test_entries_are_found_by_name():
    assert spec.entry("cli").__name__ == "benchmark.entries.cli"
    with pytest.raises(KeyError):
        spec.entry("no_such_entry")


def test_reader_falls_back_to_the_base_name():
    assert spec.reader("device_idle_share.file") is not None
    with pytest.raises(KeyError):
        spec.reader("no_such_metric")

"""Finds what BENCHMARK.json names: cells, configurations, traffic mixes,
per-layer readers, roofline counts and limits, each by its name.

Everything that belongs to one configuration, one traffic mix or one
metric sits in a file of its own under benchmark/, so a later change adds
a cell by adding files and entries and edits none that is there:

  configs/<config>.json         the configuration as it is run
  traffic/<mix>.json            a traffic mix's parameters, among them
                                the `entry` it drives
  entries/<entry>.py            the code that drives an entry of the
                                port and judges what it produced
  traffic/<mix>/<config>.json   parameters of that mix for one
                                configuration (merged over the mix's)
  metrics/<metric>.py           a per-layer metric's reader; a metric
                                named <base>.<suffix> falls back to
                                metrics/<base>.py
  rooflines/<entry>.py          the least time of a device entry's work
  limits/<cell>.json            the limits of the cell's compared numbers
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent


def load_benchmark(path=None) -> dict:
    with open(path or REPO / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(REPO / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(mix: str, config_name: str) -> dict:
    with open(HERE / "traffic" / f"{mix}.json") as f:
        out = json.load(f)
    own = HERE / "traffic" / mix / f"{config_name}.json"
    if own.exists():
        with open(own) as f:
            out.update(json.load(f))
    return out


def entry(name: str):
    """The module of entries/<name>.py: Driver(run) and judge(run,
    driver, result)."""
    if not (HERE / "entries" / f"{name}.py").exists():
        raise KeyError(f"no entry named {name!r} under entries/")
    return importlib.import_module(f"benchmark.entries.{name}")


def limits(cell: str) -> dict:
    with open(HERE / "limits" / f"{cell}.json") as f:
        return json.load(f)


def metrics_for(bench: dict, cell: str, kind: str) -> list:
    """The `kind` ("end_to_end" or "per_layer") metrics that `cell`
    reports: those that list it, and those without a list that move an
    end-to-end metric the cell reports (every end-to-end metric without
    a list is reported in every cell)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def _load(path: pathlib.Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The module whose read(ctx) gives `metric`: metrics/<metric>.py,
    else metrics/<base>.py for a name <base>.<suffix>."""
    for stem in (metric, metric.split(".")[0]):
        p = HERE / "metrics" / f"{stem}.py"
        if p.exists():
            return _load(p, "benchmark.metrics." + stem.replace(".", "_"))
    raise KeyError(f"no reader for metric {metric!r} under metrics/")


def roofline(entry: str):
    return _load(HERE / "rooflines" / f"{entry}.py",
                 "benchmark.rooflines." + entry)


def peaks() -> dict:
    with open(HERE / "rooflines" / "peaks.json") as f:
        return json.load(f)

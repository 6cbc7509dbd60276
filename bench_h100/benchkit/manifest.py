"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (its file is the one ``configs`` gives) and
a traffic mix (``bench_h100/traffic/<traffic>.json``); its limits are in
``bench_h100/cells/<cell>.json``; each metric is read by
``bench_h100/metrics/<metric>.py``.  A metric with a ``workloads`` list is
the listed cells'; one without it is every cell's.  Adding a cell, a
configuration, a mix or a metric is adding files and entries.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]          # bench_h100/
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(root: Path = ROOT) -> dict:
    return _read(Path(root) / "BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    bench = load(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    here = root / "bench_h100"
    return Cell(name=name, entry=entry, config=_read(root / conf["file"]),
                traffic=_read(here / "traffic" / f"{entry['traffic']}.json"),
                limits=_read(here / "cells" / f"{name}.json"),
                end_to_end=[x for x in bench["end_to_end"]
                            if applies(x, name)],
                per_layer=[x for x in bench["per_layer"] if applies(x, name)])


def reader(metric: str, root: Path = ROOT):
    """``read(record)`` of ``bench_h100/metrics/<metric>.py``."""
    path = Path(root) / "bench_h100" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

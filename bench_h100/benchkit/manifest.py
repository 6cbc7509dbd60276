"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (its file is the one ``configs`` gives) and
a traffic mix (``bench_h100/traffic/<traffic>.json``); its limits are in
``bench_h100/cells/<cell>.json``; each metric is read by
``bench_h100/metrics/<metric>.py``.  A configuration file names its layer
layout (``"layout"``), whose code is ``bench_h100/layouts/<layout>.py``.
A metric with a ``workloads`` list is the listed cells'; one without it is
every cell's.  Adding a cell, a configuration, a layout, a mix or a metric
is adding files and entries.
"""
from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]          # bench_h100/
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    layout: object           # the module of the configuration's layout
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    def __deepcopy__(self, memo):
        """A copy of the cell's data, sharing its layout's code."""
        memo[id(self.layout)] = self.layout
        return Cell(**{f.name: copy.deepcopy(getattr(self, f.name), memo)
                       for f in dataclasses.fields(self)})


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
    config = _read(root / conf["file"])
    if "layout" not in config:
        raise ValueError(f'{conf["file"]} has no "layout" key: a '
                         "configuration names its layer layout, the file "
                         "bench_h100/layouts/<layout>.py")
    here = root / "bench_h100"
    return Cell(name=name, entry=entry, config=config,
                layout=layout(config["layout"], root),
                traffic=_read(here / "traffic" / f"{entry['traffic']}.json"),
                limits=_read(here / "cells" / f"{name}.json"),
                end_to_end=[x for x in bench["end_to_end"]
                            if applies(x, name)],
                per_layer=[x for x in bench["per_layer"] if applies(x, name)])


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod          # a dataclass looks its module up
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def _safe(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def layout(name: str, root: Path = ROOT):
    """The module ``bench_h100/layouts/<name>.py``: a layer layout's
    program, weights, reference and counts."""
    return _module(Path(root) / "bench_h100" / "layouts" / f"{name}.py",
                   "bench_layout_" + _safe(name))


def reader(metric: str, root: Path = ROOT):
    """``read(record)`` of ``bench_h100/metrics/<metric>.py``."""
    return _module(Path(root) / "bench_h100" / "metrics" / f"{metric}.py",
                   "bench_metric_" + _safe(metric)).read

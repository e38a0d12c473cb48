"""BENCHMARK.json and the files it names, found by name.

A cell (`workloads` entry) names a configuration and a traffic mix; the
configuration is `configs/<config>.json`, the traffic `traffic/<traffic>.json`,
a per-layer metric's reader `metrics/<name>.py` (a `read(ctx)` function),
and a cell's correctness limits `limits/<cell>.json`.  Nothing here
imports torch or the program.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(kind: str, name: str, here: Path = HERE) -> dict:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a name")
    with open(here / kind / f"{name}.json") as f:
        return json.load(f)


def config(name: str, here: Path = HERE) -> dict:
    return _json("configs", name, here)


def traffic(name: str, here: Path = HERE) -> dict:
    return _json("traffic", name, here)


def limits(cell: str, here: Path = HERE) -> dict:
    return _json("limits", cell, here)


def metric_reader(name: str, here: Path = HERE):
    """The `read(ctx)` function of metrics/<name>.py."""
    if not NAME.match(name):
        raise ValueError(f"metric name {name!r} is not a name")
    package = f"{__package__}.metrics"
    importlib.import_module(package)
    # a module of the metrics package (a dot in the name would make another
    # parent), so that its relative imports reach the harness
    found = importlib.util.spec_from_file_location(
        f"{package}.{name.replace('.', '_')}", here / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(found)
    found.loader.exec_module(module)
    return module.read


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The `kind` ('end_to_end' or 'per_layer') metric entries that `cell`
    reports: those without `workloads`, and those that list it."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]

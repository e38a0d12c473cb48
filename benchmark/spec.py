"""BENCHMARK.json and the files it names, found by name.

A cell (`workloads` entry) names a configuration and a traffic mix; the
configuration is `configs/<config>.json`, the traffic `traffic/<traffic>.json`,
a per-layer metric's reader `metrics/<name>.py` (a `read(ctx)` function),
a cell's correctness limits `limits/<cell>.json`, and the check's
reference of the traffic's render mode `reference/<mode>.py`.  Nothing
here imports torch or the program.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
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


def _module(kind: str, name: str, here: Path):
    """`here`/<kind>/<name>.py, loaded as a module of the harness's <kind>
    package (a dot in the name would make another parent), so that its
    relative imports reach the harness."""
    package = f"{__package__}.{kind}"
    importlib.import_module(package)
    found = importlib.util.spec_from_file_location(
        f"{package}.{name.replace('.', '_')}", here / kind / f"{name}.py")
    module = importlib.util.module_from_spec(found)
    # in sys.modules while it runs (a dataclass looks its module up there),
    # then as before, so that a copy's module replaces none of the harness's
    previous = sys.modules.get(found.name)
    sys.modules[found.name] = module
    try:
        found.loader.exec_module(module)
    finally:
        if previous is None:
            del sys.modules[found.name]
        else:
            sys.modules[found.name] = previous
    return module


def metric_reader(name: str, here: Path = HERE):
    """The `read(ctx)` function of metrics/<name>.py."""
    if not NAME.match(name):
        raise ValueError(f"metric name {name!r} is not a name")
    return _module("metrics", name, here).read


def mode_reference(mode: str, here: Path = HERE):
    """The check's reference of render mode `mode`, reference/<mode>.py:
    its `CONFIG_KEYS` (the configuration keys it reads beyond those every
    cell has), `RENDER` (render-block field -> the values it reproduces;
    a field it does not name, at any value), `FULL_RING` (whether the
    check reads the whole ring after a frame, or its pushed row only),
    and `image(s, after, ring, colors, config)` and `control(s, after,
    colors, config)` (see check.py), where `config` holds the
    configuration's values of the keys in CONFIG_KEYS and of no other.
    LookupError where there is no such file or the module renders
    nothing (physics.py, scene.py)."""
    if NAME.match(mode) and (here / "reference" / f"{mode}.py").is_file():
        module = _module("reference", mode, here)
        if callable(getattr(module, "image", None)):
            return module
    raise LookupError(f"the check does not model mode {mode!r}")


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The `kind` ('end_to_end' or 'per_layer') metric entries that `cell`
    reports: those without `workloads`, and those that list it."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]

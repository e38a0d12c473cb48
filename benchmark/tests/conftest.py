"""Fixtures of the benchmark's CPU tests (run them with
`python -m pytest benchmark/tests -q` from the repository root)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
sys.path.insert(0, str(ROOT))


@pytest.fixture
def tiny(tmp_path):
    """A benchmark folder with the tiny cells `tiny.retarded` and
    `tiny.points` (and the metric readers and the modes' references),
    held to the limits of refdemo_116k.retarded and
    capacity_2p20.points; returns (bench, here)."""
    here = tmp_path / "bench"
    shutil.copytree(HERE / "tiny", here)
    for kind in ("metrics", "reference"):
        shutil.copytree(ROOT / "benchmark" / kind, here / kind)
    (here / "limits").mkdir()
    bench = {"workloads": [], "per_layer": [],
             "end_to_end": [{"name": "fps", "unit": "frames/s"},
                            {"name": "frame_p95_ms", "unit": "ms"},
                            {"name": "setup_s", "unit": "s"}]}
    for mode, limits in (("retarded", "refdemo_116k.retarded"),
                         ("points", "capacity_2p20.points")):
        name = f"tiny.{mode}"
        bench["workloads"].append({"name": name, "config": "tiny", "traffic": mode,
                                   "chips": 1, "why": "test"})
        shutil.copy(ROOT / "benchmark" / "limits" / f"{limits}.json",
                    here / "limits" / f"{name}.json")
    return bench, here


@pytest.fixture
def tiny_conical(tmp_path):
    """A copy of the benchmark folder with the tiny conical cell
    `tiny_conical.conical` added as new files only (tiny's conical
    configuration and traffic, and refdemo_116k.retarded's limits) and no
    edit to any file; returns (bench, here)."""
    from benchmark import spec

    here = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", here, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE / "tiny" / "configs" / "tiny_conical.json", here / "configs")
    shutil.copy(HERE / "tiny" / "traffic" / "conical.json", here / "traffic")
    shutil.copy(here / "limits" / "refdemo_116k.retarded.json",
                here / "limits" / "tiny_conical.conical.json")
    bench = spec.load_benchmark(ROOT)
    bench["workloads"].append({"name": "tiny_conical.conical", "config": "tiny_conical",
                               "traffic": "conical", "chips": 1, "why": "test"})
    return bench, here


def quiet(*args, **kwargs):
    pass


def load_json(path):
    with open(path) as f:
        return json.load(f)

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


def quiet(*args, **kwargs):
    pass


def load_json(path):
    with open(path) as f:
        return json.load(f)

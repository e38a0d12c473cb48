"""The conical_defect_1024 cell: its committed files load and the check
models them, the Engine gets the preset's world at 1024x1024, and the
route-work readers read the Engine's running totals."""

import types

import pytest
import torch

from benchmark import check, harness, spec
from benchmark.tests.conftest import ROOT

BENCH = spec.load_benchmark(ROOT)
CELL = "conical_defect_1024.conical"
READERS = {"route_pass_mtests": "route_pass_tests", "route2_sweep_mrows": "route2_sweep_rows"}


def test_the_cell_loads_and_the_check_models_it():
    cell = harness.Cell.load(BENCH, CELL)
    check.require_modeled(cell.config, cell.traffic)
    assert cell.traffic["mode"] == "conical"
    assert set(cell.limits) == set(check.NUMBERS)
    for name in READERS:
        (m,) = [m for m in BENCH["per_layer"] if m["name"] == name]
        assert m["workloads"] == [CELL] and m["moves"] == "fps"


def test_the_engine_gets_the_preset_world_at_1024():
    from spacetime_tpu_torch.engine import Engine
    from spacetime_tpu_torch.utils.config import get_config

    built = harness.engine_config(harness.Cell.load(BENCH, CELL))
    preset = get_config("conical_defect")
    assert built.scene == preset.scene
    assert (built.defect, built.cam_pos, built.cam_zoom, built.history) == (
        preset.defect, preset.cam_pos, preset.cam_zoom, preset.history)
    assert (built.width, built.height, built.render_mode) == (1024, 1024, "conical")
    assert Engine(built, device="cpu")._render_params().cell_px == 8


def test_the_readers_give_the_engines_totals_a_frame(tiny_conical):
    bench, here = tiny_conical
    torch.set_num_threads(2)
    run = harness.Run(harness.Cell.load(bench, "tiny_conical.conical", here), 2 ** 35 + 1,
                      "cpu")
    for _ in range(3):
        run.engine.run_frame()
    work = run.engine.render_work
    p = run.engine._render_params()
    assert work["frames"] == 3
    assert work["route_pass_tests"] == 3 * 96 * 64 * p.bin_capacity * 2
    assert work["route2_sweep_rows"] == 3 * 64 * run.engine.worldline.num_particles
    for name, key in READERS.items():
        read = spec.metric_reader(name, here)
        assert read({"engine": run.engine}) == pytest.approx(work[key] / 3 / 1e6)
        assert read({"engine": types.SimpleNamespace()}) is None

"""BENCHMARK.json and the files it names: every piece loads by its name,
names and units keep to their characters, every cell reports what its
layer metrics move, and a new cell needs new files only."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import check, harness, spec, traffic
from benchmark.tests.conftest import ROOT, quiet

BENCH = spec.load_benchmark(ROOT)
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_paths():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "-m", "benchmark.run"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_every_named_piece_loads():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        loaded = spec.config(c["name"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert loaded["name"] == c["name"] and loaded["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        cell = harness.Cell.load(BENCH, w["name"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        check.require_modeled(cell.config, cell.traffic)
        assert set(cell.limits) >= set(harness.check.NUMBERS)
    for m in BENCH["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert spec.NAME.match(n), n
    for w in BENCH["workloads"]:
        assert spec.NAME.match(w["config"]) and spec.NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_moves_targets_are_reported_where_the_layer_metric_is():
    cells = [w["name"] for w in BENCH["workloads"]]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert m["moves"] in {x["name"] for x in spec.metrics_of(BENCH, cell, "end_to_end")}
    for cell in cells:
        reported = {x["name"] for x in spec.metrics_of(BENCH, cell, "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.metrics_of(BENCH, cell, "per_layer")


def test_four_chip_cells_at_most_a_quarter():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


def _copy(tmp_path):
    here = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", here, ignore=shutil.ignore_patterns("__pycache__"))
    return here


def test_a_new_cell_is_new_files_only(tmp_path):
    """A new traffic mix and a new workloads entry are found by name, with
    no edit to the harness."""
    here = _copy(tmp_path)
    mix = json.loads((here / "traffic" / "points.json").read_text())
    mix["pan"]["hold_frames"] = [25]
    (here / "traffic" / "points_slow_pan.json").write_text(json.dumps(mix))
    shutil.copy(here / "limits" / "capacity_2p20.points.json",
                here / "limits" / "refdemo_116k.points_slow_pan.json")
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        {"name": "refdemo_116k.points_slow_pan", "config": "refdemo_116k",
         "traffic": "points_slow_pan", "chips": 1, "why": "test"}])
    cell = harness.Cell.load(bench, "refdemo_116k.points_slow_pan", here)
    check.require_modeled(cell.config, cell.traffic)
    frames = cell.config["episode"]["frames"]
    script = traffic.pan_script(cell.traffic["pan"], frames, 7)
    assert len(script) == frames and sum(bool(k) for k in script) == 4 * 25


def test_a_new_configuration_is_new_files_only(tmp_path):
    """A new configuration (its own physics and EngineConfig fields), its
    limits and a workloads entry are found by name; the Engine and the
    reference both take its physics."""
    here = _copy(tmp_path)
    cfg = json.loads((here / "configs" / "refdemo_116k.json").read_text())
    cfg.update(name="stiff_pair", width=320, height=180, max_fps=60.0, diag_every=15,
               physics={"k": 20000.0, "collision_repulsion_coefficient": 80.0,
                        "bond_break_threshold": 0.012})
    (here / "configs" / "stiff_pair.json").write_text(json.dumps(cfg))
    shutil.copy(here / "limits" / "refdemo_116k.retarded.json",
                here / "limits" / "stiff_pair.retarded.json")
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        {"name": "stiff_pair.retarded", "config": "stiff_pair", "traffic": "retarded",
         "chips": 1, "why": "test"}])
    cell = harness.Cell.load(bench, "stiff_pair.retarded", here)
    check.require_modeled(cell.config, cell.traffic)
    built = harness.engine_config(cell)
    assert (built.width, built.height, built.max_fps, built.diag_every) == (320, 180, 60.0, 15)
    assert built.cam_pos == (0.6, 0.4) and built.render_mode == "retarded"
    assert (built.physics.k, built.physics.collision_repulsion_coefficient) == (20000.0, 80.0)
    ref = check.physics_params(cell.config)
    assert (ref.k, ref.repulsion, ref.break_threshold) == (20000.0, 80.0, 0.012)
    assert (ref.h, ref.collision_distance) == (built.physics.h, built.physics.collision_distance)


STUB = '''"""A stub of the instant view's reference: the program's own image
with as many pixels of its first row changed as its configuration's
`stub_pixels` says, which fails if the check hands it the whole ring or a
key it does not declare."""

CONFIG_KEYS = frozenset({"steps_per_frame", "stub_pixels"})
RENDER = {}
FULL_RING = False


def image(s, after, ring, colors, config):
    if "pos_x" in ring:
        raise AssertionError("the harness kept the whole ring")
    if set(config) != CONFIG_KEYS:
        raise AssertionError(f"the check handed the stub the keys {sorted(config)}")
    img = s.image.clone()
    img[:, 0, :config["stub_pixels"]] += 1.0
    return img, {}


def control(s, after, colors, config):
    return image(s, after, s.ring, colors, config)
'''


def test_a_new_mode_is_new_files_only(tmp_path):
    """A reference of a mode (the Engine's `instant`), a configuration with
    keys that only that reference models, its traffic, limits and a
    workloads entry: the check and the harness take the mode from the new
    file, found through `here`, and hand its image the values of its keys
    (one of them no EngineConfig field) and of no other."""
    here = _copy(tmp_path)
    (here / "reference" / "instant.py").write_text(STUB)
    cfg = json.loads((here / "tests" / "tiny" / "configs" / "tiny.json").read_text())
    cfg.update(name="tiny_instant", steps_per_frame=1, stub_pixels=3)
    (here / "configs" / "tiny_instant.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "tests" / "tiny" / "traffic" / "points.json").read_text())
    (here / "traffic" / "instant.json").write_text(json.dumps(dict(mix, mode="instant")))
    shutil.copy(here / "limits" / "refdemo_116k.retarded.json",
                here / "limits" / "tiny_instant.instant.json")
    bench = dict(BENCH, per_layer=[], workloads=BENCH["workloads"] + [
        {"name": "tiny_instant.instant", "config": "tiny_instant", "traffic": "instant",
         "chips": 1, "why": "test"}])
    cell = harness.Cell.load(bench, "tiny_instant.instant", here)
    check.require_modeled(cell.config, cell.traffic, here)
    with pytest.raises(ValueError, match="does not model steps_per_frame"):
        check.require_modeled(cell.config, dict(cell.traffic, mode="retarded"), here)
    # the whole ring for a mode named other than "points" (the stub raises
    # if handed it), and the stub's image, with its `stub_pixels`, in the check
    torch.set_num_threads(2)
    result = harness.run_cell(bench, cell.name, 2 ** 33 + 5, 0.5, False, "cpu", here=here,
                              log=quiet)
    assert result["checked"]["image_px_share"]["value"] == 3 / (96 * 64)
    assert result["checked"]["ring_mismatch"]["value"] == 0


def test_a_conical_cell_is_new_files_only(tiny_conical):
    """The conical mode's reference, with a configuration that names its
    defect, its traffic, its limits and a workloads entry, all new files
    in a copy of the benchmark folder: the run reads `correct`, with the
    program's image and counters equal to the reference's on the CPU."""
    bench, here = tiny_conical
    cell = harness.Cell.load(bench, "tiny_conical.conical", here)
    check.require_modeled(cell.config, cell.traffic, here)
    assert harness.engine_config(cell).defect == ((0.03, 0.05), 3.0)
    torch.set_num_threads(2)
    result = harness.run_cell(bench, cell.name, 2 ** 34 + 3, 0.5, False, "cpu", here=here,
                              log=quiet)
    assert result["correct"], result["checked"]
    got = {k: v["value"] for k, v in result["checked"].items()}
    assert got["image_px_share"] == 0.0 and got["render_counter_gap"] == 0.0


@pytest.mark.parametrize("change", [{"defect_vel": [[0.1, 0.0]]}, {"defect_retarded": True},
                                    {"defect_source": [[0, None]]}, {"defect_G": 1.0},
                                    {"render": {"camera_frame": True}}])
def test_what_the_conical_reference_does_not_model_is_refused(change):
    cfg = json.loads((ROOT / "benchmark" / "tests" / "tiny" / "configs"
                      / "tiny_conical.json").read_text())
    if "render" in change:
        cfg["render"] = {**cfg["render"], **change["render"]}
    else:
        cfg.update(change)
    with pytest.raises(ValueError, match="does not model"):
        check.require_modeled(cfg, {"mode": "conical"})


def test_the_mode_reference_gets_its_declared_keys_only():
    ref = spec.mode_reference("conical")
    cfg = dict(spec.config("refdemo_116k"), defect=[[0.5, 0.55], 1.2])
    assert check.mode_config(cfg, ref) == {"defect": [[0.5, 0.55], 1.2]}
    assert check.mode_config(cfg, spec.mode_reference("retarded")) == {}


@pytest.mark.parametrize("mode", ["physics", "scene", "__init__", "no_such_mode", "../check"])
def test_a_mode_without_a_reference_is_refused(mode):
    with pytest.raises(LookupError, match="does not model mode"):
        spec.mode_reference(mode)


@pytest.mark.parametrize("change", [{"steps_per_frame": 4}, {"cam_vel": [0.1, 0.0]},
                                    {"defect": [[0.5, 0.5], 0.3]},
                                    {"physics": {"gravity": 1.0}}, {"mode": "warp"},
                                    {"render": {"camera_frame": True}},
                                    {"render": {"opaque": False}},
                                    {"render": {"retarded": False}}])
def test_a_field_the_check_does_not_model_is_refused(change):
    cfg = dict(spec.config("refdemo_116k"))
    mix = dict(spec.traffic("retarded"))
    if "mode" in change:
        mix.update(change)
    elif "render" in change:
        cfg["render"] = {**cfg["render"], **change["render"]}
    else:
        cfg.update(change)
    with pytest.raises(ValueError, match="does not model"):
        check.require_modeled(cfg, mix)


def test_the_reference_physics_defaults_are_the_programs():
    from spacetime_tpu_torch.constants import PhysicsParams

    program = dataclasses.asdict(PhysicsParams())
    ref = check.physics_params({})._asdict()
    for name, mine in check.PHYSICS.items():
        if mine is not None:
            assert ref[mine] == pytest.approx(program[name], rel=1e-12), name
    assert set(program) == set(check.PHYSICS)


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "refdemo_116k.retarded",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_a_run_alone_with_its_files_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_a_run_without_a_card_prints_no_result():
    proc = _run(ROOT, dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr

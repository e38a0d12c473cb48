"""The check fails a run whose timed path is broken underneath: a step
that returns its state unchanged, half of the particles left unstepped, a
share of the particles or a single one, a ring row or an image altered where it is produced, and the
bfloat16 control in the program's place; in the conical mode, the Engine
built with another deficit than its configuration's.  (A cell on one card
has no exchange between chips to leave out.)  Each is a whole run of a tiny
cell on the CPU past the harness's look for a card."""

import dataclasses

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import quiet


def _run(tiny, mode, control=False):
    bench, here = tiny
    torch.set_num_threads(2)
    return harness.run_cell(bench, f"tiny.{mode}", 4242424242, 0.5, False, "cpu",
                            control=control, here=here, log=quiet)


def _patch_step(monkeypatch, change):
    from spacetime_tpu_torch.models.softbody import SoftbodyModel

    step = SoftbodyModel.step

    def broken(self, particles, materials=None):
        new, aux = step(self, particles, materials)
        return change(particles, new), aux

    monkeypatch.setattr(SoftbodyModel, "step", broken)


@pytest.mark.parametrize("mode", ["retarded", "points"])
def test_a_step_that_returns_its_state_unchanged_fails(tiny, monkeypatch, mode):
    _patch_step(monkeypatch, lambda old, new: old)
    assert _run(tiny, mode)["correct"] is False


def test_half_of_the_particles_left_unstepped_fails(tiny, monkeypatch):
    def half(old, new):
        n = old.capacity // 2
        keep = lambda a, b: torch.cat([b[:n], a[n:]])
        return dataclasses.replace(new, pos=keep(old.pos, new.pos), vel=keep(old.vel, new.vel))

    _patch_step(monkeypatch, half)
    assert _run(tiny, "retarded")["correct"] is False


def test_one_percent_of_the_particles_altered_where_the_step_produces_them_fails(
        tiny, monkeypatch):
    def nudge(old, new):
        rows = old.active.nonzero()[::100, 0]
        pos = new.pos.clone()
        pos[rows, 0] += 1e-3
        return dataclasses.replace(new, pos=pos)

    _patch_step(monkeypatch, nudge)
    assert _run(tiny, "retarded")["correct"] is False


def test_one_particle_altered_where_the_step_produces_it_fails(tiny, monkeypatch):
    def nudge(old, new):
        row = int(old.active.nonzero()[0, 0])
        pos = new.pos.clone()
        pos[row, 1] += 0.01
        return dataclasses.replace(new, pos=pos)

    _patch_step(monkeypatch, nudge)
    result = _run(tiny, "points")
    assert result["correct"] is False
    assert result["checked"]["step_pos_max_ls"]["value"] > 0.005


def test_a_push_a_tick_late_fails(tiny, monkeypatch):
    from spacetime_tpu_torch.ops import worldline

    push = worldline.push_frame

    def late(buf, particles, time, present=None):
        return push(buf, particles, time + 0.005, present=present)

    monkeypatch.setattr(worldline, "push_frame", late)
    assert _run(tiny, "points")["correct"] is False


def test_an_image_altered_where_the_render_produces_it_fails(tiny, monkeypatch):
    from spacetime_tpu_torch.ops import raytrace

    render = raytrace.render_retarded_with_diag

    def dimmed(*args, **kwargs):
        img, diag = render(*args, **kwargs)
        return img * 0.99, diag

    monkeypatch.setattr(raytrace, "render_retarded_with_diag", dimmed)
    assert _run(tiny, "retarded")["correct"] is False


def test_a_point_view_altered_where_it_is_produced_fails(tiny, monkeypatch):
    from spacetime_tpu_torch.ops import rasterize

    render = rasterize.render_points

    def shifted(particles, objects, cam, width, height, planar=False):
        return torch.roll(render(particles, objects, cam, width, height, planar=planar), 1, -1)

    monkeypatch.setattr(rasterize, "render_points", shifted)
    assert _run(tiny, "points")["correct"] is False


@pytest.mark.parametrize("mode", ["retarded", "points"])
def test_the_bfloat16_control_fails(tiny, mode):
    assert _run(tiny, mode, control=True)["correct"] is False


def _run_conical(tiny_conical, control=False):
    bench, here = tiny_conical
    torch.set_num_threads(2)
    return harness.run_cell(bench, "tiny_conical.conical", 2 ** 34 + 11, 0.5, False, "cpu",
                            control=control, here=here, log=quiet)


@pytest.mark.parametrize("scale", [1.01, 0.0])
def test_an_engine_built_with_another_deficit_fails(tiny_conical, monkeypatch, scale):
    """The Engine built with the file's deficit 1% too large, and with the
    deficit 0 (no defect: flat space), against the reference at the
    file's defect."""
    from spacetime_tpu_torch.engine import Engine

    init = Engine.__init__

    def other(self, config, *args, **kwargs):
        center, deficit = config.defect
        init(self, dataclasses.replace(config, defect=(center, deficit * scale)), *args,
             **kwargs)

    monkeypatch.setattr(Engine, "__init__", other)
    assert _run_conical(tiny_conical)["correct"] is False


def test_the_conical_bfloat16_control_fails(tiny_conical):
    assert _run_conical(tiny_conical, control=True)["correct"] is False

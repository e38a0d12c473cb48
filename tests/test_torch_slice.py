"""The port's headline frame as a whole — SoftbodyModel.step ->
worldline.push_frame -> raytrace.render_retarded, as bench.py drives it —
against the JAX reference for a few frames through an impact, on the CPU
at a small size.

The JAX side runs its production dataflow: SoftbodyModel with the Pallas
collision kernel (interpret mode) and the XLA pixel path.
"""

import dataclasses
import importlib
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetime_tpu import scene as jscene
from spacetime_tpu.camera import Camera as JCamera
from spacetime_tpu.models.softbody import SoftbodyModel as JModel
from spacetime_tpu.ops import forces as jforces
from spacetime_tpu.ops import raytrace as jrt
from spacetime_tpu.ops import worldline as jwl
from spacetime_tpu_torch import compare_kernels, kernels, profile_frame, scene
from spacetime_tpu_torch.camera import Camera
from spacetime_tpu_torch.models.softbody import SoftbodyModel
from spacetime_tpu_torch.ops import band_cuda, forces, raytrace
from spacetime_tpu_torch.ops import worldline as wl

H = 0.005
W, HT = 96, 64
FRAMES = 4
# positions: collision sums in another f32 order (see test_torch_physics);
# images: at most 0.1% of pixels may flip at capsule edges
POS_ATOL = 1e-5
PIXEL_TOL, PIXEL_SHARE = 1e-3, 1e-3
DROP_COUNTERS = ("band_truncated", "bin_dropped", "cell_too_small", "retina_dropped",
                 "entry_dropped")


def _fields(x):
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x) if getattr(x, f.name) is not None}


def _jparams():
    # the bench's RenderParams (bench.py:78-86) scaled to a 96x64 view, with
    # budgets that hold every entry (all drop counters 0) while the pair and
    # retina budgets still cut the raw (N * band) layout
    return jrt.RenderParams(dt=H, num_rays=512, pair_budget=512, bin_capacity=128, cell_px=9,
                            occlusion_downsample=3, ray_chunk=256, retina_budget=512,
                            max_age=48, entry_budget=4096, backend="xla")


def _scene(mod):
    sb = mod.SceneBuilder()
    sb.add(mod.disc_softbody(4, 0, (0.35, 0.40), (0.25, 0.05), lattice_pad=True),
           base_color=(0.25, 0.35, 1.0))
    sb.add(mod.disc_softbody(4, 1, (0.3795, 0.405), (-0.25, -0.05), lattice_pad=True),
           base_color=(1.0, 0.3, 0.25))
    return sb.build()


def _run_port(device, frames):
    p, objects = _scene(scene)
    p, objects = p.to(device), objects.to(device)
    model = SoftbodyModel(p.capacity, forces.derive_spring_offsets(p.neighbors.cpu().numpy()),
                          device=device)
    buf = wl.prefill_inertial(wl.create(64, p.capacity, device=device), p.pos, p.vel,
                              p.active, 0.0, H)
    cam = Camera.create(pos=(0.37, 0.41), zoom=0.15, device=device)
    params = raytrace.RenderParams(**{f.name: getattr(_jparams(), f.name)
                                      for f in dataclasses.fields(raytrace.RenderParams)})
    out = []
    for i in range(frames):
        p, aux = model.step(p)
        buf = wl.push_frame(buf, p, H * (i + 1))
        img, diag = raytrace.render_retarded_with_diag(
            buf, p.object_index, objects, cam, W, HT, params, planar=True,
            boundary=wl.boundary_mask(p))
        out.append((p, aux, img, diag))
    return out


@pytest.fixture(scope="module")
def runs():
    jp, jo = _scene(jscene)
    jm = JModel(capacity=jp.capacity,
                spring_offsets=jforces.derive_spring_offsets(np.asarray(jp.neighbors)),
                use_pallas=True, pallas_interpret=True, tile=128)
    jbuf = jwl.prefill_inertial(jwl.create(64, jp.capacity), jp.pos, jp.vel, jp.active,
                                jnp.float32(0.0), jnp.float32(H))
    jcam = JCamera.create(pos=(0.37, 0.41), zoom=0.15)
    ref = []
    for i in range(FRAMES):
        jp, jaux = jm.step(jp)
        jbuf = jwl.push_frame(jbuf, jp, jnp.float32(H * (i + 1)))
        img, diag = jrt.render_retarded_with_diag(
            jbuf, jp.object_index, jo, jcam, W, HT, _jparams(), planar=True,
            boundary=jwl.boundary_mask(jp))
        ref.append((jp, jaux, np.asarray(img), diag))
    return ref, _run_port("cpu", FRAMES)


def test_slice_frames_match_jax(runs):
    ref, ours = runs
    v0 = None
    for (jp, jaux, jimg, jdiag), (p, aux, img, diag) in zip(ref, ours):
        act = np.asarray(jp.active)
        np.testing.assert_allclose(p.pos.numpy()[act], np.asarray(jp.pos)[act],
                                   rtol=0, atol=POS_ATOL)
        mismatch = np.mean(np.abs(img.numpy() - jimg).max(axis=0) > PIXEL_TOL)
        assert mismatch <= PIXEL_SHARE, f"{mismatch:.3%} pixels differ"
        assert int(diag.pairs_used) == int(jdiag.pairs_used) > 0
        assert int(aux.bonds_broken) == int(jaux.bonds_broken)
        if v0 is None:
            v0 = np.asarray(jp.vel)[act]
    # the frames run through the impact
    assert np.abs(np.asarray(ref[-1][0].vel)[act] - v0).max() > 0.1


def test_slice_counters_are_zero_and_image_is_lit(runs):
    _, ours = runs
    for p, aux, img, diag in ours:
        for name in DROP_COUNTERS:
            assert int(getattr(diag, name)) == 0, name
        assert int(aux.window_truncated) == 0 and int(aux.grid_overflow) == 0
        assert img.shape == (3, HT, W) and torch.isfinite(img).all()
        assert (img < 0.99).float().mean() > 0.05


def test_cpu_slice_launches_no_kernel(runs):
    """On CPU tensors the wrappers take the plain versions: nothing counts."""
    kernels.reset_launch_counts()
    _run_port("cpu", 1)
    assert kernels.launches == {"collision": 0, "collision_exclude": 0, "pixel_pass": 0,
                                "pixel_pass_camera_frame": 0, "band": 0, "points": 0}


def test_profile_ranges_reach_every_sub_stage():
    """profile_frame's named ranges wrap the sub-stages the frame really
    calls, and are taken off again after the block."""
    retina = raytrace._retina
    acts = [torch.profiler.ProfilerActivity.CPU]
    with profile_frame.named_ranges(), torch.profiler.profile(activities=acts) as prof:
        _run_port("cpu", 1)
    names = {e.name for e in prof.events()}
    for label in ("cell sort", "collision kernel", "springs", "bonded repulsion",
                  "cone sweep + pairs", "pair compaction", "splat CSR", "retina march",
                  "retina lookup", "pixel kernel"):
        assert label in names, label
    assert raytrace._retina is retina


def test_profile_attribution_of_a_trace():
    """Device ops go to the innermost host range open at their launch; the
    busy time is the union of the device intervals."""
    def x(cat, name, ts, dur, tid=1, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [
        x("user_annotation", "render", 0, 100),
        x("user_annotation", "retina march", 10, 20),
        x("cuda_runtime", "cudaLaunchKernel", 15, 1, corr=1),
        x("cuda_runtime", "cudaLaunchKernel", 40, 1, corr=2),
        x("cuda_runtime", "cudaMemsetAsync", 200, 1, corr=3),
        x("kernel", "vectorized_elementwise_kernel<4>", 1000, 3000, tid=7, corr=1),
        x("kernel", "pixel_kernel", 2000, 2000, tid=7, corr=2),
        x("gpu_memset", "Memset (Device)", 9000, 1000, tid=7, corr=3),
    ]
    res = profile_frame.attribute(events, frames=2)
    assert res["by_range"] == {"retina march": [1.5, 0.5], "render": [1.0, 0.5],
                               "(no range)": [0.5, 0.5]}
    assert res["by_kind"] == {"elementwise": [1.5, 0.5], "pixel kernel": [1.0, 0.5],
                              "memcpy / memset": [0.5, 0.5]}
    assert res["busy_ms"] == pytest.approx(2.0)


def test_compare_kernels_binds_another_tree():
    """load_other imports another tree's package under a name of its own:
    its modules, its launch counts and its kernel build directory (under
    that tree's build/) are its own, not this package's."""
    root = Path(__file__).resolve().parents[1]
    name = "other_test_spacetime_tpu_torch"
    try:
        other = compare_kernels.load_other(str(root), name)
        assert other.__name__ == name
        okern = importlib.import_module(name + ".kernels")
        ofc = importlib.import_module(name + ".ops.forces_cuda")
        assert okern is not kernels and okern.launches is not kernels.launches
        assert ofc.kernels is okern  # its wrappers count into its own table
        assert okern.BUILD_DIR == root / "build" / "spacetime_tpu_torch"
    finally:
        for mod in [m for m in sys.modules if m == name or m.startswith(name + ".")]:
            del sys.modules[mod]


def test_compare_kernels_collision_inputs():
    """The collision inputs chip_smoke.py and compare_kernels time: the
    cell order of the state, stage 0 at its positions with no
    displacement, stage 3 at pos + vel h with the per-axis displacement of
    the active particles."""
    p, _ = _scene(scene)
    model = SoftbodyModel(p.capacity, forces.derive_spring_offsets(p.neighbors.numpy()),
                          device="cpu")
    p, _ = model.step(p)
    order, stages = compare_kernels.collision_inputs(p, model)
    act = p.active
    assert order.cell_start[-1].item() == int(act.sum())
    pos0, still = stages[0]
    assert torch.equal(pos0, p.pos) and torch.equal(still, torch.zeros(2))
    moved, disp = stages[3]
    torch.testing.assert_close(moved, p.pos + p.vel * model.params.h, rtol=0, atol=0)
    assert torch.equal(disp, (moved - p.pos)[act].abs().amax(dim=0))
    assert (disp > 0).all()


def test_compare_kernels_checks_catch_a_difference():
    """collision_error raises past rtol 1e-4, atol 1e-3 on active rows only;
    band_unequal names every field that is not exactly equal."""
    p, _ = _scene(scene)
    ref = torch.from_numpy(np.random.default_rng(0).normal(size=(p.capacity, 2))
                         .astype(np.float32))
    off = ref.clone()
    off[~p.active] += 1.0
    assert compare_kernels.collision_error(off, ref, p.active) == 0.0
    off[torch.nonzero(p.active)[0, 0]] += 2e-3
    with pytest.raises(AssertionError):
        compare_kernels.collision_error(off, ref, p.active)
    buf = wl.prefill_inertial(wl.create(64, p.capacity), p.pos, p.vel, p.active, 0.0, H)
    cam = Camera.create(pos=(0.37, 0.41), zoom=0.15)
    params = raytrace.RenderParams(**{f.name: getattr(_jparams(), f.name)
                                      for f in dataclasses.fields(raytrace.RenderParams)})
    plain = band_cuda.cone_band_window_plain(buf, params, cam)
    assert compare_kernels.band_unequal(plain, plain) == []
    bent = plain._replace(wx=plain.wx + 1e-7, ages=plain.ages + 1)
    assert compare_kernels.band_unequal(bent, plain) == ["wx", "ages"]


def test_compare_kernels_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert compare_kernels.main([]) == 1

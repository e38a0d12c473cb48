"""Parity of the port's worldline ring (spacetime_tpu_torch.ops.worldline)
with the JAX reference, on the cases of tests/test_worldline.py.  The ring
only copies values, so every comparison is exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetime_tpu import scene as jscene
from spacetime_tpu.ops import worldline as jwl
from spacetime_tpu.state import pack_particles as jpack
from spacetime_tpu_torch import convert, scene
from spacetime_tpu_torch.ops import worldline as wl
from spacetime_tpu_torch.state import pack_particles

H = 0.005


def _fields(x):
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x) if getattr(x, f.name) is not None}


def _one(pack, x, **build):
    return pack(
        pos=np.array([[x, 0.0]], np.float32),
        vel=np.array([[0.1, 0.0]], np.float32),
        neighbors=np.full((1, 8), -1, np.int32),
        object_index=np.zeros(1, np.int32),
        capacity=8,
        **build,
    )


def _assert_same(buf, jbuf):
    for name in ("pos_x", "pos_y", "vel_x", "vel_y", "times"):
        np.testing.assert_array_equal(getattr(buf, name).numpy(),
                                      np.asarray(getattr(jbuf, name)), err_msg=name)
    assert buf.cursor == int(jbuf.cursor)
    assert buf.frames_in_use == int(jbuf.frames_in_use)


@pytest.mark.parametrize("pushes", [1, 4, 6])
def test_push_matches_jax(pushes):
    """Ramp-up (1), exactly full (4) and wrapped (6) rings of capacity 4."""
    buf, jbuf = wl.create(4, 8, device="cpu"), jwl.create(4, 8)
    for i in range(pushes):
        jbuf = jwl.push_frame(jbuf, _one(jpack, float(i)), time=i * H)
        out = wl.push_frame(buf, _one(pack_particles, float(i), device="cpu"), time=i * H)
        assert out is buf  # updated in place
    _assert_same(buf, jbuf)
    np.testing.assert_array_equal(buf.pos_x[:4].numpy(), buf.pos_x[4:].numpy())  # mirror
    assert np.isfinite(buf.times.numpy()).sum() == min(pushes, 4)
    assert np.all(buf.pos_x[buf.cursor, 1:].numpy() >= 1e8)  # inactive parked


def test_slot_and_pos_at_age_match_jax():
    buf, jbuf = wl.create(4, 8, device="cpu"), jwl.create(4, 8)
    for i in range(6):
        jbuf = jwl.push_frame(jbuf, _one(jpack, float(i)), time=i * H)
        wl.push_frame(buf, _one(pack_particles, float(i), device="cpu"), time=i * H)
    ages = [buf.pos_x[wl.slot_of_age(buf, a), 0].item() for a in range(4)]
    assert ages == [5.0, 4.0, 3.0, 2.0]
    for a in range(4):
        assert wl.slot_of_age(buf, a) == int(jwl.slot_of_age(jbuf, a))
        np.testing.assert_array_equal(wl.pos_at_age(buf, a).numpy(),
                                      np.asarray(jwl.pos_at_age(jbuf, a)))


def test_prefill_and_push_match_jax():
    sb = jscene.SceneBuilder()
    sb.add(jscene.disc_softbody(4, 0, (0.3, 0.4), (0.2, -0.1), lattice_pad=True))
    jp, _ = sb.build()
    tp = convert.particles_from_numpy(_fields(jp))
    jbuf = jwl.prefill_inertial(jwl.create(16, jp.capacity), jp.pos, jp.vel, jp.active,
                                jnp.float32(0.0), jnp.float32(H))
    buf = wl.prefill_inertial(wl.create(16, tp.capacity, device="cpu"), tp.pos, tp.vel,
                              tp.active, 0.0, H)
    _assert_same(buf, jbuf)
    moved = dataclasses.replace(jp, pos=jp.pos + jp.vel * H)
    jbuf = jwl.push_frame(jbuf, moved, H)
    wl.push_frame(buf, convert.particles_from_numpy(_fields(moved)), H)
    _assert_same(buf, jbuf)
    # the ring converted from the JAX pytree is the same ring
    _assert_same(convert.worldline_from_numpy(_fields(jbuf)), jbuf)


def test_boundary_mask_matches_jax():
    sb = scene.SceneBuilder()
    sb.add(scene.disc_softbody(5, 0, (0.0, 0.0), (0.0, 0.0)))
    tp, _ = sb.build(capacity=256, device="cpu")
    jsb = jscene.SceneBuilder()
    jsb.add(jscene.disc_softbody(5, 0, (0.0, 0.0), (0.0, 0.0)))
    jp, _ = jsb.build(capacity=256)
    mask = wl.boundary_mask(tp).numpy()
    np.testing.assert_array_equal(mask, np.asarray(jwl.boundary_mask(jp)))
    assert 0 < mask.sum() < tp.active.sum().item() * 0.75


def test_push_time_from_device_tensor():
    """push_frame takes the tick time as a 0-d tensor too (no host sync)."""
    buf = wl.create(4, 8, device="cpu")
    wl.push_frame(buf, _one(pack_particles, 1.0, device="cpu"), torch.tensor(0.25))
    assert buf.times[buf.cursor].item() == 0.25


def test_cursor_and_in_use_are_device_tensors_matching_jax():
    """`cursor` and `frames_in_use` are () int32 tensors on the ring's
    device, advanced in place by each push (the same tensors throughout, as
    a captured graph needs), equal to JAX's after every push: ramp-up,
    exactly full, wrapped once and twice; the newest time and the rows at
    each age read through them match JAX's."""
    buf, jbuf = wl.create(4, 8, device="cpu"), jwl.create(4, 8)
    cursor, in_use = buf.cursor, buf.frames_in_use
    assert cursor.dtype == in_use.dtype == torch.int32 and cursor.shape == in_use.shape == ()
    for i in range(10):
        jbuf = jwl.push_frame(jbuf, _one(jpack, float(i)), time=i * H)
        wl.push_frame(buf, _one(pack_particles, float(i), device="cpu"), time=torch.tensor(i * H))
        assert buf.cursor is cursor and buf.frames_in_use is in_use
        assert int(cursor) == int(jbuf.cursor) and int(in_use) == int(jbuf.frames_in_use)
        assert wl.newest_time(buf).item() == float(jbuf.times[jbuf.cursor])
        for age in range(min(i + 1, 4)):
            np.testing.assert_array_equal(wl.row_at_age(buf.pos_x, buf, age).numpy(),
                                          np.asarray(jwl.pos_at_age(jbuf, age))[:, 0])
    _assert_same(buf, jbuf)
    converted = convert.worldline_from_numpy(_fields(jbuf))
    assert converted.cursor.dtype == torch.int32 and converted.cursor.shape == ()

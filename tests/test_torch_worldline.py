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


def _one(pack, x):
    return pack(
        pos=np.array([[x, 0.0]], np.float32),
        vel=np.array([[0.1, 0.0]], np.float32),
        neighbors=np.full((1, 8), -1, np.int32),
        object_index=np.zeros(1, np.int32),
        capacity=8,
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
    buf, jbuf = wl.create(4, 8), jwl.create(4, 8)
    for i in range(pushes):
        jbuf = jwl.push_frame(jbuf, _one(jpack, float(i)), time=i * H)
        out = wl.push_frame(buf, _one(pack_particles, float(i)), time=i * H)
        assert out is buf  # updated in place
    _assert_same(buf, jbuf)
    np.testing.assert_array_equal(buf.pos_x[:4].numpy(), buf.pos_x[4:].numpy())  # mirror
    assert np.isfinite(buf.times.numpy()).sum() == min(pushes, 4)
    assert np.all(buf.pos_x[buf.cursor, 1:].numpy() >= 1e8)  # inactive parked


def test_slot_and_pos_at_age_match_jax():
    buf, jbuf = wl.create(4, 8), jwl.create(4, 8)
    for i in range(6):
        jbuf = jwl.push_frame(jbuf, _one(jpack, float(i)), time=i * H)
        wl.push_frame(buf, _one(pack_particles, float(i)), time=i * H)
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
    buf = wl.prefill_inertial(wl.create(16, tp.capacity), tp.pos, tp.vel, tp.active, 0.0, H)
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
    tp, _ = sb.build(capacity=256)
    jsb = jscene.SceneBuilder()
    jsb.add(jscene.disc_softbody(5, 0, (0.0, 0.0), (0.0, 0.0)))
    jp, _ = jsb.build(capacity=256)
    mask = wl.boundary_mask(tp).numpy()
    np.testing.assert_array_equal(mask, np.asarray(jwl.boundary_mask(jp)))
    assert 0 < mask.sum() < tp.active.sum().item() * 0.75


def test_push_time_from_device_tensor():
    """push_frame takes the tick time as a 0-d tensor too (no host sync)."""
    buf = wl.create(4, 8)
    wl.push_frame(buf, _one(pack_particles, 1.0), torch.tensor(0.25))
    assert buf.times[buf.cursor].item() == 0.25

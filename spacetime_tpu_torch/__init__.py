"""spacetime_tpu_torch — the PyTorch/CUDA port of `spacetime_tpu`.

It covers the relativistic softbody step (RK4 or Euler; lattice-padded or
row-gather bonds, materials with plastic creep), aloof bodies on prescribed
trajectories, the mirrored worldline ring, the flat retarded (with rank
compaction and the 2x2 splat), boosted (camera-frame), instantaneous,
point and retina renders and multi-view, the conical mode (static, moving
and matter-sourced defects), the worldline3d view, and the Engine with its
CLI.  Module names mirror the JAX package so each
counterpart is easy to find; the JAX package stays the reference that the
tests hold this one against.

Conventions:
  * plain functions on tensors, dataclasses of tensors for state, and a
    `device` argument wherever state is created.  The entry points (Engine,
    SoftbodyModel, engine.build_scene, the CLI) run on cuda:0 when none is
    named and raise without CUDA (device.py); only an explicit "cpu" runs on
    the CPU;
  * each hand-written CUDA kernel (`csrc/`) sits beside a plain-torch version
    of the same function.  A wrapper takes the plain version only for CPU
    tensors; for CUDA tensors it launches the kernel or raises;
  * nothing on the ported path draws random numbers or needs a gradient, so
    there is no `torch.Generator` and no `autograd.Function` here.

The package imports torch and numpy only — never jax.
"""

from . import constants, relativity, scene, state
from .constants import DEFAULT_PARAMS, PhysicsParams
from .state import Objects, Particles

__version__ = "0.1.0"

"""spacetime_tpu_torch — the PyTorch/CUDA port of `spacetime_tpu`.

It covers the headline frame: one relativistic RK4 softbody step, one push
into the mirrored worldline ring, and one flat retarded-time render.  Module
names mirror the JAX package so each counterpart is easy to find; the JAX
package stays the reference that the tests hold this one against.

Conventions:
  * plain functions on tensors, dataclasses of tensors for state, and an
    explicit `device` argument wherever state is created (no hidden `.cuda()`);
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

"""Multi-GPU execution on torch.distributed: the counterpart of
`spacetime_tpu/parallel/`.

The layout is the JAX package's (its parallel/sharding.py): every (N, ...)
particle array is split into equal blocks on the particle axis, one per
rank in rank order; the worldline ring's (2T, N) planes are split on the
same blocks (dim 1), so a push writes each rank's columns with no
collective; the ring's `times`, `cursor` and `frames_in_use` are
replicated; the image is split on view-cell rows.  A capacity the world
size does not divide is padded with inactive particles
(`mesh.pad_to_multiple`).

GSPMD inserts JAX's collectives; here each one is written out (`comm`):
  * the step: one all-gather of positions and velocities at its first
    stage and of positions at each later stage, so every rank builds the
    same cell order and reads its bonds' partners; one reduce-scatter of
    the collision forces per stage (each rank runs the kernel over its
    range of sorted rows); one all-reduce of the step's counters;
  * the render: the cone band search runs on each rank's ring columns,
    then one all-gather of the pair rows (never of a ring plane) and one
    all-reduce of the band counters; the splat and the retina run
    replicated; each rank shades its band of cell rows, and one all-gather
    assembles the image;
  * the point view: each rank's winner pass over its block, one MIN
    all-reduce of the winner planes, then the resolve pass.

`mesh` builds the Mesh value (process group, rank, world size, device),
`multihost` joins the processes from torchrun's environment, `sharding`
holds the layout, the state's scatter and gather, and the raw API
`make_sharded_step` / `make_sharded_frame`; `Engine(config, mesh=...)`
runs its frame on the same layout.  `comm` and `mesh` import nothing of
the rest of the package, so the ops modules can use them.
"""

from . import comm, mesh

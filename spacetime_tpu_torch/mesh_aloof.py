"""The aloof flagship on N GPUs: `mesh_run` with an aloof disc.

    torchrun --nproc-per-node 4 -m spacetime_tpu_torch.mesh_aloof --frames 200 --check
    torchrun --nproc-per-node 2 -m spacetime_tpu_torch.mesh_aloof --config single_blob \\
        --frames 3 --width 64 --height 64 --cpu --check

Every rank runs `Engine(config, mesh=..., aloof_bodies=[disc])` with the
disc of chip_smoke.py's aloof phases (`disc_template(20)` on
`circular_trajectory((0.7, 0.5), 0.15, 0.3)`, object 2), fused; rank 0
prints mesh_run's JSON line (stats, collectives of one frame and, with
--check, bit-equality of the last image and the gathered state to a
single-device aloof Engine's).  The flags are mesh_run's.
"""

from __future__ import annotations

import sys

from . import mesh_run
from .models.aloofbody import AloofBody, circular_trajectory, disc_template


def main(argv=None) -> int:
    body = AloofBody(disc_template(20), circular_trajectory((0.7, 0.5), 0.15, 0.3),
                     object_index=2)
    return mesh_run.main(argv, aloof_bodies=[body])


if __name__ == "__main__":
    sys.exit(main())

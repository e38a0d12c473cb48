"""The traffic of a cell: the viewer's pan script over the episode, drawn
from the seed.

A traffic file holds:
  * `mode`: the Engine's render mode (`retarded` or `points`);
  * `pan`: `keys` (the pan keys, in opposite pairs), `hold_frames` (the
    lengths a key is held) and `idle_share` (the least share of the
    episode's frames with no key held).

The scene and its episode are the configuration's, the same for every seed.

Every seed gets the same holds: each key is held once for each length of
`hold_frames` that fits (the longest prefix of the list whose holds,
over every key, leave `idle_share` of the episode idle), so opposite keys
cancel and the camera ends the episode where it began.  The seed draws
only their order and the idle gaps between them.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """A generator for one purpose (`stream`) of a seed; any whole number."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def holds(pan: dict, frames: int) -> List[int]:
    """The hold lengths each key gets in an episode of `frames` frames."""
    keys = len(pan["keys"])
    budget = frames * (1.0 - float(pan["idle_share"]))
    out = []
    for h in pan["hold_frames"]:
        if keys * (sum(out) + h) > budget:
            break
        out.append(int(h))
    return out


def pan_script(pan: dict, frames: int, seed: int) -> List[Dict[str, bool]]:
    """One keys dict a frame for an episode of `frames` frames."""
    r = rng(seed, 2)
    segments = [(k, h) for k in pan["keys"] for h in holds(pan, frames)]
    order = r.permutation(len(segments))
    held = sum(h for _, h in segments)
    idle = frames - held
    # the idle frames cut into len(segments) + 1 gaps at seeded points
    cuts = np.sort(r.integers(0, idle + 1, size=len(segments)))
    gaps = np.diff(np.concatenate([[0], cuts, [idle]]))
    script: List[Dict[str, bool]] = []
    for gap, s in zip(gaps, order):
        script += [{}] * int(gap)
        key, h = segments[s]
        script += [{key: True}] * h
    script += [{}] * int(gaps[-1])
    return script

"""Simulation checkpoint/resume (counterpart of
`spacetime_tpu/utils/checkpoint.py`): the Engine's state dataclasses —
particles, worldline ring, camera — and a JSON meta record in one .npz.

Arrays are stored by name (`<part>.<field>`); fields that are None are
left out, so an optional field such as `Particles.rest_len` (the per-bond
rest lengths of plastic creep) is saved when the state has it and expected
back exactly when the resuming state has it — the JAX package's rule,
whose pytree has a `rest_len` leaf only when the field is set.  The ring's
cursor and in-use count are 0-d tensors, stored as 0-d arrays (checkpoints
written while they were host ints hold 0-d int64 arrays of the same
names and load the same way).  `load` validates the names and shapes
against the current state before it returns anything, and puts each
tensor on the device and dtype of its counterpart there.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

FORMAT_VERSION = 1


def save(path: str, state: Mapping[str, Any], meta: Dict | None = None) -> None:
    """Write the dataclasses of `state` (name -> dataclass) and `meta`."""
    payload = {}
    for part, obj in state.items():
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if v is not None:
                payload[f"{part}.{f.name}"] = (
                    v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
    meta = dict(meta or {})
    meta["__version__"] = FORMAT_VERSION
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load(path: str, like: Mapping[str, Any]) -> Tuple[Dict[str, Any], Dict]:
    """Restore what `save` wrote; `like` (name -> dataclass) gives the parts,
    fields, shapes, dtypes and devices.  Raises ValueError on a version,
    field or shape mismatch (e.g. a checkpoint of another capacity or
    history) before building any state."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode() or "{}")
        version = meta.pop("__version__", None)
        if version != FORMAT_VERSION:
            raise ValueError(f"checkpoint {path!r} has format version {version}, "
                             f"this build reads version {FORMAT_VERSION}")
        out = {}
        for part, obj in like.items():
            fields = {}
            for f in dataclasses.fields(obj):
                key, cur = f"{part}.{f.name}", getattr(obj, f.name)
                if (cur is None) != (key not in data.files):
                    raise ValueError(f"checkpoint {path!r}: {key} is "
                                     f"{'missing' if cur is not None else 'unexpected'} "
                                     "— different engine config?")
                if cur is None:
                    fields[f.name] = None
                elif isinstance(cur, torch.Tensor):
                    arr = data[key]
                    if tuple(arr.shape) != tuple(cur.shape):
                        raise ValueError(
                            f"checkpoint {path!r}: {key} has shape {tuple(arr.shape)} but the "
                            f"engine expects {tuple(cur.shape)} — capacity or history differs "
                            "from the saved run")
                    fields[f.name] = torch.from_numpy(arr).to(device=cur.device, dtype=cur.dtype)
                else:
                    fields[f.name] = type(cur)(data[key])
            out[part] = dataclasses.replace(obj, **fields)
    return out, meta

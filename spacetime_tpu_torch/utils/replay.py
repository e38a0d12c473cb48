"""Deterministic record/replay of interactive sessions (counterpart of
`spacetime_tpu/utils/replay.py`, with its JSONL protocol).

A frame is a function of (state, camera, time, inputs), so logging each
frame's INPUTS (its key dict and the live hotswap settings) is enough to
reproduce a session bit-exactly on the same device and code.  The log is
JSONL: a header line with a config fingerprint (and `meta`), then one
event per frame, with `hotswap` only where it changed.  Logs of the two
packages read the same way.

Usage:
    rec = ReplayRecorder(path, config=engine.config); engine.recorder = rec
    ... interactive run (served keys, or scripted run_frame(keys=...)) ...
    rec.close()

    engine2 = Engine(same_config)
    replay(engine2, path)        # re-drives run_frame with the recorded inputs
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional


def config_fingerprint(config) -> str:
    """Stable fingerprint of the EngineConfig (dataclass repr is
    deterministic for the plain-data fields used here)."""
    return repr(dataclasses.asdict(config)) if dataclasses.is_dataclass(config) else repr(config)


class ReplayRecorder:
    """Appends one JSONL event per frame; the Engine calls `record` at the
    top of run_frame, before the inputs apply."""

    def __init__(self, path: str, config=None, meta: Optional[Dict] = None):
        self.path = path
        self._f = open(path, "w")
        self._last_hotswap: Optional[Dict] = None
        header = {"kind": "header", "version": 1}
        if config is not None:
            header["config"] = config_fingerprint(config)
        if meta:
            header["meta"] = dict(meta)  # e.g. named-config key for replay
        self._f.write(json.dumps(header) + "\n")

    def record(self, frame: int, keys: Optional[Dict], hotswap: Dict) -> None:
        ev: Dict = {"frame": frame}
        if keys:
            ev["keys"] = {k: bool(v) for k, v in keys.items() if v}
        if hotswap != self._last_hotswap:  # log hotswap only on change
            ev["hotswap"] = dict(hotswap)
            self._last_hotswap = dict(hotswap)
        self._f.write(json.dumps(ev) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_full(path: str) -> tuple[Dict, List[Dict]]:
    """Returns (header dict, [frame events])."""
    header: Dict = {}
    events: List[Dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            ev = json.loads(line)
            if ev.get("kind") == "header":
                header = ev
            else:
                events.append(ev)
    return header, events


def load(path: str) -> tuple[Optional[str], List[Dict]]:
    """Returns (config_fingerprint | None, [frame events])."""
    header, events = load_full(path)
    return header.get("config"), events


def replay(engine, path: str, on_frame=None, strict: bool = True):
    """Re-drive `engine` with the recorded inputs.  With `strict`, a config
    fingerprint mismatch raises (replaying under a different config is
    almost certainly not what you want)."""
    fp, events = load(path)
    if strict and fp is not None:
        now = config_fingerprint(engine.config)
        if now != fp:
            raise ValueError(
                "replay config fingerprint mismatch — the log was recorded "
                "under a different EngineConfig"
            )
    return replay_events(engine, events, on_frame=on_frame)


def replay_events(engine, events, on_frame=None):
    """Apply pre-loaded frame events to `engine` — the single place the
    recorded-input protocol (hotswap updates, per-frame keys) is interpreted;
    `bench --replay` and replay() both drive through here."""
    img = None
    for ev in events:
        if "hotswap" in ev:
            engine.hotswap.update(ev["hotswap"])
        img = engine.run_frame(keys=ev.get("keys"))
        if on_frame is not None:
            on_frame(ev["frame"], img)
    return img

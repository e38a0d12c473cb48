"""Build and load the C++ frame and stream sinks of `native/`.

`native/framesink.cpp` (PNG writer threads, zlib) and
`native/streamsink.cpp` (MJPEG-over-HTTP server, libjpeg) are compiled by
`g++` into `build/spacetime_tpu_torch/` (beside the CUDA kernels'
library), named by a hash of the source and flags, so a source edit
rebuilds; nothing is written into `native/`.  A build happens at the
first sink that asks for it, never at import.  Where it fails (no g++, no
zlib or libjpeg headers, no `native/` beside the package), `load` returns
None and `build_errors` says why: the sinks then take their Python paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional, Sequence

from ..kernels import BUILD_DIR

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")

_loaded: Dict[str, Optional[ctypes.CDLL]] = {}
build_errors: Dict[str, str] = {}  # source -> why its build or load failed


def _build(source: str, libs: Sequence[str]) -> Path:
    src = NATIVE_DIR / source
    if not src.is_file():
        raise RuntimeError(f"{src} not found")
    flags = (*CXX_FLAGS, *libs)
    h = hashlib.sha256(" ".join(flags).encode() + src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{src.stem}_{h}.so"
    if out.is_file():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build in a temporary directory, then rename: a concurrent loader
    # never sees a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = f"{tmp}/lib.so"
        cmd = [cxx, *CXX_FLAGS, "-o", lib, str(src), *libs, "-lpthread"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}): "
                               f"{proc.stderr.strip()[-400:]}")
        os.replace(lib, out)
    return out


def load(source: str, libs: Sequence[str]) -> Optional[ctypes.CDLL]:
    """The loaded library of `native/<source>` linked with `libs`, built on
    first use; None (with the reason in `build_errors`) if it cannot be
    built or loaded."""
    if source not in _loaded:
        try:
            _loaded[source] = ctypes.CDLL(str(_build(source, libs)))
        except (RuntimeError, OSError) as exc:
            build_errors[source] = str(exc)
            _loaded[source] = None
    return _loaded[source]

"""Build, load and count the hand-written CUDA kernels of `csrc/`.

The sources are compiled by `nvcc`, one process per source, all started
together, and linked into one shared library with a plain C interface,
loaded with ctypes — never at import, only at the first call that needs a
kernel.  The library lands in `build/spacetime_tpu_torch/` beside the
package, named by a hash of the sources and flags, so a source change
rebuilds it.

`-fmad=false` keeps nvcc from contracting a*b + c into one fused multiply-
add: the kernels then round every operation as the plain-torch versions do,
so kernel-vs-plain checks on the card compare like with like.

`launches` counts kernel launches by name.  Each wrapper adds one where it
launches its kernel and nowhere else; `reset_launch_counts` zeroes them.
A kernel's variants count apart: `collision` (bonded pairs included) and
`collision_exclude`, `pixel_pass` and `pixel_pass_camera_frame`.  A CUDA
graph capture (fused.py) runs the wrappers but launches nothing: the counts
it makes are taken back out (`held_apart`) and added once per replay of the
graph (`add_launches`), so the counts stay those of kernels that ran.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("collision.cu", "pixel_pass.cu", "band.cu", "points.cu")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "spacetime_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC",
)

launches = {"collision": 0, "collision_exclude": 0, "pixel_pass": 0,
            "pixel_pass_camera_frame": 0, "band": 0, "points": 0}

_lib = None
build_seconds = None  # wall time of this process's build, None if cached


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


@contextlib.contextmanager
def held_apart():
    """The launch counts made inside the block are taken back out of
    `launches` at its end and left in the dict it yields."""
    before = dict(launches)
    held = {}
    try:
        yield held
    finally:
        for name in launches:
            held[name] = launches[name] - before[name]
            launches[name] = before[name]


def add_launches(counts) -> None:
    """Add `counts` (name -> launches) to `launches`."""
    for name, n in counts.items():
        launches[name] += n


def find_nvcc() -> str:
    """nvcc on PATH, else under CUDA_HOME / CUDA_PATH, else the toolkit's
    default install prefix.  Raises if none exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "CUDA tensors need the spacetime_tpu_torch kernels, but nvcc was not "
        "found on PATH, under CUDA_HOME or CUDA_PATH, or in /usr/local/cuda"
    )


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless a library for these sources exists: one
    `nvcc -c` per source in parallel, then one link."""
    global build_seconds
    out = BUILD_DIR / f"libspacetime_kernels_{_source_hash()}.so"
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # build in a temporary directory, then rename: a concurrent loader
    # never sees a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for name in SOURCES:
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", f"{tmp}/{name}.o", str(CSRC / name)]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.PIPE, text=True)))
        # wait for every compiler before reporting the first failure
        results = [(cmd, proc, *proc.communicate()) for cmd, proc in jobs]
        for cmd, proc, _, err in results:
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
        lib = f"{tmp}/lib.so"
        cmd = [nvcc, "-shared", "-o", lib, *(f"{tmp}/{name}.o" for name in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stderr}")
        os.replace(lib, out)
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use, with argtypes set."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.collision_forces_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, cf, cf, cf, cf, vp, vp,
    ]
    lib.collision_forces_launch.restype = ci
    lib.collision_forces_exclude_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, cf, cf, cf, cf, vp, vp, vp,
    ]
    lib.collision_forces_exclude_launch.restype = ci
    lib.pixel_pass_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp]
    lib.pixel_pass_launch.restype = ci
    lib.band_window_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, cf, cf, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
    ]
    lib.band_window_launch.restype = ci
    lib.points_launch.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, vp, vp, vp, vp]
    lib.points_launch.restype = ci
    lib.points_winner_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp, vp]
    lib.points_winner_launch.restype = ci
    lib.points_resolve_dense_launch.argtypes = [vp, vp, vp, ci, ci, vp, vp]
    lib.points_resolve_dense_launch.restype = ci
    _lib = lib
    return lib


def check(status: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch function."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {status}")

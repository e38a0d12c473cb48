"""Asynchronous PNG frame recorder (counterpart of
`spacetime_tpu/utils/framesink.py`, with its API and file names).

The native path binds `native/framesink.cpp` (a bounded queue and worker
threads that zlib-compress and write PNGs off the simulation thread)
through ctypes, built by utils/native.py.  Where that build fails, frames
are written by utils/png.py's writer on a worker thread of this module
(zlib releases the interpreter lock while it compresses); `native` says
which path a sink took.  Files are `frame_%08d.png` in `directory`.
"""

from __future__ import annotations

import ctypes
import os
import queue
import threading
import time

import numpy as np
import torch

from . import native, png


def _load():
    lib = native.load("framesink.cpp", ("-lz",))
    if lib is not None:
        lib.fs_create.restype = ctypes.c_void_p
        lib.fs_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int]
        lib.fs_submit.restype = ctypes.c_int
        lib.fs_submit.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p]
        lib.fs_pending.restype = ctypes.c_long
        lib.fs_pending.argtypes = [ctypes.c_void_p]
        lib.fs_close.restype = None
        lib.fs_close.argtypes = [ctypes.c_void_p]
    return lib


def quantize(frame) -> np.ndarray:
    """uint8 of a float [0, 1] or uint8 frame, clipped, scaled by 255 in f32
    and truncated as the JAX sinks do.  A tensor is quantized on its own
    device, so a quarter of the float frame's bytes come to the host."""
    if isinstance(frame, torch.Tensor):
        if frame.dtype != torch.uint8:
            frame = (frame.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        return frame.cpu().numpy()
    arr = np.asarray(frame)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)
    return arr


def to_u8(frame, width: int, height: int) -> np.ndarray:
    """quantize(frame), checked to be (height, width, 3) and contiguous."""
    arr = quantize(frame)
    if arr.shape != (height, width, 3):
        raise ValueError(f"frame of shape {arr.shape}, sink expects {(height, width, 3)}")
    return np.ascontiguousarray(arr)


class FrameSink:
    """Async PNG recorder: submit (H, W, 3) float [0, 1] or uint8 frames;
    encoding and writing happen on worker threads (native, or Python)."""

    def __init__(self, directory: str, width: int, height: int,
                 workers: int = 2, queue_capacity: int = 8):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.width, self.height = width, height
        self._lib = _load()
        self._handle = None
        self._queue = self._thread = None
        self._error = None  # the first exception of the Python writer thread
        if self._lib is not None:
            self._handle = self._lib.fs_create(directory.encode(), width, height, workers,
                                               queue_capacity)
        if self._handle is None:
            self._queue = queue.Queue(maxsize=queue_capacity)
            self._thread = threading.Thread(target=self._write_loop, daemon=True,
                                            name="framesink")
            self._thread.start()

    @property
    def native(self) -> bool:
        return self._handle is not None

    def _path(self, frame_index: int) -> str:
        return os.path.join(self.directory, f"frame_{frame_index:08d}.png")

    def _write_loop(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                if self._error is None:
                    png.write_png(self._path(item[0]), item[1])
            except OSError as exc:
                self._error = exc
            finally:
                self._queue.task_done()

    def submit(self, frame_index: int, frame) -> None:
        arr = to_u8(frame, self.width, self.height)
        if self._handle is not None:  # fs_submit copies the frame out of `arr`
            while self._lib.fs_submit(self._handle, frame_index, arr.ctypes.data) != 0:
                time.sleep(0.002)  # queue full: gentle backpressure
            return
        if self._error is not None:
            raise self._error
        self._queue.put((frame_index, arr.copy()))  # blocks while the queue is full

    def pending(self) -> int:
        if self._handle is not None:
            return int(self._lib.fs_pending(self._handle))
        return self._queue.unfinished_tasks if self._queue is not None else 0

    def close(self) -> None:
        """Drain the queue, then stop the workers."""
        if self._handle is not None:
            self._lib.fs_close(self._handle)
            self._handle = None
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join()
            self._thread = None
            if self._error is not None:
                raise self._error

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

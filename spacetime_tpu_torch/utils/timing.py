"""Device time of a call on a CUDA card, with the host out of the reading.

`cuda_ms(fn)` times `reps` calls of `fn` with CUDA events.  A wrapper's
host cost per call (argument checks, allocations, the ctypes call) can
exceed a small kernel's device time, and then events recorded around
calls that the device runs as fast as the host enqueues them measure the
host.  So the device is first held in a spin (`torch.cuda._sleep`) long
enough to cover the host's enqueue of all the calls, and the events and
the calls are enqueued behind it: when the spin ends every call is
already queued, and the events bracket device execution only — each
call's device work and the device's own gap between back-to-back
launches, which `launch_floor_ms` reads alone.  The spin lasts twice the
host time of a first, untimed pass of the same calls, plus 1 ms.  A `fn`
that synchronizes with the host inside (a `.item()`, a host read) cannot
be kept out this way; its reading includes the host.

Calls repeated on the same inputs find them in the card's 50 MB L2.
`cold=True` reads a kernel as a caller that finds its inputs in device
memory does: before each call the device reads a buffer of twice the L2
size (a read, so the evicting lines are clean and cost the call no write
back), and each call has its own pair of events, so the eviction stays
out of the reading.
"""

from __future__ import annotations

import time

import torch

MAX_SPIN_MS = 2000.0  # longest spin before the timed calls
EVICT_BYTES = 2 * 50 * 2**20  # twice an H100's L2

_cycles_per_ms = None


def cycles_per_ms() -> float:
    """Clock cycles of `torch.cuda._sleep` per ms on the current card,
    measured once with CUDA events."""
    global _cycles_per_ms
    if _cycles_per_ms is None:
        cycles = 20_000_000
        torch.cuda._sleep(1000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        _cycles_per_ms = cycles / start.elapsed_time(end)
    return _cycles_per_ms


def cuda_ms(fn, reps: int = 20, warmup: int = 3, cold: bool = False) -> float:
    """Mean device time of fn() over `reps` runs, from CUDA events that
    bracket device execution only (see the module docstring); with `cold`,
    each run starts with the L2 evicted."""
    evict = torch.zeros(EVICT_BYTES // 4, dtype=torch.float32, device="cuda") if cold else None
    run = (lambda: (evict.sum(), fn())) if cold else fn
    for _ in range(warmup):
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = min(2.0 * enqueue_ms + 1.0, MAX_SPIN_MS)
    event = lambda: torch.cuda.Event(enable_timing=True)
    marks = [(event(), event()) for _ in range(reps if cold else 1)]
    torch.cuda._sleep(int(cycles_per_ms() * spin_ms))
    if cold:
        for start, end in marks:
            evict.sum()
            start.record()
            fn()
            end.record()
    else:
        marks[0][0].record()
        for _ in range(reps):
            fn()
        marks[0][1].record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in marks) / reps


def launch_floor_ms(reps: int = 100) -> float:
    """The card's launch floor: the device time of a trivial kernel
    (`torch.cuda._sleep(0)`) launched back to back, timed as cuda_ms times
    a kernel."""
    return cuda_ms(lambda: torch.cuda._sleep(0), reps=reps)

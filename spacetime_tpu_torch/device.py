"""Where the port's entry points run: CUDA device 0 unless the caller names
a device.  There is no silent CPU fallback: without CUDA the default
raises, and only an explicit `device="cpu"` (`--cpu` on the CLI) runs the
plain-torch versions of the kernels."""

from __future__ import annotations

import subprocess

import torch

NO_CUDA = ("no CUDA device: spacetime_tpu_torch runs on an NVIDIA GPU "
           "(pass device=\"cpu\", or --cpu on the CLI, for the CPU path)")


def resolve(device=None) -> torch.device:
    """`device` as a torch.device; None means cuda:0, and raises
    RuntimeError when CUDA is absent."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(NO_CUDA)
    return torch.device("cuda", 0)


def card_line() -> str:
    """The first card's name and power limit, as `nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader` prints them (a card may be set
    below its full power, and then runs slower under load)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

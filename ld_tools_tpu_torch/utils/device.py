"""Which device the port runs on.

``cuda`` is the default everywhere; the CPU runs only when asked for by
name, and then through the plain PyTorch versions of the kernels.  When
``cuda`` is asked for and no card is present this raises: nothing
carries on quietly on the CPU.
"""

from __future__ import annotations

import contextlib

import torch

# the tools' -E choice -> torch device: the card, or the plain PyTorch
# versions on the CPU
ENGINE_DEVICES = {"cuda": "cuda", "torch": "cpu"}


def engine_device(engine) -> str:
    """The device of a tool's ``-E`` choice (``cuda`` or ``torch``)."""
    if engine not in ENGINE_DEVICES:
        raise ValueError(f"engine must be one of {sorted(ENGINE_DEVICES)}, "
                         f"got {engine!r}")
    return ENGINE_DEVICES[engine]


def resolve_device(device="cuda") -> torch.device:
    """The torch.device for ``device`` ("cuda", "cuda:N" or "cpu")."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA card is available; "
                "ask for the CPU explicitly (device='cpu', or -E torch on "
                "the command line) to run the plain PyTorch versions"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")


def device_guard(dev: torch.device):
    """A context that makes ``dev`` the current CUDA device (nothing for
    the CPU): work for a second card must not run on the first."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())

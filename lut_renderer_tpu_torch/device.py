"""Explicit device choice for the port.

The JAX package picks its platform from ``jax.devices()`` and falls back to
the CPU gather path when no TPU is visible. The port never falls back: a
caller names the device, ``"cuda"`` without a card raises, and ``"cpu"``
exists for the tests, where every kernel wrapper runs its plain version.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(spec: DeviceLike = "cuda") -> torch.device:
    """``"cuda"``, ``"cuda:N"`` or ``"cpu"`` -> a torch.device that exists."""
    dev = torch.device(spec)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(spec)!r} requested but torch sees no CUDA "
                f"device (torch {torch.__version__}); the port does not "
                f"fall back to the CPU")
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(spec)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible")
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {str(spec)!r} (cuda or cpu)")
    return dev

"""The port's device rule, in one place.

Entry points (``ServingEngine``, ``ServingCell``, ``main()``) take an
explicit ``device``. Left unset it means ``cuda``: a serving process on a
host without a GPU fails loudly instead of serving an 8B model on the CPU
at a thousandth of the speed. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


class NoGPUError(RuntimeError):
    """A CUDA device was required (explicitly or by default) but none exists."""


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raise :class:`NoGPUError` when the resolved
    device is CUDA and ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoGPUError(
            f"device {str(dev)!r} requested"
            + (" (the default)" if device is None else "")
            + " but torch.cuda.is_available() is false; pass device='cpu' "
            "to run the port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: cuda or cpu")
    return dev

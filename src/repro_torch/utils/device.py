"""Device selection for the port's entry points.

Every public entry point takes ``device=None``, which means the card
(``"cuda"``). With no card present such a call raises: the port never moves
to the CPU on its own. Tests and other CPU callers pass ``device="cpu"``
explicitly, and then every kernel wrapper runs its plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default, and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch versions of the kernels")
        if dev.index is None:   # "cuda" → the current card, as tensors name it
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (phase boundaries only)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)

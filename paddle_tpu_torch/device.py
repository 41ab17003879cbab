"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device without a card raises
    ``RuntimeError``: the port never drops to the CPU on its own — the
    caller asks for ``device="cpu"`` explicitly (the tests do)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available (torch.cuda.is_available() is "
            "False); pass device='cpu' to run the plain PyTorch path")
    return dev

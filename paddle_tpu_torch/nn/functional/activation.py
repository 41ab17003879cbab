"""Activation functionals (``paddle_tpu.nn.functional.activation``
counterparts): the subset the port's models use."""
from __future__ import annotations

import torch

__all__ = ["relu"]


def relu(x, name=None):
    return torch.relu(x)

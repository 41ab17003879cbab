"""Forward flop counts of a vision model's convolutions and linear
layers, from the shapes one forward gives."""
from __future__ import annotations

import torch

from ... import nn

__all__ = ["conv_flops"]


def conv_flops(model, height=224, width=224) -> float:
    """Forward flops of one 3-channel image through ``model``'s ``Conv2D``
    and ``Linear`` layers, at 2 a multiply-add, from the shapes one
    forward of a zero image gives (run in eval mode without gradients, so
    nothing updates; the model's mode is restored).  Batch norm,
    activations and pooling are not counted."""
    total = [0.0]

    def conv_hook(mod, inp, out):
        k = mod.weight.shape[1] * mod.weight.shape[2] * mod.weight.shape[3]
        total[0] += 2.0 * out[0].numel() * k

    def fc_hook(mod, inp, out):
        total[0] += 2.0 * mod.in_features * mod.out_features

    hooks = [m.register_forward_hook(conv_hook if isinstance(m, nn.Conv2D)
                                     else fc_hook)
             for m in model.modules() if isinstance(m, (nn.Conv2D, nn.Linear))]
    was_training = model.training
    p = next(model.parameters())
    try:
        model.eval()
        with torch.no_grad():
            model(torch.zeros(1, 3, height, width, dtype=p.dtype,
                              device=p.device))
    finally:
        model.train(was_training)
        for h in hooks:
            h.remove()
    return total[0]

"""paddle.summary — parity with python/paddle/hapi/model_summary.py: layer
table with output shapes and parameter counts via forward hooks (the
port's copy of ``paddle_tpu/hapi/summary.py``)."""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core import place as place_mod
from ..core.tensor import Tensor
from ..nn.layer_base import Layer


def summary(net: Layer, input_size=None, dtypes=None, input=None):
    rows = []
    hooks = []

    def register(layer, prefix):
        children = list(layer.named_children()) if \
            hasattr(layer, "named_children") else \
            list(layer._sub_layers.items())
        if not children:
            def hook(l, inputs, outputs, name=prefix, lay=layer):
                out = outputs[0] if isinstance(outputs, (list, tuple)) \
                    else outputs
                shape = list(out.shape) if hasattr(out, "shape") else None
                n_params = int(sum(np.prod(p.shape)
                                   for p in lay.parameters(include_sublayers=False))) \
                    if hasattr(lay, "parameters") else 0
                rows.append((name or type(lay).__name__,
                             type(lay).__name__, shape, n_params))
            hooks.append(layer.register_forward_post_hook(hook))
        for name, child in children:
            register(child, f"{prefix}.{name}" if prefix else name)

    register(net, "")

    if input is not None:
        x = input
    else:
        if input_size is None:
            raise ValueError("summary needs input_size or input")
        sizes = input_size if isinstance(input_size, list) else [input_size]
        xs = []
        for i, s in enumerate(sizes):
            dt = (dtypes[i] if isinstance(dtypes, (list, tuple)) else dtypes) \
                or "float32"
            xs.append(Tensor._wrap(torch.zeros(
                tuple(s), dtype=dtype_mod.convert_dtype(dt),
                device=place_mod.current_device())))
        x = xs if len(xs) > 1 else xs[0]

    was_training = net.training
    net.eval()
    try:
        net(*x) if isinstance(x, list) else net(x)
    finally:
        if was_training:
            net.train()
        for h in hooks:
            h.remove()

    total = int(sum(np.prod(p.shape) for p in net.parameters()))
    trainable = int(sum(np.prod(p.shape) for p in net.parameters()
                        if not p.stop_gradient))
    width = 76
    print("-" * width)
    print(f"{'Layer (type)':<36}{'Output Shape':<24}{'Param #':<12}")
    print("=" * width)
    for name, cls, shape, n in rows:
        print(f"{(name + ' (' + cls + ')')[:35]:<36}"
              f"{str(shape)[:23]:<24}{n:<12}")
    print("=" * width)
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total - trainable:,}")
    print("-" * width)
    return {"total_params": total, "trainable_params": trainable}

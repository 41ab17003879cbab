"""``auto_cast``: O1 / O2 mixed precision at the op boundary
(``paddle_tpu.amp.auto_cast`` counterpart).

A thread-local state, read by ``core.op.apply_op`` once a call: outside a
scope that read is the whole cost.  Inside one, :func:`should_cast` maps
the op's paddle name to ``"low"`` (float32 arguments become the scope's
dtype), ``"high"`` (bfloat16 / float16 arguments become float32) or
None, with the JAX package's white and black lists and custom lists.
The cast is a torch op on the argument, so autograd carries gradients
back to float32 leaves in float32.
"""
from __future__ import annotations

import contextlib
import threading

from ..core.dtype import convert_dtype

__all__ = ["auto_cast", "amp_guard", "decorate", "white_list", "black_list",
           "amp_state", "should_cast"]

# the JAX package's lists (paddle_tpu/amp/auto_cast.py)
white_list = {"matmul", "mm", "bmm", "mv", "conv1d", "conv2d", "conv3d",
              "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
              "linear", "einsum", "attention", "scaled_dot_product_attention",
              "resnet_stem_s2d", "sparse_conv3d", "sparse_fused_attention"}
black_list = {"exp", "square", "log", "mean", "sum", "cos_sim", "softmax",
              "log_softmax", "softmax_with_cross_entropy",
              "sigmoid_cross_entropy_with_logits", "cross_entropy",
              "fused_nll_loss", "layer_norm", "batch_norm", "reduce_sum",
              "pow"}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = convert_dtype("bfloat16")
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()


_state = _AmpState()


def amp_state() -> _AmpState:
    return _state


def should_cast(op_name: str) -> str | None:
    """``"low"``, ``"high"`` or None for ``op_name`` under the active
    scope (None outside one)."""
    if not _state.enabled:
        return None
    if op_name in _state.custom_black or op_name in black_list:
        return "high"
    if _state.level == "O2":
        return "low"
    if op_name in _state.custom_white or op_name in white_list:
        return "low"
    return None


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    prev = (_state.enabled, _state.dtype, _state.level, _state.custom_white,
            _state.custom_black)
    _state.enabled = bool(enable)
    _state.dtype = convert_dtype(dtype)
    _state.level = level
    _state.custom_white = set(custom_white_list or ())
    _state.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level, _state.custom_white,
         _state.custom_black) = prev


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2 casts each model's parameters to ``dtype`` (``Layer.to``); O1
    changes nothing.  Returns the models (and the optimizers) as given."""
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        for m in model_list:
            m.to(dtype=dtype)
    if optimizers is None:
        return models if single_model else model_list
    return (models if single_model else model_list), optimizers

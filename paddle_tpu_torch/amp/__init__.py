"""Automatic mixed precision (``paddle_tpu.amp`` counterpart).

O1: inside ``auto_cast()``, each paddle op decides its compute dtype by
name at the op boundary (``core.op.apply_op``): white-list ops (the
products, attention) take their float32 arguments in the low dtype,
black-list ops (reductions, norms, losses) take bfloat16 / float16
arguments in float32.  O2: every op not on the black list takes the low
dtype.  ``decorate(level="O2")`` casts the models.  ``GradScaler``
scales the loss with the JAX package's dynamic rules.
"""
from .auto_cast import (amp_guard, auto_cast, black_list,  # noqa: F401
                        decorate, white_list)
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401

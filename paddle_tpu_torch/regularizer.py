"""``paddle.regularizer`` (``paddle_tpu.regularizer`` counterpart):
``L1Decay`` and ``L2Decay``, the coefficient objects an optimizer takes as
``weight_decay``; what each does is in ``optimizer/optimizer.py``."""
from .optimizer.optimizer import L1Decay, L2Decay

__all__ = ["L1Decay", "L2Decay"]

"""Functionals of the port (``paddle_tpu.nn.functional`` counterparts).

Each takes bare ``torch.Tensor``s or the paddle surface's ``Tensor``s
(``core.op.defop``): torch tensors in, torch tensors out, with nothing
but an ``isinstance`` scan of the arguments (the models' path); surface
Tensors in, surface Tensors out, on their values.  The functions the JAX
package registers as ops are in ``core.op.OP_REGISTRY`` under the same
names (the random ``gumbel_softmax`` is not registered: its draws are not
the JAX package's)."""
from .activation import *  # noqa: F401,F403
from .activation import ACTIVATIONS  # noqa: F401
from .attention import (fused_ln_linear, fused_qkv_attention,  # noqa: F401
                        scaled_dot_product_attention)
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403

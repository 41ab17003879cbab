"""``paddle.nn`` of the port: ``Layer``, ``Parameter``, ``ParamAttr``,
the initializers, ``functional_call``, the clips, every layer of the JAX
package's ``nn/layer/`` (``common``, ``container``, ``activation``,
``norm``, ``loss``, ``transformer``, ``conv``, ``pooling``, ``rnn``,
``extra``) over ``nn.functional``, ``nn.utils``, channels-last
construction (``nn.layout``), abstract construction (``nn.meta``) and
``nn.quant`` (the quantization package's layer surface)."""
from . import clip, functional, initializer, layout, meta, utils  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_)
from .functional_call import (functional_call, module_fn,  # noqa: F401
                              state_values, trainable_mask)
from .layer import *  # noqa: F401,F403
from .layer import loss  # noqa: F401  (the reference exports nn.loss)
from .layer_base import (HookRemoveHelper, Layer,  # noqa: F401
                         Parameter, ParamAttr)
from .layout import channels_last, is_channels_last  # noqa: F401
from .meta import abstract_init, is_abstract_init  # noqa: F401
from .utils import spectral_norm  # noqa: F401
from . import quant  # noqa: F401,E402  (after the layers it wraps)

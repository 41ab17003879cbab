"""``paddle.nn`` of the port: ``Layer``, ``Parameter``, ``ParamAttr``,
the initializers, ``functional_call``, the clips, every layer of the JAX
package's ``nn/layer/{common,container,activation,norm,loss,transformer,
conv,pooling}.py`` and ``LSTM``, over ``nn.functional``.  The rest of
``rnn.py``, ``extra.py``, ``utils.py``, ``layout.py``, ``meta.py`` and
``quant.py`` is not ported yet (``ROADMAP.md``, module entry 7)."""
from . import clip, functional, initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_)
from .functional_call import (functional_call, module_fn,  # noqa: F401
                              state_values, trainable_mask)
from .layer import *  # noqa: F401,F403
from .layer import loss  # noqa: F401  (the reference exports nn.loss)
from .layer_base import (HookRemoveHelper, Layer,  # noqa: F401
                         Parameter, ParamAttr)

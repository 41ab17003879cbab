"""paddle.autograd parity surface (``paddle_tpu.autograd`` counterpart)."""
from ..core.autograd import (backward, enable_grad, grad,  # noqa: F401
                             is_grad_enabled, no_grad, saved_tensors_hooks,
                             set_grad_enabled)
from ..core.pylayer import PyLayer, PyLayerContext, PyLayerMeta  # noqa: F401

# legacy aliases (reference autograd/__init__.py exports both eager and
# legacy PyLayer names; one implementation serves all four here)
EagerPyLayer = PyLayer
LegacyPyLayer = PyLayer
EagerPyLayerContext = PyLayerContext
LegacyPyLayerContext = PyLayerContext


def no_grad_(func=None):
    """Decorator alias of no_grad (reference exports `no_grad_`)."""
    return no_grad()(func) if func is not None else no_grad()


def backward_mode():
    """'eager': one autograd engine (torch's)."""
    return "eager"

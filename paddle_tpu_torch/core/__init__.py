"""The core of the port's paddle surface (``paddle_tpu.core``
counterpart): dtypes, places, the RNG, ``Tensor``, autograd, the op
registry and ``PyLayer``."""
from . import autograd, dtype, place, random  # noqa: F401
from .autograd import (enable_grad, grad, is_grad_enabled, no_grad,  # noqa: F401
                       set_grad_enabled)
from .dtype import (bfloat16, bool_, complex64, complex128, float16,  # noqa: F401
                    float32, float64, get_default_dtype, int8, int16, int32,
                    int64, set_default_dtype, uint8)
from .place import (CPUPlace, CUDAPinnedPlace, CUDAPlace, Place,  # noqa: F401
                    TPUPlace,
                    device_count, get_device, is_compiled_with_cuda,
                    is_compiled_with_distribute, is_compiled_with_rocm,
                    is_compiled_with_tpu, is_compiled_with_xpu, set_device)
from .random import get_rng_state, seed, set_rng_state  # noqa: F401
from .tensor import Tensor, to_tensor  # noqa: F401

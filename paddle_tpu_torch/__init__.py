"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package (``paddle_tpu``) stays the reference; this package serves
and trains the same models on an NVIDIA H100, and every Pallas kernel on
a ported path is a CUDA C++ kernel written for Hopper
(``kernels/csrc``), built with ``nvcc`` at first use.

``import paddle_tpu_torch as paddle`` gives the paddle surface over
torch: ``Tensor`` and ``to_tensor``, the dtypes (``paddle.float32 is
torch.float32``), the places (``CPUPlace``, ``CUDAPlace``,
``CUDAPinnedPlace``, ``set_device``), ``seed``, ``grad``, ``no_grad``,
the ops of ``paddle.tensor`` (creation, math, manipulation, linalg,
logic, reduction, search, random, the long tail of ``extended`` and
``compat_surface``) at the top level and as ``Tensor`` methods,
``paddle.autograd`` (``PyLayer``, ``backward``), ``paddle.device``,
``paddle.nn`` and ``paddle.amp`` (``auto_cast`` decides each op's dtype
by its name at the op boundary; ``GradScaler``), and the training loop
around a model: ``paddle.io`` (``Dataset``, ``DataLoader`` with forked
workers over a shared-memory ring, ``DevicePrefetcher``),
``paddle.Model`` (hapi ``fit`` / ``evaluate`` / ``predict``),
``paddle.metric``, ``paddle.callbacks``, ``paddle.save`` /
``paddle.load``, ``paddle.framework`` (sharded checkpoints, preemption)
and ``paddle.summary``; ``paddle.profiler`` (over ``torch.profiler``),
the legacy readers (``paddle.batch``, ``paddle.reader``,
``paddle.dataset`` over ``vision.datasets`` and ``paddle.text``) and
``paddle.quantization`` (QAT / PTQ, simulated int8).  A ``Tensor`` wraps a ``torch.Tensor`` (``.value``);
autograd is torch's.  Without a card the default place raises: CPU
scripts call ``paddle.set_device("cpu")`` first.

The models, the serving engine and the trainers (``models``,
``vision.models``, ``serving``, ``distributed.make_train_step``) run on
bare ``torch.Tensor``s; ``nn.functional`` takes either (a Tensor in gives
a Tensor out), and its attention reaches the flash kernels from both.
Module names and the ``[B, T, H, D]`` attention layout follow the JAX
package, so each function has an obvious counterpart there.  Entry points
take ``device=`` and default to ``"cuda"``; without a card they raise
rather than fall back to the CPU (``device.resolve_device``).

This package never imports ``jax`` or ``paddle_tpu``; only the tests
import both, to hold the port against the reference.
"""
import torch as _torch

from .core import (CPUPlace, CUDAPinnedPlace, CUDAPlace, Place,  # noqa: F401
                   Tensor, bfloat16, bool_, complex64, complex128,
                   enable_grad, float16, float32, float64,
                   get_default_dtype, get_device, get_rng_state, grad, int8,
                   int16, int32, int64, is_compiled_with_cuda,
                   is_compiled_with_distribute, is_compiled_with_rocm,
                   is_compiled_with_tpu, is_compiled_with_xpu,
                   is_grad_enabled, no_grad, seed, set_default_dtype,
                   set_device, set_grad_enabled, set_rng_state, to_tensor,
                   uint8)
from .ops import *  # noqa: F401,F403,E402
from . import amp, autograd, device, tensor  # noqa: F401,E402
from . import (distributed, incubate, models, nn,  # noqa: F401,E402
               optimizer, regularizer, vision)
from . import framework, io, metric, observability, utils  # noqa: F401,E402
from . import callbacks, hapi  # noqa: F401,E402
from . import (dataset, profiler, quantization, reader,  # noqa: F401,E402
               text)
from .batch import batch  # noqa: F401,E402
from .device import resolve_device  # noqa: F401,E402
from .framework.io import load, save  # noqa: F401,E402
from .hapi import Model  # noqa: F401,E402
from .nn import ParamAttr  # noqa: F401,E402


def summary(net, input_size=None, dtypes=None):
    """paddle.summary: the layer table and parameter counts."""
    from .hapi.summary import summary as _summary
    return _summary(net, input_size, dtypes)


bool = bool_  # noqa: A001 — the reference exports `paddle.bool`
dtype = _torch.dtype
iinfo = _torch.iinfo
finfo = _torch.finfo

from .core.tensor_methods import install_tensor_methods as _itm  # noqa: E402

_itm()
del _itm

"""The process-wide settings the port's numeric-module tests may touch,
in both packages, read into one comparable value: ``jax_enable_x64``,
the channels-last switch and the autotune config, the prim switch, the
``passes`` flag, ``unique_name``'s generator and the ``ForkingPickler``
registrations.  A test file's autouse fixture compares the value before
and after each test, so a setting a test leaves behind fails that test
rather than a later file in the same worker."""
import copy
from multiprocessing.reduction import ForkingPickler

import jax

import paddle_tpu.incubate.autograd as jautograd
import paddle_tpu.incubate.autotune as jautotune
import paddle_tpu.incubate.passes as jpasses
import paddle_tpu.nn.layout as jlayout
import paddle_tpu.utils.unique_name as jnames
import paddle_tpu_torch.incubate.autograd as pautograd
import paddle_tpu_torch.incubate.autotune as pautotune
import paddle_tpu_torch.incubate.passes as ppasses
import paddle_tpu_torch.nn.layout as playout
import paddle_tpu_torch.utils.unique_name as pnames


def _layout(mod):
    return (mod._global_on, getattr(mod._state, "on", None),
            hasattr(mod._state, "on"))


def _names(mod):
    g = mod._generator
    return (id(g), dict(g.ids), g.prefix)


def snapshot():
    return dict(
        x64=jax.config.read("jax_enable_x64"),
        layout=[_layout(m) for m in (jlayout, playout)],
        autotune=[copy.deepcopy(m._config) for m in (jautotune, pautotune)],
        prim=[m.prim_enabled() for m in (jautograd, pautograd)],
        passes=[m.fuse_resnet_unit_requested() for m in (jpasses, ppasses)],
        unique_name=[_names(m) for m in (jnames, pnames)],
        pickler=dict(ForkingPickler._extra_reducers))

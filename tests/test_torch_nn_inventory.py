"""The names of ``paddle_tpu.nn`` and ``paddle_tpu.nn.functional`` against
the port's: every public name is in the port except the ones listed here,
each under the module that will bring it or with the reason it is not
ported.  The lists are exact: a name ported later must leave them (every
``nn`` module is ported: ``nn/quant.py`` came with the quantization
package)."""
import types

import pytest

import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as jF
import paddle_tpu_torch
import paddle_tpu_torch.nn as pnn
import paddle_tpu_torch.nn.functional as pF

# left for a later slice: none
NEXT_NN = {}
NEXT_F = {}
NOT_PORTED_F = {
    # helpers the JAX modules' imports leak into nn.functional
    "Tensor": "helper", "apply_op": "helper", "defop": "helper",
    "get_default_dtype": "helper", "rnd": "helper",
    "to_jax": "a jnp dtype",
    # the JAX flash routing toggle (a TPU tiling threshold): the port sends
    # every mask-free call to the kernel on the card
    "enable_flash_attention": "no TPU routing threshold",
}


def _public(mod):
    out = set()
    for n, v in vars(mod).items():
        if n.startswith("_") or n == "annotations":
            continue
        if isinstance(v, types.ModuleType):
            if v.__name__.startswith("paddle_tpu."):
                out.add(n)
            continue
        owner = getattr(v, "__module__", None)
        if (isinstance(v, type) or callable(v)) and owner is not None and \
                not owner.startswith("paddle_tpu"):
            continue
        out.add(n)
    return out


@pytest.mark.parametrize("jmod,pmod,listed", [
    (jnn, pnn, set().union(*NEXT_NN.values())),
    (jF, pF, set().union(set(), *NEXT_F.values()) | set(NOT_PORTED_F))],
    ids=["nn", "nn.functional"])
def test_missing_names_are_exactly_the_listed_ones(jmod, pmod, listed):
    missing = _public(jmod) - set(dir(pmod))
    assert missing == listed, (sorted(missing - listed),
                               sorted(listed - missing))


def test_top_level_param_attr_and_the_layer_surface():
    assert paddle_tpu_torch.ParamAttr is pnn.ParamAttr
    for name in ("Layer", "Parameter", "ParamAttr", "initializer",
                 "functional_call", "module_fn", "state_values"):
        assert hasattr(pnn, name), name
    assert issubclass(pnn.Linear, pnn.Layer)
    assert issubclass(pnn.Parameter, paddle_tpu_torch.Tensor)

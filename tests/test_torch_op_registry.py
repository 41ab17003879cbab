"""The port's op registry and names against the JAX package's.

* ``paddle_tpu_torch``'s ``OP_REGISTRY`` is a subset of ``paddle_tpu``'s,
  name for name.
* Every public name of each JAX module this slice ports exists in the
  port's counterpart, except the listed ones, each with its reason.
* The ``paddle_tpu.core`` / ``core.op`` / ``core.autograd`` rows of
  ``tests/test_api_inventory.py`` hold for ``paddle_tpu_torch``.
* Every op of the ten ``ops`` modules (``extended`` and
  ``compat_surface`` among them) is at the port's top level and in
  ``paddle.tensor``, and every public Tensor method of the JAX package is
  on the port's Tensor.
"""
import importlib
import types

import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.core.op import OP_REGISTRY as JAX_OPS
from paddle_tpu_torch.core.op import OP_REGISTRY as PORT_OPS

# every module of the JAX package's ops/ is ported (ROADMAP module entry
# 6); core/selected_rows.py and device/tpu.py wait, and name nothing here
DEFERRED = set()

# names the port does not have, by reason
NOT_PORTED = {
    # there is no TPU in the port
    "TPUPlace": "no TPU",
    # JAX objects: the port's places resolve to torch devices
    # (Place.torch_device) and its dtypes are torch dtypes
    "default_jax_device": "a jax.Device", "to_jax": "a jnp dtype",
    # JAX's functional keys for jit; the port draws from per-device
    # torch.Generators (core.random.generator)
    "next_key": "jax keys", "push_key": "jax keys",
    # the JAX tape's node; the port's tape is torch autograd
    "GradNode": "jax tape",
    # helpers the JAX package's star imports leak into ops/ and tensor/
    "Tensor": "helper", "apply_op": "helper", "defop": "helper",
    "register_tensor_method": "helper", "get_default_dtype": "helper",
}

MODULES = ["core", "core.dtype", "core.place", "core.random", "core.tensor",
           "core.autograd", "core.op", "core.pylayer", "core.tensor_methods",
           "ops", "ops.creation", "ops.math", "ops.manipulation",
           "ops.linalg", "ops.logic", "ops.reduction", "ops.search",
           "ops.random_ops", "ops.extended", "ops.compat_surface", "tensor",
           "autograd", "device", "device.cuda"]
OPS_MODULES = ["creation", "math", "manipulation", "linalg", "logic",
               "reduction", "search", "random_ops", "extended",
               "compat_surface"]


def _public(mod):
    """A module's public names: what it defines or re-exports from the
    package, not modules or third-party objects it imports."""
    out = set()
    for n, v in vars(mod).items():
        if n.startswith("_") or n == "annotations" or \
                isinstance(v, types.ModuleType):
            continue
        owner = getattr(v, "__module__", None)
        if (isinstance(v, type) or callable(v)) and owner is not None and \
                not owner.startswith("paddle_tpu"):
            continue
        out.add(n)
    return out


def test_registry_is_a_subset_of_the_jax_registry():
    assert set(PORT_OPS) <= set(JAX_OPS), sorted(set(PORT_OPS) - set(JAX_OPS))
    # every op of the ported modules is registered under the JAX name
    for name, op in JAX_OPS.items():
        if op.raw.__module__.startswith("paddle_tpu.ops.") and \
                op.raw.__module__.rsplit(".", 1)[1] in OPS_MODULES:
            assert name in PORT_OPS, name


@pytest.mark.parametrize("module", MODULES)
def test_every_name_of_the_ported_module_exists(module):
    jmod = importlib.import_module(f"paddle_tpu.{module}")
    tmod = importlib.import_module(f"paddle_tpu_torch.{module}")
    missing = _public(jmod) - set(dir(tmod)) - set(NOT_PORTED) - DEFERRED
    assert not missing, sorted(missing)


@pytest.mark.parametrize("module, names", [
    ("core", ["Tensor", "to_tensor"]),
    ("core.op", ["OP_REGISTRY", "apply_op", "defop"]),
    ("core.autograd", ["backward", "grad", "no_grad"]),
])
def test_api_inventory_rows_hold(module, names):
    mod = importlib.import_module(f"paddle_tpu_torch.{module}")
    assert all(hasattr(mod, n) for n in names)


def test_every_op_is_at_the_top_level_and_in_paddle_tensor():
    for m in OPS_MODULES:
        names = importlib.import_module(f"paddle_tpu_torch.ops.{m}").__all__
        for n in names:
            assert hasattr(paddle_tpu_torch, n), (m, n)
            assert hasattr(paddle_tpu_torch.tensor, n), (m, n)
    for n in ("Tensor", "to_tensor", "float32", "bfloat16", "bool_", "bool",
              "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "set_device",
              "seed", "grad", "no_grad"):
        assert hasattr(paddle_tpu_torch, n), n
    assert paddle_tpu_torch.float32 is __import__("torch").float32
    assert paddle_tpu_torch.autograd.PyLayer is not None
    assert paddle_tpu_torch.device.cuda.memory_allocated is not None


def test_tensor_methods_of_the_ported_modules():
    missing = {n for n in dir(paddle_tpu.Tensor)
               if not n.startswith("_") and not hasattr(paddle_tpu_torch.Tensor,
                                                       n)}
    assert missing <= DEFERRED, sorted(missing - DEFERRED)

"""The port's MobileNet v1 to v3 (hardswish, hardsigmoid and
squeeze-excite in v3) against the JAX package's, on the CPU: the checks
of ``tests/_torch_zoo.py``, described in ``test_torch_vision_models.py``
(the state dict's names and shapes, the eval logits in f32 at 1e-4, two
Momentum steps' losses in f64 at 1e-4 against the JAX eager tape)."""
import pytest

pytest.importorskip("jax")

from _torch_zoo import (  # noqa: F401,E402
    check_eval_logits, check_two_momentum_steps, fast_jax_compiles)
from _torch_cpu_place import cpu_place  # noqa: F401,E402


@pytest.mark.parametrize("name", ["mobilenet_v1", "mobilenet_v2",
                                  "mobilenet_v3_small",
                                  "mobilenet_v3_large"])
def test_eval_logits_match_jax(name, fast_jax_compiles):
    check_eval_logits(name)


@pytest.mark.parametrize("name", ["mobilenet_v1", "mobilenet_v2",
                                  "mobilenet_v3_large"])
def test_two_momentum_steps_match_jax(name, fast_jax_compiles):
    check_two_momentum_steps(name)

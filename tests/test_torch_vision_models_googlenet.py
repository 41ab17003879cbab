"""The port's GoogLeNet against the JAX package's, on the CPU, at
224^2 (its auxiliary heads' ``Linear(1152, ...)`` fixes the size): the
checks of ``tests/_torch_zoo.py``, described in
``test_torch_vision_models.py`` (the state dict's names and shapes, the
main logits in f32 at 1e-4 in eval mode, two Momentum steps' losses in
f64 at 1e-4 against the JAX eager tape, the main loss plus 0.3 of each
auxiliary's)."""
import pytest

pytest.importorskip("jax")

from _torch_zoo import (  # noqa: F401,E402
    check_eval_logits, check_two_momentum_steps, fast_jax_compiles)
from _torch_cpu_place import cpu_place  # noqa: F401,E402


@pytest.mark.parametrize("name", ["googlenet"])
def test_eval_logits_match_jax(name, fast_jax_compiles):
    check_eval_logits(name)


@pytest.mark.parametrize("name", ["googlenet"])
def test_two_momentum_steps_match_jax(name, fast_jax_compiles):
    check_two_momentum_steps(name)

"""The port's InceptionV3 against the JAX package's, on the CPU: the
checks of ``tests/_torch_zoo.py``, described in
``test_torch_vision_models.py`` (the state dict's names and shapes, the
eval logits in f32 at 1e-4, two Momentum steps' losses in f64 at 1e-4
against the JAX eager tape), at 128^2.  At the JAX test's 96^2 the last
blocks see 1 x 1 maps, and batch norm over the batch's 2 values a
channel amplifies even f64 rounding about 100-fold a block: the two
packages' f64 forwards differ by 2e-7 there, by 2e-11 at 128^2."""
import pytest

pytest.importorskip("jax")

from _torch_zoo import (  # noqa: F401,E402
    check_eval_logits, check_two_momentum_steps, fast_jax_compiles)
from _torch_cpu_place import cpu_place  # noqa: F401,E402


@pytest.mark.parametrize("name", ["inception_v3"])
def test_eval_logits_match_jax(name, fast_jax_compiles):
    check_eval_logits(name)


@pytest.mark.parametrize("name", ["inception_v3"])
def test_two_momentum_steps_match_jax(name, fast_jax_compiles):
    check_two_momentum_steps(name)

"""The port's DenseNet against the JAX package's, on the CPU: the checks
of ``tests/_torch_zoo.py``, described in ``test_torch_vision_models.py``
(the state dict's names and shapes, the eval logits in f32 at 1e-4, two
Momentum steps' losses in f64 at 1e-4 against the JAX eager tape).

DenseNet-121's eval logits, and two steps of a DenseNet with two layers
a dense block (the same layers, blocks and transitions; a ``_cfg`` entry
added to both packages' class for the test): at 121 layers the JAX
side's op-by-op backward alone takes ~3 minutes of CPU."""
import pytest

pytest.importorskip("jax")

from paddle_tpu.vision.models import densenet as jdensenet  # noqa: E402

from paddle_tpu_torch.vision.models import densenet as pdensenet  # noqa: E402
from _torch_zoo import (  # noqa: F401,E402
    CASES, check_eval_logits, check_two_momentum_steps, fast_jax_compiles)
from _torch_cpu_place import cpu_place  # noqa: F401,E402

TINY = 10        # (init features, growth, layers a block)
TINY_CFG = (16, 8, [2, 2, 2, 2])


@pytest.fixture
def tiny_densenet(monkeypatch):
    for cls in (jdensenet.DenseNet, pdensenet.DenseNet):
        monkeypatch.setitem(cls._cfg, TINY, TINY_CFG)
    monkeypatch.setitem(CASES, "densenet-tiny",
                        ("DenseNet", {"layers": TINY}, 64, 3))


@pytest.mark.parametrize("name", ["densenet121"])
def test_eval_logits_match_jax(name, fast_jax_compiles):
    check_eval_logits(name)


@pytest.mark.parametrize("name", ["densenet-tiny"])
def test_two_momentum_steps_match_jax(name, fast_jax_compiles,
                                      tiny_densenet):
    check_two_momentum_steps(name)

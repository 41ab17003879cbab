"""The port's classification zoo against the JAX package's, on the CPU:
LeNet, AlexNet, VGG, SqueezeNet and ShuffleNetV2 here; the MobileNets,
DenseNet, GoogLeNet and InceptionV3 in ``test_torch_vision_models_*.py``
(the same checks, from ``tests/_torch_zoo.py``, split so that each file
stays short).

Each family at a small width or input (the JAX tests' 64^2, LeNet's
28^2, AlexNet's smallest), batch 2, f32, 10 classes; the JAX model's
weights are carried over with ``load_jax_state``:

* the state dict's names and shapes are the JAX model's;
* the logits in eval mode (running statistics) at 1e-4 (rtol, with an
  absolute floor of 1e-4 of the largest logit);
* two Momentum steps (lr 0.05, momentum 0.9, L2 1e-4) through the port's
  ``make_train_step`` against the JAX package's eager tape
  (``loss.backward()``, ``Momentum.step()``; its compiled step gives
  models with batch norm other gradients, ROADMAP section 3 item 2):
  both losses at 1e-4, in f64 on both sides (``jax_enable_x64`` for
  the test, restored after).  In f32 the second loss of these
  random-weight nets in training mode is chaotic: batch norm over the
  few values a channel of the last stages amplifies rounding, so that
  the port's own f32 run lands up to 9% from its f64 run (InceptionV3 at
  96^2, batch 2) and 6% from itself on another thread count, and the
  JAX package's f32 second losses lay 0.2-2% from the port's
  (MobileNet v1 and v2, ShuffleNetV2 x0.25 at lr 0.05).  Dropout is set
  to 0 on both sides (the two packages draw their masks from different
  generators).

A family's variants that share all their code with one trained here are
held in eval only (VGG without batch norm, SqueezeNet 1.0, ShuffleNet's
swish, MobileNetV3 small).  The JAX side runs op by op with XLA's
optimisation passes off for the module (restored after), the same ops in
the same arithmetic.  The factories' defaults (1000 classes,
``with_pool=True``) and ``pretrained=True``'s refusal are pinned on the
port side."""
import pytest
import torch

pytest.importorskip("jax")

from paddle_tpu_torch.vision import models as pmodels
from _torch_zoo import (  # noqa: F401,E402
    check_eval_logits, check_two_momentum_steps, fast_jax_compiles)
from _torch_cpu_place import cpu_place  # noqa: F401,E402


@pytest.mark.parametrize("name", ["lenet", "alexnet", "vgg11", "vgg11-bn",
                                  "squeezenet1_0", "squeezenet1_1",
                                  "shufflenet_v2_x0_25",
                                  "shufflenet_v2_swish"])
def test_eval_logits_match_jax(name, fast_jax_compiles):
    check_eval_logits(name)


@pytest.mark.parametrize("name", ["lenet", "alexnet", "vgg11-bn",
                                  "squeezenet1_1", "shufflenet_v2_x0_25"])
def test_two_momentum_steps_match_jax(name, fast_jax_compiles):
    check_two_momentum_steps(name)


def test_factory_defaults_and_pretrained():
    """The JAX defaults: 1000 classes and a pool; ``pretrained=True``
    raises; ``VGG`` and ``SqueezeNet`` keep their layouts."""
    m = pmodels.mobilenet_v2(device="cpu")
    assert m.num_classes == 1000 and m.with_pool
    assert m.classifier[1].weight.shape == [1280, 1000]
    assert pmodels.LeNet(device="cpu").num_classes == 10
    for f in (pmodels.alexnet, pmodels.vgg16, pmodels.squeezenet1_1,
              pmodels.mobilenet_v1, pmodels.mobilenet_v3_large,
              pmodels.shufflenet_v2_x1_0, pmodels.densenet121,
              pmodels.googlenet, pmodels.inception_v3):
        with pytest.raises(ValueError, match="pretrained"):
            f(pretrained=True, device="cpu")
    with pytest.raises(ValueError, match="version"):
        pmodels.SqueezeNet("2.0", device="cpu")
    v = pmodels.vgg13(batch_norm=True, num_classes=0, with_pool=False,
                      device="cpu")
    out = v(torch.zeros(1, 3, 32, 32))
    assert tuple(out.shape) == (1, 512, 1, 1)


@pytest.mark.parametrize("fname,count", [
    ("mobilenet_v1", 4231976), ("mobilenet_v2", 3504872),
    ("mobilenet_v3_small", 2542856), ("mobilenet_v3_large", 5483032),
    ("shufflenet_v2_x1_0", 2278604), ("squeezenet1_1", 1235496),
    ("alexnet", 61100840)])
def test_default_parameter_counts_match_jax(fname, count):
    """At the factories' defaults the port holds the JAX model's
    parameters (counted here from the JAX model's state once)."""
    pm = getattr(pmodels, fname)(device="cpu")
    assert sum(p.numel() for p in torch.nn.Module.parameters(pm)) == count

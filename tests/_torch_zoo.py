"""What the zoo's parity files (``test_torch_vision_models*.py``) share:
the cases, a JAX model and its port with the JAX weights, the eval-logits
check (f32, 1e-4) and the two-Momentum-steps check (f64 on both sides,
1e-4); ``test_torch_vision_models.py``'s docstring says why."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as jpaddle
from paddle_tpu.vision import models as jmodels

import paddle_tpu_torch.nn as pnn
from paddle_tpu_torch.distributed import make_train_step
from paddle_tpu_torch.models import load_jax_state
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision import models as pmodels

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fast_jax_compiles():
    """XLA's optimisation passes off for a module (restored after): the
    JAX side runs op by op and compiling each op dominates."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


# name: (factory name, kwargs, input size, channels)
CASES = {
    "lenet": ("LeNet", {}, 28, 1),
    "alexnet": ("alexnet", {}, 64, 3),
    "vgg11": ("vgg11", {}, 32, 3),
    "vgg11-bn": ("vgg11", {"batch_norm": True}, 32, 3),
    "squeezenet1_0": ("squeezenet1_0", {}, 64, 3),
    "squeezenet1_1": ("squeezenet1_1", {}, 64, 3),
    "mobilenet_v1": ("mobilenet_v1", {"scale": 0.25}, 64, 3),
    "mobilenet_v2": ("mobilenet_v2", {"scale": 0.5}, 64, 3),
    "mobilenet_v3_small": ("mobilenet_v3_small", {"scale": 0.5}, 64, 3),
    "mobilenet_v3_large": ("mobilenet_v3_large", {"scale": 0.5}, 64, 3),
    "shufflenet_v2_x0_25": ("shufflenet_v2_x0_25", {}, 64, 3),
    "shufflenet_v2_swish": ("shufflenet_v2_swish", {}, 64, 3),
    "densenet121": ("densenet121", {}, 64, 3),
    "googlenet": ("googlenet", {}, 224, 3),
    "inception_v3": ("inception_v3", {}, 128, 3),
}


def _state(jm):
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


def _no_dropout(*models):
    for m in models:
        for sub in m.sublayers() if hasattr(m, "sublayers") else m.modules():
            if type(sub).__name__ == "Dropout":
                sub.p = 0.0


def pair(name, seed=0):
    fname, kw, size, ch = CASES[name]
    kw = dict(kw, num_classes=10)
    jpaddle.seed(seed)
    jm = getattr(jmodels, fname)(**kw)
    pm = getattr(pmodels, fname)(**kw, device="cpu")
    want = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in
           torch.nn.Module.state_dict(pm).items()}
    assert got == want
    load_jax_state(pm, _state(jm))
    x = np.random.RandomState(seed).randn(2, ch, size, size).astype(
        np.float32)
    y = np.array([3, 7], np.int64)
    return jm, pm, x, y


def _logits(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()),
                               err_msg=err_msg)


def check_eval_logits(name):
    jm, pm, x, _ = pair(name)
    jm.eval()
    pm.eval()
    want = _logits(jm(jpaddle.to_tensor(x)))
    with torch.no_grad():
        got = _logits(pm(torch.from_numpy(x)))
    assert tuple(got.shape) == (2, 10)
    _close(got.numpy(), want.numpy())


def _aux_loss(ce, out, y):
    """GoogLeNet's recipe: the main loss plus 0.3 of each auxiliary."""
    if isinstance(out, (tuple, list)):
        return ce(out[0], y) + 0.3 * (ce(out[1], y) + ce(out[2], y))
    return ce(out, y)


def check_two_momentum_steps(name):
    jm, pm, x, y = pair(name, seed=1)
    _no_dropout(jm, pm)
    x = x.astype(np.float64)
    jax.config.update("jax_enable_x64", True)
    try:
        jm.to(dtype="float64")
        jopt = jpaddle.optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                                          parameters=jm.parameters(),
                                          weight_decay=1e-4)
        jce = jpaddle.nn.CrossEntropyLoss()
        want = []
        for _ in range(2):
            loss = _aux_loss(jce, jm(jpaddle.to_tensor(x)),
                             jpaddle.to_tensor(y))
            loss.backward()
            jopt.step()
            jopt.clear_grad()
            want.append(float(loss.numpy()))
    finally:
        jax.config.update("jax_enable_x64", False)
    pm.double()
    pce = pnn.CrossEntropyLoss()
    step = make_train_step(pm, Momentum(0.05, momentum=0.9, parameters=pm,
                                        weight_decay=1e-4),
                           loss_fn=lambda out, lab: _aux_loss(pce, out, lab))
    got = [float(step(x, y)) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[1] != got[0]

"""Channels-last construction (``nn.layout``) and abstract construction
(``nn.meta``) of the port, against the JAX package, on the CPU.

* The counterpart of ``tests/test_nn.py``'s
  ``test_channels_last_layer_sweep``: every pool, norm, conv and common
  image layer built inside ``channels_last()`` takes the channel-last
  layout (the JAX layer's resolved ``data_format``), those whose
  signatures carry no ``data_format`` (the 1-D pools, the adaptive max
  pools) included; on channel-last inputs it gives the channel-first
  layer's outputs, transposed, to 1e-5 (and the JAX layer's, with the
  same weights).  The scope is per thread, restores exactly, and yields
  to the process default.
* The counterpart of ``tests/test_flat_optimizer.py``'s
  ``test_abstract_mode_plans_the_same_tree``: a model built inside
  ``abstract_init()`` has the concrete model's parameter tree (names,
  shapes, dtypes), every parameter on the ``meta`` device (also under an
  active ``with torch.device(...)`` block), no initializer drew from the
  generator, and AdamW plans the same slots for it.
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.nn import layout
from _torch_cpu_place import cpu_place  # noqa: F401


@pytest.fixture(autouse=True)
def layout_reset():
    """No channels-last scope or process default leaks out of a test."""
    yield
    layout.set_global_channels_last(False)
    if hasattr(layout._state, "on"):
        del layout._state.on


RS = np.random.RandomState(0)
X4 = RS.randn(2, 4, 8, 8).astype(np.float32)
X3 = RS.randn(2, 4, 12).astype(np.float32)
B4 = [("MaxPool2D", lambda nn: nn.MaxPool2D(2)),
      ("AvgPool2D", lambda nn: nn.AvgPool2D(2)),
      ("AdaptiveAvgPool2D", lambda nn: nn.AdaptiveAvgPool2D(2)),
      ("AdaptiveMaxPool2D", lambda nn: nn.AdaptiveMaxPool2D(2)),
      ("BatchNorm2D", lambda nn: nn.BatchNorm2D(4)),
      ("GroupNorm", lambda nn: nn.GroupNorm(2, 4)),
      ("Conv2D", lambda nn: nn.Conv2D(4, 6, 3, padding=1)),
      ("PixelShuffle", lambda nn: nn.PixelShuffle(2)),
      ("Upsample", lambda nn: nn.Upsample(scale_factor=2, mode="nearest")),
      ("Pad2D", lambda nn: nn.Pad2D([1, 0, 2, 1]))]
B3 = [("MaxPool1D", lambda nn: nn.MaxPool1D(2)),
      ("AvgPool1D", lambda nn: nn.AvgPool1D(2)),
      ("AdaptiveAvgPool1D", lambda nn: nn.AdaptiveAvgPool1D(3)),
      ("AdaptiveMaxPool1D", lambda nn: nn.AdaptiveMaxPool1D(3)),
      ("BatchNorm1D", lambda nn: nn.BatchNorm1D(4)),
      ("Conv1D", lambda nn: nn.Conv1D(4, 6, 3, padding=1))]
CASES = [(n, b, X4, (0, 2, 3, 1), (0, 3, 1, 2)) for n, b in B4] + \
        [(n, b, X3, (0, 2, 1), (0, 2, 1)) for n, b in B3]


def _format(layer):
    for attr in ("_data_format", "data_format"):
        if hasattr(layer, attr):
            return getattr(layer, attr)
    return getattr(layer, "_kw", {}).get("data_format")


@pytest.mark.parametrize("name,build,x,perm_in,perm_out", CASES,
                         ids=[c[0] for c in CASES])
def test_channels_last_layer_sweep(name, build, x, perm_in, perm_out):
    jp.seed(0)
    jref = build(jp.nn)
    with jp.nn.channels_last():
        jcl = build(jp.nn)
    ref = build(tp.nn)
    with tp.nn.channels_last():
        assert tp.nn.is_channels_last()
        cl = build(tp.nn)
    assert not tp.nn.is_channels_last()
    assert _format(cl) == _format(jcl) != _format(ref) == _format(jref)
    state = {k: v.numpy() for k, v in jref.state_dict().items()}
    for layer in (jcl, ref, cl):
        layer.set_state_dict(state)
    for layer in (jref, jcl, ref, cl):
        layer.eval()
    xc = np.ascontiguousarray(x.transpose(perm_in))
    want = jref(jp.to_tensor(x)).numpy()
    got_ref = ref(tp.to_tensor(x)).numpy()
    got_cl = cl(tp.to_tensor(xc)).numpy().transpose(perm_out)
    want_cl = jcl(jp.to_tensor(xc)).numpy().transpose(perm_out)
    for got in (got_ref, got_cl, want_cl):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_scope_is_per_thread_and_restores_exactly():
    seen = {}
    with tp.nn.channels_last():
        t = threading.Thread(
            target=lambda: seen.setdefault("other", tp.nn.is_channels_last()))
        t.start()
        t.join()
        with tp.nn.channels_last(False):
            assert tp.nn.Conv2D(2, 2, 1)._data_format == "NCHW"
        assert tp.nn.MaxPool2D(2)._kw["data_format"] == "NHWC"
    assert seen["other"] is False
    layout.set_global_channels_last(True)
    assert tp.nn.is_channels_last()
    assert layout.resolve_data_format("NCDHW") == "NDHWC"
    assert layout.resolve_data_format("NHWC") == "NHWC"
    with tp.nn.channels_last(False):
        assert not tp.nn.is_channels_last()
    assert tp.nn.is_channels_last()      # the default shows again


def _tree(model):
    return {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in model.named_parameters()}


def _mlp(nn):
    return nn.Sequential(nn.Linear(16, 32), nn.LayerNorm(32),
                         nn.Linear(32, 4), nn.LSTM(4, 3),
                         nn.Conv2D(3, 5, 3))


def test_abstract_init_builds_the_same_tree_on_meta():
    tp.seed(0)
    concrete = _mlp(tp.nn)
    state0 = tp.get_rng_state()
    with tp.nn.abstract_init():
        assert tp.nn.is_abstract_init()
        abstract = _mlp(tp.nn)
        with torch.device("cpu"):       # the meta scope wins over a device
            inner = tp.nn.Linear(3, 2)
        standalone = tp.create_parameter([7, 2], "float32")
    assert not tp.nn.is_abstract_init()
    assert _tree(abstract) == _tree(concrete)
    jp.seed(0)
    with jp.nn.abstract_init():
        jabstract = _mlp(jp.nn)
    assert _tree(abstract) == _tree(jabstract)
    leaves = [p.value for p in abstract.parameters()] + [
        p.value for p in inner.parameters()] + [standalone.value]
    assert all(v.device.type == "meta" for v in leaves)
    assert all(p.value.device.type == "cpu" for p in concrete.parameters())
    # no initializer ran: no generator moved
    state1 = tp.get_rng_state()
    assert state0 and state1.keys() == state0.keys()
    assert all(torch.equal(state1[k], state0[k]) for k in state0)
    # the optimizer plans the same slots for either tree
    plans = []
    for model in (abstract, concrete):
        opt = tp.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=model.parameters())
        plans.append([{k: tuple(s.shape) for k, s in
                       opt.slots_of(n, p).items()}
                      for n, p in zip(opt._names, opt._parameters)])
    assert plans[0] == plans[1]

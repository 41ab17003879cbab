"""``nn.Layer``, ``Parameter``, ``ParamAttr`` and ``functional_call`` of
the port against the JAX package's, on the CPU.

The spec is ``tests/test_nn.py``'s ``test_linear``,
``test_layer_registry``, ``test_forward_hooks``,
``test_functional_call_jit`` and ``test_paddle_grad_does_not_pollute_params``:
the same script runs against each package (``pkg``).  Then the port's own
rules: every ``ParamAttr`` form, ``create_parameter``, the ``Parameter``
fields and their effect on the optimizer and the clips (against the JAX
optimizer), ``to`` / ``astype``, train / eval, deep copies, the wrapper's
identity and in-place writes into the leaf, ``set_state_dict`` from the
JAX layer's numpy state, the torch-facing side (a torch parent over a
Layer, torch tensors in and out), and the device rule.  f32 values agree
to 1e-5 relative (1e-6 absolute) unless a test states otherwise.
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from _torch_cpu_place import cpu_place  # noqa: F401

PKGS = {"jax": paddle_tpu, "port": paddle_tpu_torch}
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _net_class(paddle):
    nn, F = paddle.nn, paddle.nn.functional

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(4, 8)
            self.fc2 = nn.Linear(8, 2)
            self.register_buffer("counter", paddle.zeros([1]))

        def forward(self, x):
            return self.fc2(F.relu(self.fc1(x)))

    return Net


# -- the tests/test_nn.py spec, against each package --------------------------

def test_linear(pkg):
    net = pkg.nn.Linear(4, 3)
    x = pkg.randn([2, 4])
    out = net(x)
    assert out.shape == [2, 3]
    assert net.weight.shape == [4, 3]          # paddle's [in, out]
    np.testing.assert_allclose(
        out.numpy(), x.numpy() @ net.weight.numpy() + net.bias.numpy(),
        rtol=1e-5)


def test_layer_registry(pkg):
    net = _net_class(pkg)()
    names = [n for n, _ in net.named_parameters()]
    assert names == ["fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"]
    assert len(net.parameters()) == 4
    sd = net.state_dict()
    assert list(sd) == ["counter", "fc1.weight", "fc1.bias", "fc2.weight",
                        "fc2.bias"]
    assert len(net.sublayers()) == 2
    assert [n for n, _ in net.named_sublayers()] == ["fc1", "fc2"]
    out = net(pkg.randn([3, 4]))
    assert out.shape == [3, 2]
    net.eval()
    assert not net.fc1.training
    net.train()
    assert net.fc1.training


def test_forward_hooks(pkg):
    net = pkg.nn.Linear(2, 2)
    calls = []
    h1 = net.register_forward_pre_hook(lambda l, inp: calls.append("pre"))
    h2 = net.register_forward_post_hook(
        lambda l, inp, out: calls.append("post"))
    net(pkg.randn([1, 2]))
    assert calls == ["pre", "post"]
    h1.remove()
    h2.remove()
    net(pkg.randn([1, 2]))
    assert calls == ["pre", "post"]
    # a pre-hook's result replaces the inputs, a post-hook's the output
    net.register_forward_pre_hook(lambda l, inp: (inp[0] * 0,))
    net.register_forward_post_hook(lambda l, inp, out: out + 1)
    np.testing.assert_allclose(net(pkg.randn([1, 2])).numpy(),
                               net.bias.numpy()[None] + 1, **TOL)


def test_paddle_grad_does_not_pollute_params(pkg):
    net = pkg.nn.Linear(3, 3)
    x = pkg.randn([2, 3])
    x.stop_gradient = False
    out = net(x)
    (g,) = pkg.grad(out.sum(), x)
    assert g.shape == [2, 3]
    assert net.weight.grad is None and net.bias.grad is None


def test_functional_call_grad_matches_eager_and_jax():
    """``functional_call`` under each package's functional transform
    (``jax.grad`` / ``torch.func.grad``) equals the eager backward, and
    the two packages agree on the same weights."""
    import jax

    nets = {k: P.nn.Sequential(P.nn.Linear(4, 8), P.nn.ReLU(),
                               P.nn.Linear(8, 2)) for k, P in PKGS.items()}
    nets["port"].set_state_dict({k: v.numpy() for k, v in
                                 nets["jax"].state_dict().items()})
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    grads = {}
    jv = paddle_tpu.nn.state_values(nets["jax"])

    def jloss(vals, xv):
        out, _ = paddle_tpu.nn.functional_call(
            nets["jax"], vals, (paddle_tpu.Tensor(xv, _internal=True),))
        return out._value.sum()
    grads["jax"] = {k: np.asarray(v)
                    for k, v in jax.jit(jax.grad(jloss))(jv, x).items()}
    pv = paddle_tpu_torch.nn.state_values(nets["port"])

    def ploss(vals, xv):
        out, _ = paddle_tpu_torch.nn.functional_call(nets["port"], vals,
                                                     (xv,))
        return out.sum()
    grads["port"] = {k: v.detach().numpy() for k, v in torch.func.grad(ploss)(
        pv, torch.from_numpy(x)).items()}
    assert set(grads["port"]) == set(grads["jax"]) == set(pv)
    for k, P in PKGS.items():
        net = nets[k]
        net(P.to_tensor(x)).sum().backward()
        np.testing.assert_allclose(grads[k]["2.weight"],
                                   net[2].weight.grad.numpy(), rtol=1e-4)
    for k in grads["jax"]:
        np.testing.assert_allclose(grads["port"][k], grads["jax"][k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_functional_call_returns_updated_buffers_and_leaves_values():
    bn = paddle_tpu_torch.nn.BatchNorm1D(3)
    vals = paddle_tpu_torch.nn.state_values(bn)
    mean0 = vals["_mean"].clone()
    x = torch.randn(5, 3) + 2.0
    out, new = paddle_tpu_torch.nn.functional_call(bn, vals, (x,))
    assert type(out) is torch.Tensor and set(new) == {"_mean", "_variance"}
    assert torch.equal(vals["_mean"], mean0)            # not written
    torch.testing.assert_close(new["_mean"], 0.1 * x.mean(0))
    assert torch.equal(bn._buffers["_mean"], mean0)     # layer untouched
    fn = paddle_tpu_torch.nn.module_fn(bn)
    out2, _ = fn(vals, x)
    torch.testing.assert_close(out2, out)
    assert paddle_tpu_torch.nn.trainable_mask(bn) == {
        "weight": True, "bias": True, "_mean": False, "_variance": False}


# -- ParamAttr and create_parameter -------------------------------------------

ATTRS = {
    "none": lambda P: None,
    "str": lambda P: "my_w",
    "initializer": lambda P: P.nn.initializer.Constant(0.5),
    "false": lambda P: False,
    "param-attr": lambda P: P.ParamAttr(
        name="w2", initializer=P.nn.initializer.Constant(1.5),
        learning_rate=0.5, trainable=False, need_clip=False),
}


@pytest.mark.parametrize("form", sorted(ATTRS))
def test_every_param_attr_form_matches_jax(form):
    got = {}
    for k, P in PKGS.items():
        layer = P.nn.Layer()
        p = layer.create_parameter([2, 3], attr=ATTRS[form](P))
        b = layer.create_parameter([3], attr=ATTRS[form](P), is_bias=True)
        if form == "false":
            assert p is None and b is None
            continue
        assert isinstance(p, P.nn.Parameter) and p.shape == [2, 3]
        got[k] = dict(trainable=p.trainable, stop_gradient=p.stop_gradient,
                      lr=p.optimize_attr["learning_rate"],
                      need_clip=p.need_clip, persistable=p.persistable,
                      named=p.name if form in ("str", "param-attr") else None,
                      bias=b.numpy().tolist())
        if form in ("initializer", "param-attr"):
            got[k]["value"] = p.numpy().tolist()
    if got:
        assert got["port"] == got["jax"]


def test_create_parameter_dtype_and_default_initializer(pkg):
    layer = pkg.nn.Layer()
    p = layer.create_parameter([3, 4], dtype="float64",
                               default_initializer=pkg.nn.initializer
                               .Constant(2.0))
    assert str(p.dtype).endswith("float64")
    np.testing.assert_array_equal(p.numpy(), np.full((3, 4), 2.0))
    layer.w = p
    assert [n for n, _ in layer.named_parameters()] == ["w"]
    q = layer.add_parameter("q", layer.create_parameter([2]))
    assert layer.q is q or layer.q._value is q._value
    assert len(layer.parameters()) == 2


# The weights the JAX package drew for this net when the file ran in
# order before the test seeded them.  Its data cancels in two gradient
# entries: b.bias[0] sums to 2.36e-6 and b.weight[1, 0] to 1.13e-3 from
# terms near 1e-1.  XLA's CPU tanh is up to 1.8e-7 off the f64 value
# (torch's 2.9e-8), so JAX's b.bias[0] gradient is 1.3% off the f64 one
# (the port's 0.04%), within atol 1e-6 all the same; Adam's g / sqrt(v)
# then turns that into a 1e-3 relative gap in the update.
_CANCELLING_DRAW = {
    "a.weight": [[0.85046554, -0.79381394, -0.5031761, -0.653516],
                 [-0.4518547, -0.66482884, -0.069107495, 0.77106845],
                 [0.25300294, 0.10083323, -0.76939684, 0.82400763],
                 [-0.38800597, 0.05440409, 0.8612533, 0.21790853]],
    "b.weight": [[0.6437753, -0.85627204, 0.42948258, 0.38342592],
                 [-0.6953589, 0.54479784, -0.052736174, 0.8328153],
                 [-0.5192557, 0.38270408, 0.59728396, -0.682042],
                 [-0.042768724, -0.6342313, 0.53450316, 0.061966915]],
    "c.weight": [[0.33102345, -0.16065025], [0.7071166, -0.74080276],
                 [0.5544727, -0.89382696], [0.117203474, -0.27044034]],
    "a.bias": [0.0] * 4, "b.bias": [0.0] * 4, "c.bias": [0.0] * 2}


@pytest.mark.parametrize("draw", ["seed-7", "cancelling"])
def test_parameter_fields_steer_the_optimizer_like_jax(draw):
    """optimize_attr learning rate, need_clip=False (out of the global
    norm) and trainable=False on three parameters of one net: the port's
    AdamW steps give the JAX AdamW's parameters.  The weights are seeded
    (``seed-7``) or the draw above, never what earlier tests left in the
    JAX generator.  Each step's gradients agree first; then the port's
    optimizer steps on the JAX gradients, so that the comparison is of
    the two optimizers and not of Adam's amplified rounding."""
    def build(P):
        nn = P.nn

        class Net(nn.Layer):
            def __init__(self):
                super().__init__()
                self.a = nn.Linear(4, 4, weight_attr=P.ParamAttr(
                    learning_rate=0.25))
                self.b = nn.Linear(4, 4, weight_attr=P.ParamAttr(
                    need_clip=False))
                self.c = nn.Linear(4, 2, bias_attr=P.ParamAttr(
                    trainable=False))

            def forward(self, x):
                return self.c(paddle_tanh(P, self.b(self.a(x))))
        return Net()

    def paddle_tanh(P, x):
        return P.tanh(x)

    paddle_tpu.seed(7)
    nets = {k: build(P) for k, P in PKGS.items()}
    state = ({k: v.numpy() for k, v in nets["jax"].state_dict().items()}
             if draw == "seed-7" else
             {k: np.asarray(v, np.float32)
              for k, v in _CANCELLING_DRAW.items()})
    for net in nets.values():
        net.set_state_dict(state)
    x = np.random.RandomState(1).randn(6, 4).astype(np.float32) * 3
    opts = {k: P.optimizer.AdamW(
        learning_rate=0.05, parameters=nets[k].parameters(),
        grad_clip=P.nn.ClipGradByGlobalNorm(0.1)) for k, P in PKGS.items()}
    for _ in range(3):
        for k, P in PKGS.items():
            loss = (nets[k](P.to_tensor(x)) ** 2).mean()
            loss.backward()
        jgrads = {n: p.grad.numpy() for n, p in
                  nets["jax"].named_parameters() if p.grad is not None}
        leaves = dict(torch.nn.Module.named_parameters(nets["port"]))
        assert sorted(n for n, p in leaves.items()
                      if p.grad is not None) == sorted(jgrads)
        for n, g in jgrads.items():
            np.testing.assert_allclose(leaves[n].grad.numpy(), g, **TOL,
                                       err_msg=n)
            leaves[n].grad = torch.from_numpy(g.copy())
        for k in PKGS:
            opts[k].step()
            opts[k].clear_grad()
    assert nets["port"].c.bias.trainable is False
    jsd, psd = nets["jax"].state_dict(), nets["port"].state_dict()
    for k in jsd:
        np.testing.assert_allclose(psd[k].numpy(), jsd[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_clip_skips_need_clip_false():
    P = paddle_tpu_torch
    p = P.nn.Parameter(np.ones(3, np.float32), need_clip=False)
    q = P.nn.Parameter(np.ones(3, np.float32))
    g = P.to_tensor(np.full(3, 10.0, np.float32))
    out = P.nn.ClipGradByGlobalNorm(1.0)([(p, g), (q, g)])
    np.testing.assert_array_equal(out[0][1].numpy(), g.numpy())
    np.testing.assert_allclose(np.linalg.norm(out[1][1].numpy()), 1.0,
                               rtol=1e-6)


def test_containers_match_jax(pkg):
    """``LayerList``, ``ParameterList``, ``LayerDict`` (and
    ``Sequential`` with names, slicing and ``SyncBatchNorm``'s
    conversion): the same calls give the same names, lengths and
    orders in both packages."""
    nn = pkg.nn
    ll = nn.LayerList([nn.Linear(2, 3), nn.ReLU()])
    ll.append(nn.Linear(3, 1))
    ll.insert(1, nn.Tanh())
    ll.extend([nn.Identity()])
    ll[0] = nn.Linear(2, 3)
    got = dict(ll_len=len(ll), ll_names=list(ll.state_dict()),
               ll_types=[type(m) for m in ll] == [
                   nn.Linear, nn.Tanh, nn.ReLU, nn.Linear, nn.Identity],
               ll_last=isinstance(ll[-1], nn.Identity),
               ll_slice=len(ll[1:3]))
    layer = nn.Layer()
    pl = nn.ParameterList([layer.create_parameter([2]) for _ in range(2)])
    pl.append(layer.create_parameter([3]))
    got.update(pl_len=len(pl), pl_names=list(pl.state_dict()),
               pl_shapes=[p.shape for p in pl], pl_last=pl[-1].shape)
    ld = nn.LayerDict({"a": nn.Linear(2, 2), "b": nn.ReLU()})
    ld["c"] = nn.Linear(2, 1)
    popped = ld.pop("b")
    got.update(ld_keys=list(ld.keys()), ld_names=list(ld.state_dict()),
               ld_has=("a" in ld, "b" in ld),
               popped=isinstance(popped, nn.ReLU))
    seq = nn.Sequential(("conv", nn.Conv2D(3, 4, 3)),
                        ("bn", nn.BatchNorm2D(4)))
    nn.SyncBatchNorm.convert_sync_batchnorm(seq)
    got.update(seq_names=list(seq.state_dict()),
               seq_bn=isinstance(seq["bn"], nn.SyncBatchNorm),
               seq_slice=len(seq[:1]))
    want = {
        "ll_len": 5, "ll_names": ["0.weight", "0.bias", "3.weight", "3.bias"],
        "ll_types": True, "ll_last": True, "ll_slice": 2, "pl_len": 3,
        "pl_names": ["0", "1", "2"], "pl_shapes": [[2], [2], [3]],
        "pl_last": [3], "ld_keys": ["a", "c"],
        "ld_names": ["a.weight", "a.bias", "c.weight", "c.bias"],
        "ld_has": (True, False), "popped": True,
        "seq_names": ["conv.weight", "conv.bias", "bn.weight", "bn.bias",
                      "bn._mean", "bn._variance"],
        "seq_bn": True, "seq_slice": 1}
    assert got == want


# -- Parameter and buffers ----------------------------------------------------

def test_parameter_is_the_registered_leaf():
    P = paddle_tpu_torch
    lin = P.nn.Linear(3, 2)
    w = lin.weight
    assert w is lin.weight and w.value is lin._parameters["weight"]
    assert isinstance(w.value, torch.nn.Parameter)
    w.set_value(np.ones((3, 2), np.float32))           # into the leaf
    assert torch.equal(lin._parameters["weight"], torch.ones(3, 2))
    w[0] = 5.0                                         # an in-place form
    assert float(lin._parameters["weight"][0, 0]) == 5.0
    w.copy_(torch.zeros(3, 2))
    assert w.value is lin._parameters["weight"] and float(w.sum()) == 0.0
    with pytest.raises(ValueError):
        w.set_value(np.ones((2, 2), np.float32))
    with pytest.raises(TypeError):
        lin.weight = P.to_tensor(np.ones((3, 2), np.float32))
    w.need_clip = False                 # fields live on the leaf
    assert lin._parameters["weight"]._paddle_attrs["need_clip"] is False
    assert "Parameter containing" in repr(w)


def test_buffers_are_bound_and_persistable_flags(pkg):
    layer = pkg.nn.Layer()
    layer.register_buffer("kept", pkg.zeros([2]))
    layer.register_buffer("scratch", pkg.ones([2]), persistable=False)
    assert list(layer.state_dict()) == ["kept"]
    assert len(layer.buffers()) == 2
    if pkg is paddle_tpu_torch:
        layer.kept[0] = 3.0             # writes the registered buffer
        assert float(layer._buffers["kept"][0]) == 3.0
        layer.kept = pkg.ones([2])      # assigning a Tensor to a buffer
        assert torch.equal(layer._buffers["kept"], torch.ones(2))


def test_set_state_dict_from_jax_numpy_and_errors():
    jl = paddle_tpu.nn.Sequential(paddle_tpu.nn.Linear(3, 4),
                                  paddle_tpu.nn.BatchNorm1D(4))
    pl = paddle_tpu_torch.nn.Sequential(paddle_tpu_torch.nn.Linear(3, 4),
                                        paddle_tpu_torch.nn.BatchNorm1D(4))
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    assert list(state) == list(pl.state_dict())
    assert pl.set_state_dict(state) == ([], [])
    for k, v in pl.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[k])
    torch_state = {k: torch.from_numpy(v) for k, v in state.items()}
    torch_state["extra"] = torch.zeros(1)
    del torch_state["1._mean"]
    missing, unexpected = pl.load_dict(torch_state)
    assert missing == ["1._mean"] and unexpected == ["extra"]
    with pytest.raises(ValueError, match="0.weight"):
        pl.set_dict({"0.weight": np.zeros((4, 3), np.float32)})


def test_to_astype_and_modes(pkg):
    net = pkg.nn.Sequential(pkg.nn.Linear(3, 4), pkg.nn.BatchNorm1D(4),
                            pkg.nn.Dropout(0.5))
    net.to(dtype="bfloat16")
    assert {str(p.dtype).split(".")[-1] for p in net.parameters()} == \
        {"bfloat16"}
    net.astype("float32")
    assert {str(b.dtype).split(".")[-1] for b in net.buffers()} == \
        {"float32"}
    if pkg is paddle_tpu_torch:
        net.to("cpu")
        assert {str(p.place) for p in net.parameters()} == \
            {str(pkg.CPUPlace())}
        net.to(device=pkg.CPUPlace(), dtype=torch.float64)
        assert net[0].weight.dtype == torch.float64
    net.eval()
    assert not any(l.training for l in net.sublayers(include_self=True))
    net.train()
    assert all(l.training for l in net.sublayers(include_self=True))


def test_deepcopy_shares_nothing_and_keeps_fields(pkg):
    layer = pkg.nn.TransformerEncoderLayer(8, 2, 16)
    enc = pkg.nn.TransformerEncoder(layer, 3)
    params = enc.parameters()
    assert len(params) == 3 * len(layer.parameters())
    assert len({id(p._value) for p in params}) == len(params)
    if pkg is paddle_tpu_torch:
        lin = pkg.nn.Linear(2, 2, weight_attr=pkg.ParamAttr(
            learning_rate=0.3, need_clip=False))
        dup = copy.deepcopy(lin)
        assert dup.weight.value is not lin.weight.value
        assert dup.weight.optimize_attr["learning_rate"] == 0.3
        assert dup.weight.need_clip is False
        assert dup.weight.name != lin.weight.name
        names = [p.name for p in enc.parameters()]
        assert len(set(names)) == len(names)


# -- the torch-facing side ----------------------------------------------------

def test_call_boundary_torch_in_torch_out():
    P = paddle_tpu_torch
    net = _net_class(P)()
    x = np.random.RandomState(2).randn(3, 4).astype(np.float32)
    out_t = net(torch.from_numpy(x))
    out_s = net(P.to_tensor(x))
    assert type(out_t) is torch.Tensor and isinstance(out_s, P.Tensor)
    np.testing.assert_array_equal(out_t.detach().numpy(), out_s.numpy())
    mha = P.nn.MultiHeadAttention(8, 2, need_weights=True)
    xs = np.random.RandomState(3).randn(2, 5, 8).astype(np.float32)
    o, w = mha(torch.from_numpy(xs))
    assert type(o) is torch.Tensor and type(w) is torch.Tensor
    o2, w2 = mha(P.to_tensor(xs))
    assert isinstance(o2, P.Tensor) and isinstance(w2, P.Tensor)
    np.testing.assert_array_equal(o2.numpy(), o.detach().numpy())
    cache = mha.gen_cache(P.to_tensor(xs))
    *_, new_cache = mha(P.to_tensor(xs), cache=cache)
    assert new_cache.k.shape == [2, 5, 2, 4]


def test_torch_parent_over_a_layer_child():
    P = paddle_tpu_torch

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.proj = torch.nn.Linear(8, 8)
            self.norm = P.nn.LayerNorm(8)

        def forward(self, x):
            return self.norm(self.proj(x))

    blk = Block()
    sd = blk.state_dict()
    assert list(sd) == ["proj.weight", "proj.bias", "norm.weight",
                        "norm.bias"]
    assert all(type(v) is torch.Tensor for v in sd.values())
    assert all(isinstance(p, torch.nn.Parameter)
               for p in blk.parameters())
    assert next(torch.nn.Module.parameters(blk.norm)) is \
        blk.norm._parameters["weight"]
    blk.to(torch.float64)
    assert blk.norm._parameters["weight"].dtype == torch.float64
    out = blk(torch.randn(2, 8, dtype=torch.float64))
    assert type(out) is torch.Tensor
    blk.load_state_dict({k: v.to(torch.float64) for k, v in sd.items()})
    vals = {k: v.detach().clone() for k, v in blk.state_dict().items()}
    one = torch.ones(1, 8, dtype=torch.float64)
    y = torch.func.functional_call(blk, vals, (one,))
    assert y.shape == (1, 8)


def test_user_layer_on_torch_tensors_gives_torch():
    class Scale(paddle_tpu_torch.nn.Layer):
        def __init__(self):
            super().__init__()
            self.w = self.create_parameter([3], is_bias=True)

        def forward(self, x):
            return x + self.w          # a surface Parameter

    out = Scale()(torch.ones(2, 3))
    assert type(out) is torch.Tensor


def test_parameters_are_created_on_the_current_place_or_torch_device():
    """The current place is the card: without one, creation raises (no
    CPU fallback); an active ``torch.device`` block decides instead."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    from paddle_tpu_torch.core import place
    P = paddle_tpu_torch
    place._current_place = P.CUDAPlace(0)    # the default; cpu_place restores
    with pytest.raises(RuntimeError, match="no CUDA card"):
        P.nn.Linear(2, 2)
    with torch.device("cpu"):
        lin = P.nn.Linear(2, 2)
    assert lin.weight.place == P.CPUPlace()

"""The ten optimizers of the port against the JAX package's, on the CPU.

* Each optimizer x {no decay, ``L2Decay``, and ``L1Decay`` where the JAX
  optimizer takes it (AdamW reads its coefficient)}: 5 eager steps of the
  same gradients on a matrix and a vector; parameters and every slot
  (``state_dict()``) within 1e-6.
* ``tests/test_optimizer.py::test_optimizers_decrease_loss``'s eight makers
  on both packages from the same numpy weights and data: the final losses
  agree to 1e-4 relative and fall below its 0.35.
* ``state_dict`` JAX -> port -> JAX: a step taken after each carry matches.
* The lazy row update: ``Embedding(sparse=True)`` in both packages, 3
  steps of each optimizer over ids that touch some rows and leave others;
  the table and the slots match JAX's ``update_sparse`` at 1e-6, and the
  untouched rows are bit for bit what they were.
* Lamb's and LARS's zero-norm branches (a zero parameter, a zero
  gradient): the ratio is 1, as in JAX.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
import paddle_tpu_torch
import paddle_tpu_torch.nn as pnn
import paddle_tpu_torch.optimizer as popt
from _torch_cpu_place import cpu_place  # noqa: F401

TOL = 1e-6

# (name, keyword arguments, the decay cases it takes)
OPTIMIZERS = [
    ("SGD", {}, "wd"),
    ("Momentum", dict(momentum=0.9), "wd"),
    ("Momentum", dict(momentum=0.9, use_nesterov=True), "wd"),
    ("Adam", {}, "wd"),
    ("AdamW", {}, "adamw"),
    ("Adagrad", dict(initial_accumulator_value=0.1), "wd"),
    ("RMSProp", {}, "wd"),
    ("RMSProp", dict(momentum=0.9, centered=True), "wd"),
    ("Adadelta", dict(rho=0.9), "wd"),
    ("Adamax", {}, "wd"),
    ("Lamb", {}, "lamb"),
    ("LarsMomentum", {}, "lars"),
]


def _decays(kind):
    """The decay cases of one optimizer: (tag, keyword arguments)."""
    if kind == "wd":
        return [("none", lambda m: {}),
                ("l2", lambda m: dict(weight_decay=m.L2Decay(0.05)))]
    if kind == "adamw":
        return [("none", lambda m: dict(weight_decay=0.0)),
                ("coeff", lambda m: dict(weight_decay=0.05)),
                ("l1", lambda m: dict(weight_decay=m.L1Decay(0.05)))]
    if kind == "lamb":
        return [("none", lambda m: dict(lamb_weight_decay=0.0)),
                ("wd", lambda m: dict(lamb_weight_decay=0.05)),
                ("exclude", lambda m: dict(
                    lamb_weight_decay=0.05,
                    exclude_from_weight_decay_fn=lambda p: p.ndim == 1))]
    return [("none", lambda m: dict(lars_weight_decay=0.0)),
            ("wd", lambda m: dict(lars_weight_decay=0.05))]


CASES = [(n, kw, tag, dk) for n, kw, kind in OPTIMIZERS
         for tag, dk in _decays(kind)]


def _ids(cases):
    return [f"{n}-{'-'.join(f'{k}={v}' for k, v in kw.items())}-{tag}"
            for n, kw, tag, _ in cases]


def _make(mod, name, kw, decay, params, lr=0.05):
    return getattr(mod, name)(lr, parameters=params, **kw, **decay(mod))


def _data(seed=0, steps=5):
    rng = np.random.RandomState(seed)
    params = [rng.standard_normal((6, 4)).astype(np.float32),
              rng.standard_normal(4).astype(np.float32)]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p in params]
             for _ in range(steps)]
    return params, grads


def _jax_run(name, kw, decay, params, grads):
    ps = [jnn.Parameter(p.copy()) for p in params]
    o = _make(jopt, name, kw, decay, ps)
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = paddle_tpu.to_tensor(g)
        o.step()
    return o, ps


def _port_run(name, kw, decay, params, grads):
    ps = [pnn.Parameter(p.copy()) for p in params]
    o = _make(popt, name, kw, decay, ps)
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g)
        o.step()
    return o, ps


def _slots(o, ps, port):
    """``[{slot: array}]`` per parameter, in parameter order."""
    out = []
    for i, p in enumerate(ps):
        if port:
            src = o._slots.get(o._names[i], {})
            out.append({k: v.numpy() for k, v in src.items()})
        else:
            out.append({k: np.asarray(v)
                        for k, v in o._slots.get(id(p), {}).items()})
    return out


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("name, kw, tag, decay", CASES, ids=_ids(CASES))
def test_five_steps_match_jax(name, kw, tag, decay):
    params, grads = _data()
    jo, jps = _jax_run(name, kw, decay, params, grads)
    po, pps = _port_run(name, kw, decay, params, grads)
    for i, (jp, pp) in enumerate(zip(jps, pps)):
        _close(pp.numpy(), jp.numpy(), f"param {i}")
    js, ps = _slots(jo, jps, False), _slots(po, pps, True)
    for i, (a, b) in enumerate(zip(js, ps)):
        assert set(a) == set(b), (a.keys(), b.keys())
        for k in a:
            _close(b[k], a[k], f"param {i} slot {k}")
    # the state dict's names are <name>_<slot>, as in the JAX package
    keys = set(po.state_dict()) - {"LR_Scheduler", "master_weights",
                                   "step_count"}
    assert keys == {f"{n}_{k}" for n, s in zip(po._names, ps) for k in s}


def _quadratic(mod, maker, w0, x, target, steps=80):
    """``test_optimizer.py``'s quadratic on one package, from numpy."""
    net = mod.nn.Linear(4, 4, bias_attr=False)
    net.set_state_dict({"weight": w0})
    xt, tt = mod.to_tensor(x), mod.to_tensor(target)
    o = maker(mod.optimizer, net.parameters())
    loss_val = None
    for _ in range(steps):
        loss = ((net(xt) - tt) ** 2).mean()
        loss.backward()
        o.step()
        o.clear_grad()
        loss_val = float(loss.item())
    return loss_val


@pytest.mark.parametrize("maker", [
    lambda m, p: m.SGD(0.1, parameters=p),
    lambda m, p: m.Momentum(0.05, 0.9, parameters=p),
    lambda m, p: m.Adam(0.1, parameters=p),
    lambda m, p: m.AdamW(0.1, parameters=p, weight_decay=0.0),
    lambda m, p: m.RMSProp(0.02, parameters=p),
    lambda m, p: m.Adagrad(0.3, parameters=p),
    lambda m, p: m.Adamax(0.1, parameters=p),
    lambda m, p: m.Lamb(0.05, parameters=p, lamb_weight_decay=0.0),
], ids=["sgd", "momentum", "adam", "adamw", "rmsprop", "adagrad", "adamax",
        "lamb"])
def test_optimizers_decrease_loss_on_both(maker):
    rng = np.random.RandomState(0)
    x = rng.standard_normal((16, 4)).astype(np.float32)
    target = x @ rng.standard_normal((4, 4)).astype(np.float32)
    w0 = rng.uniform(-0.8, 0.8, (4, 4)).astype(np.float32)
    want = _quadratic(paddle_tpu, maker, w0, x, target)
    got = _quadratic(paddle_tpu_torch, maker, w0, x, target)
    assert want < 0.35 and got < 0.35, (want, got)
    np.testing.assert_allclose(got, want, rtol=1e-4)


STATE_CASES = [c for c in CASES if c[2] == "none"]


@pytest.mark.parametrize("name, kw, tag, decay", STATE_CASES,
                         ids=_ids(STATE_CASES))
def test_state_dict_crosses_jax_port_jax(name, kw, tag, decay):
    params, grads = _data(1, steps=4)
    jo, jps = _jax_run(name, kw, decay, params, grads[:2])
    # JAX -> port: the port continues from JAX's parameters and slots
    sd = {k: (np.asarray(v.numpy()) if hasattr(v, "numpy") else v)
          for k, v in jo.state_dict().items()}
    po, pps = _port_run(name, kw, decay,
                        [p.numpy() for p in jps], [])
    po.set_state_dict({k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                       else v for k, v in sd.items()})
    assert po._step_count == 2
    for gs in grads[2:3]:
        for p, g in zip(jps, gs):
            p.grad = paddle_tpu.to_tensor(g)
        jo.step()
        for p, g in zip(pps, gs):
            p.grad = torch.from_numpy(g)
        po.step()
    for jp, pp in zip(jps, pps):
        _close(pp.numpy(), jp.numpy(), "after JAX -> port")
    # port -> JAX: a fresh JAX optimizer continues from the port's state
    jo2, jps2 = _jax_run(name, kw, decay, [p.numpy() for p in pps], [])
    jo2.set_state_dict({k: (v.numpy() if torch.is_tensor(v) else v)
                        for k, v in po.state_dict().items()})
    assert jo2._step_count == 3
    for p, g in zip(jps2, grads[3]):
        p.grad = paddle_tpu.to_tensor(g)
    jo2.step()
    for p, g in zip(pps, grads[3]):
        p.grad = torch.from_numpy(g)
    po.step()
    for jp, pp in zip(jps2, pps):
        _close(pp.numpy(), jp.numpy(), "after port -> JAX")


LAZY_CASES = [c for c in CASES if c[2] != "exclude"]
V, D = 12, 3
LAZY_IDS = [np.array([[1, 3, 3], [7, 1, -2]]),       # -2 clips to row 0
            np.array([[3, 3, 20], [2, 1, 1]]),       # 20 clips to row 11
            np.array([[5, 1, 2], [3, 7, 3]])]


def _lazy(mod, name, kw, decay, table, w_out):
    emb = mod.nn.Embedding(V, D, sparse=True, padding_idx=2)
    emb.set_state_dict({"weight": table})
    o = _make(mod.optimizer, name, kw, decay, emb.parameters(), lr=0.1)
    for ids in LAZY_IDS:
        out = emb(mod.to_tensor(ids))
        (out * mod.to_tensor(w_out)).sum().backward()
        o.step()
        o.clear_grad()
    return emb, o


@pytest.mark.parametrize("name, kw, tag, decay", LAZY_CASES,
                         ids=_ids(LAZY_CASES))
def test_lazy_row_update_matches_jax(name, kw, tag, decay):
    rng = np.random.RandomState(2)
    table = rng.standard_normal((V, D)).astype(np.float32)
    table[2] = 0.0
    w_out = rng.standard_normal((2, 3, D)).astype(np.float32)
    je, jo = _lazy(paddle_tpu, name, kw, decay, table, w_out)
    pe, po = _lazy(paddle_tpu_torch, name, kw, decay, table, w_out)
    got, want = pe.weight.numpy(), je.weight.numpy()
    _close(got, want, "table")
    js = _slots(jo, [je.weight], False)[0]
    ps = _slots(po, [pe.weight], True)[0]
    for k in js:
        _close(ps[k], js[k], f"slot {k}")
    untouched = sorted(set(range(V)) - {0, 1, 2, 3, 5, 7, 11})
    assert untouched == [4, 6, 8, 9, 10]
    np.testing.assert_array_equal(got[untouched], table[untouched])
    for k, v in ps.items():
        init = np.float32(0.1 if name == "Adagrad" else 0.0)
        np.testing.assert_array_equal(v[untouched], init, err_msg=k)


def test_lamb_and_lars_take_ratio_one_at_zero_norms():
    zero_p = [np.zeros((3, 2), np.float32), np.ones(2, np.float32)]
    grads = [[np.full((3, 2), 0.5, np.float32), np.zeros(2, np.float32)]]

    def run(port, name, kw):
        fn = _port_run if port else _jax_run
        return [p.numpy() for p in fn(name, kw, lambda m: {}, zero_p,
                                      grads)[1]]

    for name, kw in (("Lamb", dict(lamb_weight_decay=0.0)),
                     ("LarsMomentum", dict(lars_weight_decay=0.01))):
        want, got = run(False, name, kw), run(True, name, kw)
        for a, b in zip(want, got):
            _close(b, a, name)
    # Lamb at a zero parameter: the trust ratio is 1, the Adam-like step
    # is the parameter's change (lr * mhat / (sqrt(vhat) + eps))
    got = run(True, "Lamb", dict(lamb_weight_decay=0.0))
    np.testing.assert_allclose(got[0], -0.05 / (1 + 1e-6 / 0.5), rtol=1e-6)
    # LARS with a zero gradient: rate 1, only the decay term moves it
    got = run(True, "LarsMomentum", dict(lars_weight_decay=0.01))
    np.testing.assert_allclose(got[1], 1 - 0.05 * 0.01, rtol=1e-6)


def test_every_name_of_the_jax_optimizer_package_exists():
    public = {n for n in dir(jopt) if not n.startswith("_")}
    missing = public - set(dir(popt))
    assert not missing, sorted(missing)


@pytest.mark.parametrize("name, kw, tag, decay", STATE_CASES,
                         ids=_ids(STATE_CASES))
def test_the_train_step_updates_as_the_eager_step(name, kw, tag, decay):
    from paddle_tpu_torch.distributed import make_train_step

    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((8, 3)).astype(np.float32))
    w = rng.standard_normal((6, 3)).astype(np.float32)

    def loss_fn(out, t):
        return ((out - t) ** 2).mean()

    nets = []
    for compiled in (True, False):
        net = pnn.Linear(6, 3)
        net.set_state_dict({"weight": w, "bias": np.zeros(3, np.float32)})
        o = _make(popt, name, kw, decay, net)
        if compiled:
            step = make_train_step(net, o, loss_fn=loss_fn)
            for _ in range(3):
                step(x, y)
        else:
            for _ in range(3):
                loss_fn(net(x), y).backward()
                o.step()
                o.clear_grad()
        nets.append(net)
    for k, v in nets[1].state_dict().items():
        np.testing.assert_allclose(nets[0].state_dict()[k].numpy(),
                                   v.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=k)

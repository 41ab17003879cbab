"""The port's top-level runtime names against the JAX package's, on the
CPU: ``flags``, ``version``, ``sysconfig``, ``compat``, ``hub``,
``LazyGuard``, ``flops``, the places, ``device.tpu`` without a card, the
RNG-state aliases, the static-mode switches, and the top-level gap (the
JAX package's public names the port does not have, each with a reason).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.core import place as place_mod

PKGS = (paddle_tpu, paddle_tpu_torch)

# the JAX package's public top-level names the port does not have
NOT_PORTED = {
    # JAX itself and the JAX-only helpers
    "jax", "jnp", "lax", "np", "to_jax", "rnd", "annotations",
    # entry 11 (distributed)
    "DataParallel", "parallel",
    # entry 12's programs and export (ROADMAP section 1)
    "cost_model", "inference", "jit", "onnx", "static",
}

# public names of paddle_tpu.incubate the port does not have: none
INCUBATE_NOT_PORTED = set()


def test_the_top_level_gap_is_the_listed_names():
    # in a fresh interpreter: a submodule another test imported
    # (paddle_tpu.strings) would show in dir() as well
    out = subprocess.run(
        [sys.executable, "-c",
         "import json, paddle_tpu as a, paddle_tpu_torch as b; "
         "print(json.dumps(sorted({n for n in dir(a) if not "
         "n.startswith('_')} - set(dir(b)))))"],
        capture_output=True, text=True, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == \
        sorted(NOT_PORTED)
    assert len(NOT_PORTED) == 14


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def test_linalg_has_every_name_of_the_jax_linalg():
    import paddle_tpu.linalg as jlinalg
    import paddle_tpu_torch.linalg as plinalg

    assert paddle_tpu_torch.linalg is plinalg
    assert _public(jlinalg) <= _public(plinalg)
    assert plinalg.inv is plinalg.inverse
    for n in ("inv", "lu", "lu_unpack", "cond"):
        assert callable(getattr(plinalg, n)), n


def test_utils_names_equal_jax():
    # in a fresh interpreter, as the top-level gap
    out = subprocess.run(
        [sys.executable, "-c",
         "import json, paddle_tpu.utils as a, paddle_tpu_torch.utils as b; "
         "pub = lambda m: {n for n in dir(m) if not n.startswith('_')}; "
         "print(json.dumps([sorted(pub(a) - pub(b)), "
         "sorted(pub(b) - pub(a))]))"],
        capture_output=True, text=True, timeout=300, check=True)
    missing, extra = json.loads(out.stdout.strip().splitlines()[-1])
    assert missing == [] and extra == []


def test_incubate_names_equal_jax_but_the_listed_remainder():
    # in a fresh interpreter, as the top-level gap: submodules another
    # test imported would show in dir() as well
    out = subprocess.run(
        [sys.executable, "-c",
         "import json, paddle_tpu.incubate as a, paddle_tpu_torch.incubate "
         "as b; pub = lambda m: {n for n in dir(m) if not "
         "n.startswith('_')}; print(json.dumps([sorted(pub(a) - pub(b)), "
         "sorted(pub(b) - pub(a))]))"],
        capture_output=True, text=True, timeout=300, check=True)
    missing, extra = json.loads(out.stdout.strip().splitlines()[-1])
    assert missing == sorted(INCUBATE_NOT_PORTED)
    assert extra == []


def test_flags_match_jax():
    names = list(paddle_tpu.flags._FLAGS)
    assert len(names) == 13
    for pkg in PKGS:
        with pytest.raises(ValueError, match="unknown flag"):
            pkg.set_flags({"FLAGS_no_such_flag": 1})
        with pytest.raises(ValueError, match="unknown flag"):
            pkg.get_flags("no_such_flag")
    assert paddle_tpu_torch.get_flags(names) == paddle_tpu.get_flags(names)
    assert paddle_tpu_torch.get_flags("benchmark") == {
        "FLAGS_benchmark": False}


def test_set_flags_records_and_wires_check_nan_inf_and_telemetry():
    from paddle_tpu_torch import observability
    from paddle_tpu_torch.core import op
    from paddle_tpu_torch.observability import flight

    paddle = paddle_tpu_torch
    try:
        paddle.set_flags({"check_nan_inf": True, "FLAGS_telemetry": "1",
                          "paddle_num_threads": "4"})
        assert op.CHECK_NAN_INF and observability.enabled()
        assert paddle.get_flags(["paddle_num_threads"]) == {
            "FLAGS_paddle_num_threads": 4}
        recorded = {e["name"]: e["attrs"]["value"]
                    for e in flight.events("flag")}
        assert recorded["FLAGS_check_nan_inf"] == "True"
        assert recorded["FLAGS_paddle_num_threads"] == "4"
        x = paddle.to_tensor(np.array([0.0, 1.0], np.float32),
                             place=paddle.CPUPlace())
        with pytest.raises(RuntimeError, match="NaN"):
            paddle.log(x - 1.0)
    finally:
        paddle.set_flags({"check_nan_inf": False, "telemetry": False,
                          "paddle_num_threads": 1})
    assert not op.CHECK_NAN_INF and not observability.enabled()


def test_flags_bootstrap_from_the_environment():
    env = dict(os.environ, FLAGS_paddle_num_threads="3",
               FLAGS_check_nan_inf="true")
    out = subprocess.run(
        [sys.executable, "-c",
         "import paddle_tpu_torch as p; from paddle_tpu_torch.core import "
         "op; print(p.get_flags(['paddle_num_threads', 'check_nan_inf']), "
         "op.CHECK_NAN_INF)"],
        env=env, capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip().endswith(
        "{'FLAGS_paddle_num_threads': 3, 'FLAGS_check_nan_inf': True} True")


def test_version_describes_the_port_build():
    v = paddle_tpu_torch.version
    assert v.full_version == paddle_tpu.version.full_version
    assert paddle_tpu_torch.full_version == v.full_version
    assert paddle_tpu_torch.commit == v.commit == paddle_tpu.commit
    assert v.with_gpu == ("ON" if torch.version.cuda else "OFF")
    assert v.cuda_version == (torch.version.cuda or "False")
    assert v.cuda() == (torch.version.cuda or False)
    assert v.tpu() is False and v.with_tpu == "OFF"
    for name in ("major", "minor", "patch", "rc", "istaged"):
        assert getattr(v, name) == getattr(paddle_tpu.version, name), name
    v.show()


def test_sysconfig_and_compat():
    inc = paddle_tpu_torch.sysconfig.get_include()
    assert os.path.isfile(os.path.join(inc, "sm90.cuh"))
    assert paddle_tpu_torch.sysconfig.get_lib() == inc
    for pkg in PKGS:
        c = pkg.compat
        assert c.to_text(b"ab") == "ab"
        assert c.to_bytes("ab") == b"ab"
        assert c.round(2.5) == 3.0 and c.round(-2.5) == -3.0
        assert c.to_text([b"a", {b"k": b"v"}]) == ["a", {"k": "v"}]
        assert c.to_bytes({"x"}) == {b"x"}
        assert c.floor_division(7, 2) == 3
        assert c.get_exception_message(ValueError("boom")) == "boom"
        assert pkg.regularizer.L2Decay(0.1).coeff == 0.1


def test_hub_loads_a_port_model_from_a_local_hubconf(tmp_path):
    (tmp_path / "hubconf.py").write_text(
        "def tiny_model(width=4):\n"
        "    '''A tiny linear model.'''\n"
        "    import paddle_tpu_torch.nn as nn\n"
        "    return nn.Linear(width, width)\n")
    hub = paddle_tpu_torch.hub
    assert hub.list(str(tmp_path)) == ["tiny_model"]
    assert "tiny" in hub.help(str(tmp_path), "tiny_model")
    prev = place_mod._current_place
    place_mod.set_device("cpu")
    try:
        m = hub.load(str(tmp_path), "tiny_model", width=3)
    finally:
        place_mod._current_place = prev
    assert isinstance(m, paddle_tpu_torch.nn.Linear)
    assert tuple(m.weight.shape) == (3, 3)
    for pkg in PKGS:
        with pytest.raises(RuntimeError, match="egress"):
            pkg.hub.load("user/repo", "m", source="github")
        with pytest.raises(ValueError):
            pkg.hub.load(str(tmp_path), "no_such_model")


def test_lazy_guard_allocates_nothing():
    # the current place is the card, which this machine lacks: anything
    # made there would raise
    prev = place_mod._current_place
    place_mod._current_place = place_mod.CUDAPlace(0)
    try:
        with paddle_tpu_torch.LazyGuard():
            net = paddle_tpu_torch.nn.Sequential(
                paddle_tpu_torch.nn.Linear(8, 16),
                paddle_tpu_torch.nn.BatchNorm1D(16))
    finally:
        place_mod._current_place = prev
    tensors = list(torch.nn.Module.parameters(net)) + \
        list(torch.nn.Module.buffers(net))
    assert tensors and all(t.device.type == "meta" for t in tensors)
    assert tuple(net[0].weight.shape) == (8, 16)


def _conv_net(m):
    return m.nn.Sequential(m.nn.Conv2D(3, 8, 3), m.nn.ReLU(),
                           m.nn.Conv2D(8, 4, 3, padding=1))


def test_flops_against_jax():
    prev = place_mod._current_place
    place_mod.set_device("cpu")
    try:
        paddle_tpu.seed(0)
        lin = [pkg.flops(pkg.nn.Linear(8, 16), (4, 8)) for pkg in PKGS]
        conv = [pkg.flops(_conv_net(pkg), (2, 3, 10, 10)) for pkg in PKGS]
    finally:
        place_mod._current_place = prev
    # a Linear: both count the product's 2 * B * in * out
    assert lin == [2 * 4 * 8 * 16] * 2
    # the conv net: the port counts every tap of every window (2 * N *
    # Cout * Hout * Wout * Cin * kh * kw); XLA's cost analysis leaves out
    # the taps on the second conv's zero padding and adds the element-wise
    # ops (both biases and the ReLU)
    full = 2 * 2 * 8 * 8 * 8 * 3 * 9 + 2 * 2 * 4 * 8 * 8 * 8 * 9
    in_bounds = (2 + 3 * 6 + 2) ** 2            # per 8x8 output, padding 1
    padded_taps = 2 * 2 * 4 * 8 * (64 * 9 - in_bounds)
    elementwise = 2 * 8 * 8 * 8 * 2 + 2 * 4 * 8 * 8
    assert conv[1] == full
    assert conv[0] == full - padded_taps + elementwise


def test_places_device_tpu_and_rng_aliases():
    p = paddle_tpu_torch
    assert p.TPUPlace(1).get_device_id() == 1
    assert p.TPUPlace(0) == p.CUDAPlace(0)
    assert p.device.TPUPlace is p.TPUPlace
    for name in ("CustomPlace", "IPUPlace", "MLUPlace", "NPUPlace",
                 "XPUPlace"):
        assert getattr(p, name) is p.Place
        assert getattr(paddle_tpu, name) is paddle_tpu.Place
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            p.TPUPlace(0).torch_device()
        assert p.device.tpu.device_count() == 0
        assert p.device.tpu.memory_stats() == {}
        assert p.device.tpu.hbm_bytes() == 0
    assert p.get_cuda_rng_state is p.get_rng_state
    assert p.set_cuda_rng_state is p.set_rng_state
    state = p.get_cuda_rng_state()
    p.seed(7)
    p.set_cuda_rng_state(state)
    now = p.get_rng_state()
    assert set(now) == set(state)
    assert all(torch.equal(now[k], state[k]) for k in state)


def test_static_switches_and_the_small_names():
    for pkg in PKGS:
        assert pkg.in_dynamic_mode()
        pkg.enable_static()
        try:
            assert not pkg.in_dynamic_mode()
        finally:
            pkg.disable_static()
        assert pkg.in_dynamic_mode()
        assert pkg.is_grad_enabled_() == pkg.is_grad_enabled()
        assert pkg.disable_signal_handler() is None
        for n in ("cinn", "ipu", "mlu", "npu"):
            assert getattr(pkg, f"is_compiled_with_{n}")() is False
        assert pkg.VarBase is pkg.Tensor
    p = paddle_tpu_torch
    assert p.get_cudnn_version() == torch.backends.cudnn.version()
    from paddle_tpu_torch.core import op
    assert (p.apply_op, p.defop, p.register_tensor_method) == (
        op.apply_op, op.defop, op.register_tensor_method)
    assert p.sparse is __import__("paddle_tpu_torch.sparse").sparse

"""The port's conv + batch-norm experiment kernels (``kernels/conv_bn.py``)
against the three experiment scripts' Pallas kernels, on the CPU.

The JAX side runs each script's function as written, its ``pallas_call``
in Pallas TPU interpret mode (``force_tpu_interpret_mode``; the scripts
pass no ``interpret`` flag); the port side runs the plain versions its
wrappers take for CPU tensors.  Inputs come from numpy seeds at the
scripts' scales (x ~ N(0, 1) bf16, s ~ 1 + 0.1 N, b ~ 0.1 N, w ~ N(0,
1/fan_in) bf16), at small shapes.

Tolerances: ``y`` is bf16 on both sides, the rounding of f32 products of
the same bf16 operands summed in another order, so an element may sit one
bf16 step apart: rtol 1e-2, atol 1e-3.  The f32 statistics sum the same
f32 values in another order: rtol 1e-5 and atol 1e-5 of the largest
column sum.

* Kernel 11 (``fused_conv1x1_bn``): a whole tile, a ragged M (the script
  pads and masks the rows past M) and tiles clamped to the shape.
* Kernel 12 (``fused3x3``): b ~ 0.1 N and b > 0 (so ``relu(b) > 0``: a
  border tap must read the zero padding AFTER the prologue), over one
  and two images a block.
* Kernel 13 (``run_mm`` with ``_k_mm`` and ``_k_stat``, ``run_pro``).
* The shapes the scripts refuse or leave partly unwritten raise
  ``ValueError`` in the port (and the JAX side's refusal is shown where
  it asserts).
* The statistics come from the f32 accumulator: the kernels' sums differ
  from ``xla_chain``'s sums of the rounded ``y``, which ``chain_1x1`` and
  ``chain_3x3`` reproduce.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
pltpu = pytest.importorskip("jax.experimental.pallas.tpu")

from paddle_tpu_torch.kernels import conv_bn as cb

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools")
Y_TOL = dict(rtol=1e-2, atol=1e-3)

torch.set_num_threads(1)


def _script(name):
    """A script of ``tools/`` imported by path (``exp_conv_bn2`` puts its
    own directory on ``sys.path`` to import its sibling)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return {n: _script(n) for n in ("exp_conv_bn", "exp_conv3x3",
                                    "exp_conv_bn2")}


def _inputs(seed, x_shape, C, w_shape, fan_in, b_pos=False):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal(x_shape).astype(np.float32)
    s = (rng.standard_normal(C) * 0.1 + 1).astype(np.float32)
    b = (rng.standard_normal(C) * 0.1).astype(np.float32)
    if b_pos:
        b = 0.5 + np.abs(b)
    w = (rng.standard_normal(w_shape) / np.sqrt(fan_in)).astype(np.float32)
    j = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(s), jnp.asarray(b),
         jnp.asarray(w, jnp.bfloat16))
    t = (torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(s),
         torch.from_numpy(b), torch.from_numpy(w).to(torch.bfloat16))
    return j, t


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _check_y(got, want):
    np.testing.assert_allclose(got.float().numpy(), _np(want), **Y_TOL)


def _check_stats(got, want):
    want = _np(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _interpret(fn, *args, **kwargs):
    with pltpu.force_tpu_interpret_mode():
        return fn(*args, **kwargs)


@pytest.mark.parametrize("M,K,N,bm,bn", [(256, 64, 128, 128, 128),
                                         (300, 64, 128, 128, 64),
                                         (200, 32, 64, 1024, 512)],
                         ids=["whole", "ragged", "clamped"])
def test_fused_conv1x1_bn_matches_jax(scripts, M, K, N, bm, bn):
    j, t = _inputs(M, (M, K), K, (K, N), K)
    yj, sj = _interpret(scripts["exp_conv_bn"].fused_conv1x1_bn, *j, bm=bm,
                        bn=bn)
    before = (cb.fused_conv1x1_bn.launches, cb.conv_bn_column_sum.launches)
    y, st = cb.fused_conv1x1_bn(*t, bm=bm, bn=bn)
    assert (cb.fused_conv1x1_bn.launches,
            cb.conv_bn_column_sum.launches) == before
    assert y.shape == (M, N) and y.dtype == torch.bfloat16
    assert st.shape == (2, N) and st.dtype == torch.float32
    _check_y(y, yj)
    _check_stats(st, sj)


@pytest.mark.parametrize("n,bn_blk,b_pos", [(2, 1, False), (2, 2, True),
                                            (4, 2, True)],
                         ids=["b-small", "b-pos", "b-pos-two-blocks"])
def test_fused3x3_matches_jax(scripts, n, bn_blk, b_pos):
    H, W, C, Co = 6, 8, 16, 32
    j, t = _inputs(7 + n, (n, H, W, C), C, (3, 3, C, Co), 9 * C, b_pos)
    yj, sj = _interpret(scripts["exp_conv3x3"].fused3x3, *j, bn_blk=bn_blk)
    y, st = cb.fused3x3(*t, bn_blk=bn_blk)
    assert y.shape == (n, H, W, Co) and y.is_contiguous()
    _check_y(y, yj)
    _check_stats(st, sj)


def test_fused3x3_pads_after_the_prologue():
    """A border output pixel sums only the taps inside the image: with
    b > 0, relu(0 * s + b) = b would add ``sum(w[tap] * b)`` for each
    outer tap if the prologue ran over the padding."""
    _, (x, s, b, w) = _inputs(3, (1, 3, 3, 8), 8, (3, 3, 8, 8), 72,
                              b_pos=True)
    y, _ = cb.fused3x3_plain(x, s, b, w)
    xn = torch.relu(x.float() * s + b).to(torch.bfloat16).float()
    wf = w.float()
    # output (0, 0) sees taps (1..2, 1..2) only
    want = sum(xn[0, di - 1, dj - 1] @ wf[di, dj]
               for di in (1, 2) for dj in (1, 2))
    np.testing.assert_allclose(y[0, 0, 0].float().numpy(), want.numpy(),
                               **Y_TOL)


@pytest.mark.parametrize("M,K,N", [(256, 64, 128), (512, 128, 64)])
def test_split_kernels_match_jax(scripts, M, K, N):
    mod = scripts["exp_conv_bn2"]
    j, t = _inputs(M + K, (M, K), K, (K, N), K)
    x, s, b, w = t
    ymm = _interpret(mod.run_mm, j[0], j[3], bm=128, bn=64)
    _check_y(cb.run_mm(x, w, bm=128, bn=64), ymm)
    ys, sj = _interpret(mod.run_mm, j[0], j[3], bm=128, bn=64,
                        kern=mod._k_stat, nstat=True)
    y, st = cb.run_mm(x, w, bm=128, bn=64, kern=cb._k_stat, nstat=True)
    _check_y(y, ys)
    _check_stats(st, sj)
    ypro = _interpret(mod.run_pro, *j, bm=128, bn=64)
    _check_y(cb.run_pro(x, s, b, w, bm=128, bn=64), ypro)


def test_refused_and_unwritten_shapes_raise(scripts):
    """Where the scripts assert (``run_mm``'s ``M % bm``, ``fused3x3``'s
    ``n % bn_blk`` and ``Co % bc``) or floor a grid (the column tiles of
    ``fused_conv1x1_bn`` and ``run_pro``, and ``run_pro``'s row tiles),
    the port raises ``ValueError``."""
    j, (x, s, b, w) = _inputs(0, (300, 32), 32, (32, 96), 32)
    with pytest.raises(AssertionError):
        _interpret(scripts["exp_conv_bn2"].run_mm, j[0], j[3], bm=128)
    with pytest.raises(ValueError, match="M = 300"):
        cb.run_mm(x, w, bm=128)
    with pytest.raises(ValueError, match="M = 300"):
        cb.run_pro(x, s, b, w, bm=128)
    with pytest.raises(ValueError, match="N = 96"):
        cb.fused_conv1x1_bn(x, s, b, w, bn=64)
    with pytest.raises(ValueError, match="N = 96"):
        cb.run_pro(x[:256], s, b, w, bm=128, bn=64)
    with pytest.raises(ValueError, match="kern"):
        cb.run_mm(x[:256], w, kern=cb._k_stat)
    j3, (x3, s3, b3, w3) = _inputs(1, (3, 4, 4, 8), 8, (3, 3, 8, 16), 72)
    with pytest.raises(AssertionError):
        _interpret(scripts["exp_conv3x3"].fused3x3, *j3, bn_blk=2)
    with pytest.raises(ValueError, match="n = 3"):
        cb.fused3x3(x3, s3, b3, w3, bn_blk=2)
    with pytest.raises(ValueError, match="Co = 16"):
        cb.fused3x3(x3, s3, b3, w3, bn_blk=1, bc=6)
    # tiles that divide the shape are taken
    assert cb.fused3x3(x3, s3, b3, w3, bn_blk=3, bc=8)[0].shape == (3, 4, 4,
                                                                    16)


def test_chains_match_jax_and_sum_the_rounded_y(scripts):
    """``chain_1x1`` / ``chain_3x3`` reproduce the scripts' ``xla_chain``
    (statistics of the rounded y), which differ from the kernels'
    statistics of the f32 accumulator by more than the kernels differ from
    the plain versions."""
    j, t = _inputs(5, (256, 64), 64, (64, 128), 64)
    yj, mj, vj = scripts["exp_conv_bn"].xla_chain(*j)
    y, m, v = cb.chain_1x1(*t)
    _check_y(y, yj)
    np.testing.assert_allclose(m.numpy(), _np(mj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(v.numpy(), _np(vj), rtol=1e-5, atol=1e-6)
    _, st = cb.fused_conv1x1_bn(*t)
    assert not torch.equal(st[0] / 256, m)

    j3, t3 = _inputs(6, (2, 8, 8, 16), 16, (3, 3, 16, 32), 144)
    yj, sj, qj = scripts["exp_conv3x3"].xla_chain(*j3)
    y, s_, q_ = cb.chain_3x3(*t3)
    _check_y(y, yj)
    np.testing.assert_allclose(s_.numpy(), _np(sj), rtol=1e-5,
                               atol=1e-5 * np.abs(_np(sj)).max())
    np.testing.assert_allclose(q_.numpy(), _np(qj), rtol=1e-5)
    _, kst = _interpret(scripts["exp_conv3x3"].fused3x3, *j3, bn_blk=2)
    _, pst = cb.fused3x3(*t3, bn_blk=2)
    gap_chain = np.abs(_np(kst)[0] - s_.numpy()).max()
    gap_plain = np.abs(_np(kst)[0] - pst[0].numpy()).max()
    assert gap_plain < gap_chain


def test_costs_count_the_product_and_each_byte_once():
    flops, nbytes = cb.conv1x1_cost(200704, 64, 256)
    assert flops == 2.0 * 200704 * 64 * 256
    assert nbytes == 2.0 * (200704 * 64 + 64 * 256 + 200704 * 256) \
        + 8.0 * 64 + 8.0 * 256
    assert cb.conv1x1_cost(8, 8, 8, prologue=False, stats=False)[1] == \
        2.0 * 3 * 64
    flops, nbytes = cb.conv3x3_cost(64, 56, 56, 64, 64)
    assert flops == 2.0 * 200704 * 576 * 64
    assert nbytes == 2.0 * (200704 * 64 + 576 * 64 + 200704 * 64) + 8.0 * 128
    # on the H100 (989 TFLOP/s bf16, 3.35 TB/s) stage 1's 3x3 sits near
    # the ridge at ~0.015 ms
    assert 1e3 * max(flops / 989e12, nbytes / 3.35e12) == pytest.approx(
        0.0153, abs=2e-4)


# the experiment scripts' shapes (chip_smoke.py phase 18): 1x1 (M, N) and
# 3x3 (n, H, W, C, Co)
_SCRIPT_1X1 = ((200704, 256), (200704, 64), (50176, 128), (50176, 512),
               (12544, 256), (12544, 1024), (3136, 512), (3136, 2048),
               (13312, 256), (12345, 64))
_SCRIPT_3X3 = ((64, 56, 56, 64, 64), (64, 28, 28, 128, 128),
               (64, 14, 14, 256, 256), (64, 7, 7, 512, 512),
               (8, 14, 14, 256, 256))


def _tiles_ok(plan, M, N, sms):
    """The plan's invariants: a wgmma instance, groups within the row
    tiles and, over the column tiles, within the card's blocks."""
    cdiv = lambda a, b: -(-a // b)  # noqa: E731
    assert (plan["bn"], plan["nwg"]) in ((64, 1), (64, 2), (128, 2),
                                         (256, 2))
    assert plan["bm"] == 64 * plan["nwg"]
    occ = 2 if plan["nwg"] == 1 else 1
    assert 1 <= plan["groups"] <= cdiv(M, plan["bm"])
    assert (plan["groups"] == 1
            or plan["groups"] * cdiv(N, plan["bn"]) <= occ * sms)


@pytest.mark.parametrize("sms", [132, 114])
def test_conv_plan_takes_wgmma_for_every_script_shape(sms):
    """Every 1x1 and every 3x3 of the scripts runs on the wgmma kernels;
    a 1x1 whose N fits one column tile applies the prologue in the
    kernel, the 3x3 and the wider 1x1 take the prologue pass; and the
    statistics' partials ``[2, groups, N]`` have the plan's groups."""
    for M, N in _SCRIPT_1X1:
        plan = cb.conv_plan(M, N, sms=sms)
        assert plan["route"] == "wgmma"
        _tiles_ok(plan, M, N, sms)
        assert plan["prologue"] == ("kernel" if N <= plan["bn"] else "pass")
        assert cb.conv_plan(M, N, sms=sms, prologue=False)["prologue"] is None
    for n, H, W, C, Co in _SCRIPT_3X3:
        plan = cb.conv_plan(n * H * W, Co, C, sms=sms)
        assert plan["route"] == "wgmma" and plan["prologue"] == "pass"
        _tiles_ok(plan, n * H * W, Co, sms)


def test_conv_plan_fills_the_card_with_wide_tiles():
    """The widest column tile that still leaves half the card's
    multiprocessors a tile; 64-row tiles (two blocks an SM) only where
    128 x 64 tiles would not."""
    assert cb.conv_plan(200704, 256)["bn"] == 256           # 1568 tiles
    assert cb.conv_plan(12544, 256)["bn"] == 256            # 98 >= 66
    p = cb.conv_plan(3136, 512)                             # 25 x 2 < 66
    assert (p["bm"], p["bn"], p["groups"]) == (128, 128, 25)
    p = cb.conv_plan(8 * 14 * 14, 256, 256)                 # 13 x 4 < 66
    assert (p["bm"], p["bn"], p["nwg"]) == (64, 64, 1)
    assert p["groups"] == 25                                 # 1568 / 64


@pytest.mark.parametrize("C", [8, 16, 40, 72, 200])
def test_conv_plan_keeps_mma_for_ragged_channels(C):
    """A 3x3 whose C is not a multiple of 64 (a 64-wide K slice would
    straddle two taps) takes the kept mma.sync kernel, by shape; its
    groups fill the card twice over the column tiles."""
    plan = cb.conv_plan(3 * 5 * 9, 40, C)
    assert plan["route"] == "mma" and plan["prologue"] is None
    assert (plan["bm"], plan["bn"], plan["groups"]) == (128, 64, 2)
    plan = cb.conv_plan(64 * 56 * 56, 256, C)
    assert plan["bn"] == 128
    assert plan["groups"] == 2 * 132 // 2
    assert cb.conv_plan(64 * 56 * 56, 256, C + 64 - C % 64)["route"] == \
        "wgmma"

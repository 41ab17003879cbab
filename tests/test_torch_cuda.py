"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Every test here is marked ``cuda`` and skips without a card; whether to
skip is decided in a fixture at run time, so every worker collects the
same tests.  This file imports no JAX (the machine with the card may
have none): ``python -m pytest -m cuda tests/test_torch_*.py`` runs it
there.  Tolerance 1e-4 in f32: the kernels sum in another order than
the plain f32 matmuls (TF32 off).  In bf16 both sides compute in f32 from
the same bf16 operands and round the result to bf16, so they differ by
about one bf16 rounding (2^-8 relative): rtol/atol 1e-2.  The case
builders are shared with ``test_torch_kernels.py`` and
``test_torch_train.py``.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import paged_attention as pa


@pytest.fixture
def cuda():
    """Decides at run time, never at collection: every worker collects
    the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the chip)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(B, Tq, Tk, H, D, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, Tq, H, D).astype(np.float32),
            rs.randn(B, Tk, H, D).astype(np.float32),
            rs.randn(B, Tk, H, D).astype(np.float32))


def _case(W, quant, seed=0):
    """The matrix of tests/test_paged_attention.py: 5 rows over P=8,
    n_pt=4 pools, lengths at a page start (0), a page boundary (8),
    mid-page (5, 13) and one parked row (virt) with an all-sentinel
    table."""
    rs = np.random.RandomState(seed)
    P, n_pt, H, D = 8, 4, 2, 32
    lengths = np.array([0, 5, 8, 13, n_pt * P], np.int32)
    B = len(lengths)
    NP = B * n_pt + 3
    perm = rs.permutation(NP - 1)
    pt = np.full((B, n_pt), NP, np.int32)
    for b, ln in enumerate(lengths[:-1]):
        need = -(-int(ln + W) // P)
        pt[b, :need] = perm[b * n_pt:b * n_pt + need]
    q = rs.randn(B, W, H, D).astype(np.float32)
    if quant:
        kp = rs.randint(-127, 128, (NP, P, H, D)).astype(np.int8)
        vp = rs.randint(-127, 128, (NP, P, H, D)).astype(np.int8)
        ks = (rs.rand(NP, P).astype(np.float32) + 0.1) / 127.0
        vs = (rs.rand(NP, P).astype(np.float32) + 0.1) / 127.0
        return q, kp, vp, pt, lengths, ks, vs
    kp = rs.randn(NP, P, H, D).astype(np.float32)
    vp = rs.randn(NP, P, H, D).astype(np.float32)
    return q, kp, vp, pt, lengths, None, None


def _on(dev, arrays):
    return [None if x is None else torch.from_numpy(x).to(dev)
            for x in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("tq,tk,causal", [(128, 128, True), (77, 77, True),
                                          (48, 200, True), (96, 96, False)])
def test_flash_kernel_matches_plain(cuda, tq, tk, causal):
    q, k, v = _on(cuda, _qkv(2, tq, tk, 4, 64, seed=tq))
    before = fa.flash_attention_bthd.launches
    out, lse = fa.flash_attention_bthd(q, k, v, causal=causal,
                                       return_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_attention_bthd.launches == before + 1
    ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                            return_lse=True)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("W", [1, 4])
def test_paged_kernel_matches_plain(cuda, W, quant):
    args = _on(cuda, _case(W, quant))
    before = pa.paged_decode_attention.launches
    out = pa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == before + 1
    ref = pa.paged_decode_attention_plain(*args)
    live = args[4] < args[3].shape[1] * args[1].shape[1]
    torch.testing.assert_close(out[live], ref[live], rtol=1e-4, atol=1e-4)


# (B, Tq, Tk, H, D), fused: the fused operand is self-attention (Tq == Tk)
_SELF = [(2, 128, 128, 12, 64), (2, 1024, 1024, 4, 64), (2, 1100, 1100, 3, 64)]
BWD_CASES = ([(s, True) for s in _SELF] +
             [(s, False) for s in _SELF + [(2, 64, 256, 4, 64)]])


def _bwd_case(B, Tq, Tk, H, D, fused, seed=0):
    """numpy operands of one backward: q, k, v (or one fused ``[B, T, H,
    3, D]`` qkv when ``fused``) and dO."""
    rs = np.random.RandomState(seed)
    if fused:
        qkv = rs.randn(B, Tq, H, 3, D).astype(np.float32)
        return qkv, rs.randn(B, Tq, H * D).astype(np.float32)
    q, k, v = _qkv(B, Tq, Tk, H, D, seed)
    return (q, k, v), rs.randn(B, Tq, H, D).astype(np.float32)


def _tols(dtype):
    return (dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32
            else dict(rtol=1e-2, atol=1e-2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("T", [128, 1100])
def test_fused_forward_matches_plain(cuda, dtype, T):
    """The fused forward reads the role views of one [B, T, nh, 3, hd]
    buffer in place (B > 1 and nh > 1, so an off-by-stride shows)."""
    qkv, _ = _bwd_case(2, T, T, 4, 64, fused=True, seed=T)
    qkv = torch.from_numpy(qkv).to(cuda, dtype)
    before = (fa.flash_attention_qkv_fused.launches,
              fa.flash_attention_bthd.launches)
    out, lse = fa._fused_fwd(qkv, True, 0.125)
    torch.cuda.synchronize()
    assert (fa.flash_attention_qkv_fused.launches,
            fa.flash_attention_bthd.launches) == (before[0] + 1, before[1])
    ref, ref_lse = fa.flash_attention_qkv_fused_plain(qkv, causal=True,
                                                      return_lse=True)
    assert out.shape == (2, T, 256) and out.dtype == dtype
    torch.testing.assert_close(out, ref, **_tols(dtype))
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize(
    "shape,fused", BWD_CASES,
    ids=["x".join(map(str, s)) + ("-fused" if f else "-separate")
         for s, f in BWD_CASES])
def test_backward_matches_plain(cuda, dtype, causal, fused, shape):
    B, Tq, Tk, H, D = shape
    ops, do = _bwd_case(*shape, fused=fused, seed=Tq + H)
    do = torch.from_numpy(do).to(cuda, dtype)
    if fused:
        qkv = torch.from_numpy(ops).to(cuda, dtype)
        out, lse = fa.flash_attention_qkv_fused_plain(
            qkv, causal=causal, return_lse=True)
        counter = fa.flash_attention_qkv_fused_bwd
        before = (counter.launches_dkv, counter.launches_dq)
        got = fa.flash_attention_qkv_fused_bwd(qkv, out, lse, do,
                                               causal=causal)
        torch.cuda.synchronize()
        want = fa.flash_attention_qkv_fused_bwd_plain(qkv, out, lse, do,
                                                      causal=causal)
        got, want = got.unbind(3), want.unbind(3)
    else:
        q, k, v = (torch.from_numpy(x).to(cuda, dtype) for x in ops)
        out, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                            return_lse=True)
        counter = fa.flash_attention_bwd
        before = (counter.launches_dkv, counter.launches_dq)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                            causal=causal)
    assert (counter.launches_dkv, counter.launches_dq) == (before[0] + 1,
                                                           before[1] + 1)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g, w, **_tols(dtype), msg=f"d{name}")


@pytest.mark.cuda
def test_backward_repeats_bitwise(cuda):
    """No atomics: two backward launches give identical gradients."""
    qkv, do = (torch.from_numpy(x).to(cuda)
               for x in _bwd_case(2, 300, 300, 4, 64, fused=True))
    out, lse = fa._fused_fwd(qkv, True, 0.125)
    one = fa.flash_attention_qkv_fused_bwd(qkv, out, lse, do)
    two = fa.flash_attention_qkv_fused_bwd(qkv, out, lse, do)
    assert torch.equal(one, two)


@pytest.mark.cuda
def test_kernels_refuse_a_strided_head_dim(cuda):
    q = torch.randn(1, 8, 2, 64, device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="unit-stride"):
        fa.flash_attention_bthd(q, q, q)


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda):
    """Three AdamW steps of gpt-tiny, f32, on the card (kernels) and on
    the CPU (plain versions) from the same weights: losses within 1e-4
    relative; 2 layers, so 2 launches a step of each kernel."""
    from paddle_tpu_torch.distributed import make_train_step
    from paddle_tpu_torch.models import (GPTPretrainingCriterion, build_gpt,
                                         load_jax_state, to_jax_state)
    from paddle_tpu_torch.optimizer import AdamW

    ids = np.random.RandomState(0).randint(0, 1024, (2, 129))
    losses = {}
    state = to_jax_state(build_gpt("gpt-tiny", device="cpu", seed=3))
    for dev in ("cpu", cuda):
        model = build_gpt("gpt-tiny", device=dev, hidden_dropout_prob=0.0,
                          attention_dropout_prob=0.0)
        load_jax_state(model, state)
        step = make_train_step(model, AdamW(1e-3, parameters=model),
                               loss_fn=GPTPretrainingCriterion())
        fwd0 = fa.flash_attention_qkv_fused.launches
        bwd0 = fa.flash_attention_qkv_fused_bwd.launches_dq
        losses[str(dev)] = [float(step(ids[:, :-1], ids[:, 1:]))
                            for _ in range(3)]
        n = 0 if dev == "cpu" else 6
        assert fa.flash_attention_qkv_fused.launches - fwd0 == n
        assert fa.flash_attention_qkv_fused_bwd.launches_dq - bwd0 == n
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)

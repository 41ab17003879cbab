"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Every test here is marked ``cuda`` and skips without a card; whether to
skip is decided in a fixture at run time, so every worker collects the
same tests.  This file imports no JAX (the machine with the card may
have none): ``python -m pytest -m cuda tests/test_torch_*.py`` runs it
there.  Tolerance 1e-4: the kernels sum in another order than the plain
f32 matmuls (TF32 off).  The case builders are shared with
``test_torch_kernels.py``.
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

"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Every test here is marked ``cuda`` and skips without a card; whether to
skip is decided in a fixture at run time, so every worker collects the
same tests.  This file imports no JAX (the machine with the card may
have none): ``python -m pytest -m cuda tests/test_torch_*.py`` runs it
there.  Tolerance 1e-4 in f32: the kernels sum in another order than
the plain f32 matmuls (TF32 off).  In bf16 both sides compute in f32 from
the same bf16 operands and round the result to bf16, so they differ by
about one bf16 rounding (2^-8 relative): rtol/atol 1e-2 (the tensor-core
kernels also round P and dS to bf16 before their products, as wgmma
takes them: a 2^-9 relative error a term, well inside it).  The case
builders are shared with ``test_torch_kernels.py`` and
``test_torch_train.py``.  The LayerNorm kernels' dw and db are f32 sums
over up to 1000 rows in another order than the plain version's: atol
1e-3 there.  The conv+BN kernels' statistics are f32 column sums of O(1)
values, over up to 20000 rows in the 1x1 cases: rtol 1e-5 and atol 1e-5
of the largest sum.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import conv_bn as cb
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import layer_norm as ln
from paddle_tpu_torch.kernels import ln_matmul as lnmm
from paddle_tpu_torch.kernels import paged_attention as pa

MAX_W = pa.MAX_W


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


def _paged_case(W, quant, lengths, n_pt=4, P=8, H=2, D=32, seed=0):
    """numpy operands of one paged read over pools of B * n_pt + 3 pages:
    row b at ``lengths[b]`` holds the pages its ``start + W`` positions
    need; a row at n_pt * P is parked, with an all-sentinel table."""
    rs = np.random.RandomState(seed)
    lengths = np.asarray(lengths, np.int32)
    B = len(lengths)
    NP = B * n_pt + 3
    perm = rs.permutation(NP - 1)
    pt = np.full((B, n_pt), NP, np.int32)
    for b, ln in enumerate(lengths):
        if ln < n_pt * P:
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


def _case(W, quant, seed=0, n_pt=4):
    """The matrix of tests/test_paged_attention.py: rows over P=8 pools,
    lengths at a page start (0), a page boundary (8), mid-page (5, 13)
    and one parked row (virt) with an all-sentinel table; with a 16-entry
    table also rows deep into it (64, 120)."""
    rows = [0, 5, 8, 13] + ([64, 120] if n_pt == 16 else [])
    return _paged_case(W, quant, rows + [n_pt * 8], n_pt=n_pt, seed=seed)


def _paged_check(args, n_launches=1):
    """The kernel's output on the card against the plain version's on
    the live rows (parked rows are never read), at 1e-4."""
    before = pa.paged_decode_attention.launches
    out = pa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == before + n_launches
    ref = pa.paged_decode_attention_plain(*args)
    live = args[4] < args[3].shape[1] * args[1].shape[1]
    torch.testing.assert_close(out[live], ref[live], rtol=1e-4, atol=1e-4)
    return out


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


def _boundary_rows(W, D, n_pt=32, P=8, H=2):
    """Rows whose live span ends on a chunk boundary of the kernel's plan,
    one position past it, starts on one, and a first and a parked row."""
    c = pa.paged_plan(1, W, H, D, P, n_pt)["chunk"]
    assert 2 * c + MAX_W <= n_pt * P
    return [c - W, c - W + 1, c, 2 * c - W, 2 * c - W + 1, 0, n_pt * P]


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("W", [1, 4, 8])
def test_paged_kernel_matches_plain(cuda, W, D, quant):
    _paged_check(_on(cuda, _case(W, quant)) if D == 32 else _on(
        cuda, _case(W, quant, n_pt=16)) if D == 64 else _on(
        cuda, _paged_case(W, quant, [0, 5, 8, 13, 32], D=D)))
    # live spans ending on, and one past, the plan's chunk boundaries
    _paged_check(_on(cuda, _paged_case(
        W, quant, _boundary_rows(W, D), n_pt=32, D=D, seed=W + D)))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_kernel_all_parked(cuda, quant):
    """A batch of idle slots reads nothing and writes zeros."""
    out = _paged_check(_on(cuda, _paged_case(4, quant, [32, 32, 32])))
    assert not out.any()


@pytest.mark.cuda
def test_paged_kernel_wide_table(cuda):
    """The table the whole-row kernel refused (W=8, 1024 entries of 16
    positions) and a second row of 4096 positions."""
    _paged_check(_on(cuda, _paged_case(8, False, [16376, 4095, 16384],
                                       n_pt=1024, P=16, seed=1)))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_kernel_repeats_bitwise(cuda, quant):
    args = _on(cuda, _paged_case(4, quant, _boundary_rows(4, 64),
                                 n_pt=32, D=64))
    a = pa.paged_decode_attention(*args)
    b = pa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_paged_launch_does_not_sync(cuda):
    args = _on(cuda, _case(4, True, n_pt=16))
    pa.paged_decode_attention(*args)         # builds and loads first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pa.paged_decode_attention(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_kernel_in_cuda_graph(cuda, quant):
    """Captured once and replayed, the read equals the eager call's; new
    lengths written into the captured tensor are read at replay."""
    args = _on(cuda, _case(4, quant, n_pt=16))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pa.paged_decode_attention(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pa.paged_decode_attention(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, pa.paged_decode_attention(*args))
    args[4].copy_(torch.tensor([1, 6, 9, 14, 60, 100, 128],
                               dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, pa.paged_decode_attention(*args))


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


# -- the bf16 tensor-core flash kernels (wgmma + TMA) --------------------------

# (B, Tq, Tk, H, D, fused): head sizes 32, 64, 128; ragged T (77, 1100);
# Tq < Tk and Tq > Tk (separate operands); the fused role views; one long
# sequence
BF16_CASES = [(2, 128, 128, 4, 32, False), (2, 128, 128, 4, 64, False),
              (2, 128, 128, 4, 128, False), (2, 77, 77, 2, 64, False),
              (2, 77, 77, 3, 32, True), (2, 1100, 1100, 3, 64, True),
              (2, 1100, 1100, 2, 128, False), (2, 300, 300, 4, 128, True),
              (2, 64, 256, 4, 64, False), (2, 256, 64, 4, 64, False),
              (2, 200, 72, 2, 32, False), (1, 4096, 4096, 2, 64, True)]
BF16_IDS = ["x".join(map(str, c[:5])) + ("-fused" if c[5] else "-separate")
            for c in BF16_CASES]


def _bf16_operands(cuda, B, Tq, Tk, H, D, fused, seed):
    """bf16 q, k, v (role views of one fused buffer when ``fused``) and a
    dO of q's shape, from a numpy seed."""
    if fused:
        qkv, do = _bwd_case(B, Tq, Tk, H, D, fused=True, seed=seed)
        qkv = torch.from_numpy(qkv).to(cuda, torch.bfloat16)
        do = torch.from_numpy(do).to(cuda, torch.bfloat16)
        return (*fa._split_qkv(qkv), do.view(B, Tq, H, D), qkv)
    (q, k, v), do = _bwd_case(B, Tq, Tk, H, D, fused=False, seed=seed)
    return (*(torch.from_numpy(x).to(cuda, torch.bfloat16)
              for x in (q, k, v, do)), None)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("case", BF16_CASES, ids=BF16_IDS)
def test_bf16_forward_matches_plain(cuda, case, causal):
    """Every row within a bf16 rounding of the plain version (lse within
    1e-4: f32 from the same bf16 operands), the causal rows with no live
    key (Tq > Tk) included: both give the reference's result there."""
    B, Tq, Tk, H, D, fused = case
    q, k, v, _, qkv = _bf16_operands(cuda, *case, seed=Tq + D)
    counter = fa.flash_attention_qkv_fused if fused else fa.flash_attention_bthd
    before = counter.launches
    if fused:
        out, lse = fa._fused_fwd(qkv, causal, D ** -0.5)
        out = out.view(B, Tq, H, D)
    else:
        out, lse = fa.flash_attention_bthd(q, k, v, causal=causal,
                                           return_lse=True)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                            return_lse=True)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, ref, **_tols(torch.bfloat16))
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("case", BF16_CASES, ids=BF16_IDS)
def test_bf16_backward_matches_plain(cuda, case, causal):
    """dq, dk, dv of the bf16 kernels (delta, dk/dv, dq: one launch each)
    within a bf16 rounding of the plain backward from the same out and
    lse, the causal rows with no live key (Tq > Tk) included."""
    B, Tq, Tk, H, D, fused = case
    q, k, v, do, qkv = _bf16_operands(cuda, *case, seed=Tq + H)
    out, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                        return_lse=True)
    counter = fa.flash_attention_qkv_fused_bwd if fused else \
        fa.flash_attention_bwd
    before = (counter.launches_delta, counter.launches_dkv,
              counter.launches_dq)
    if fused:
        got = fa.flash_attention_qkv_fused_bwd(
            qkv, out.reshape(B, Tq, H * D), lse, do.reshape(B, Tq, H * D),
            causal=causal).unbind(3)
    else:
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert (counter.launches_delta, counter.launches_dkv,
            counter.launches_dq) == tuple(n + 1 for n in before)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                        causal=causal)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g, w, **_tols(torch.bfloat16),
                                   msg=f"d{name}")


@pytest.mark.cuda
def test_bf16_backward_repeats_bitwise(cuda):
    """No atomics in the bf16 kernels either: two launches give identical
    gradients."""
    qkv, do = _bwd_case(2, 300, 300, 4, 64, fused=True)
    qkv, do = (torch.from_numpy(x).to(cuda, torch.bfloat16)
               for x in (qkv, do))
    out, lse = fa._fused_fwd(qkv, True, 0.125)
    one = fa.flash_attention_qkv_fused_bwd(qkv, out, lse, do)
    two = fa.flash_attention_qkv_fused_bwd(qkv, out, lse, do)
    assert torch.equal(one, two)


# causal Tq > Tk at the reference's tile boundaries (test_torch_kernels.py
# holds the plain versions to the JAX package at the same shapes)
DEAD_CASES = [(200, 120), (1100, 600), (2100, 1000), (3100, 1100)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("tq,tk", DEAD_CASES,
                         ids=[f"{a}x{b}" for a, b in DEAD_CASES])
def test_dead_causal_rows_match_plain(cuda, dtype, tq, tk):
    """The rows i < Tq - Tk (no live key): the forward's out and lse and
    the backward's dq, dk, dv against the plain versions, which give the
    reference's result there; one launch of the dead-row pass each way.
    f32 at 1e-4; bf16 at one bf16 rounding (1e-2), lse at 1e-4."""
    B, H, D = 1, 2, 64
    q, k, v = (torch.from_numpy(x).to(cuda, dtype)
               for x in _qkv(B, tq, tk, H, D, seed=tq))
    do = torch.from_numpy(np.random.RandomState(tk).randn(
        B, tq, H, D).astype(np.float32)).to(cuda, dtype)
    before = (fa.flash_attention_bthd.launches_dead,
              fa.flash_attention_bwd.launches_dead)
    out, lse = fa.flash_attention_bthd(q, k, v, causal=True, return_lse=True)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bthd.launches_dead,
            fa.flash_attention_bwd.launches_dead) == (before[0] + 1,
                                                      before[1] + 1)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=True,
                                            return_lse=True)
    torch.testing.assert_close(out, ref, **_tols(dtype))
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=True)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g, w, **_tols(dtype), msg=f"d{name}")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bhtd", "one-head"])
def test_bf16_kernels_read_any_stride_order(cuda, layout):
    """The tensor maps order the outer dims by stride: q, k, v and dO
    viewed from [B, H, T, D] buffers (the sequence stride below the head
    stride), and B = H = 1 (size-1 dims), match the plain versions
    forward and backward."""
    B, T, H, D = (2, 200, 3, 64) if layout == "bhtd" else (1, 200, 1, 64)
    rs = np.random.RandomState(7)
    q, k, v, do = (torch.from_numpy(rs.randn(B, H, T, D).astype(np.float32))
                   .to(cuda, torch.bfloat16).transpose(1, 2)
                   for _ in range(4))
    out, lse = fa.flash_attention_bthd(q, k, v, causal=True, return_lse=True)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=True,
                                            return_lse=True)
    torch.testing.assert_close(out, ref, **_tols(torch.bfloat16))
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)
    got = fa.flash_attention_bwd(q, k, v, ref, ref_lse, do, causal=True)
    want = fa.flash_attention_bwd_plain(q, k, v, ref, ref_lse, do,
                                        causal=True)
    for name, g, w in zip("qkv", got, want):
        torch.testing.assert_close(g, w, **_tols(torch.bfloat16),
                                   msg=f"d{name}")


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["base", "head-stride"])
def test_bf16_kernels_refuse_a_misaligned_operand(cuda, how):
    """TMA reads 16-byte aligned tiles: a bf16 operand whose base address
    or head stride is not a multiple of 16 bytes raises before a launch
    (an f32 operand has no such rule)."""
    B, T, H, D = 2, 64, 2, 64

    def layout(dtype):
        if how == "base":
            x = torch.randn(B * T * H * D + 1, device=cuda).to(dtype)
            return x[1:].view(B, T, H, D)
        return torch.randn(B, T, H, D + 4, device=cuda).to(dtype)[..., :D]

    q = layout(torch.bfloat16)
    match = "base address" if how == "base" else "head stride"
    k = torch.randn(B, T, H, D, device=cuda).to(torch.bfloat16)
    before = (fa.flash_attention_bthd.launches,
              fa.flash_attention_bwd.launches_delta)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_bthd(q, k, k)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_bwd(q, k, k, k, torch.zeros(B * H, T, 1,
                                                       device=cuda), k)
    assert (fa.flash_attention_bthd.launches,
            fa.flash_attention_bwd.launches_delta) == before
    q32, k32 = layout(torch.float32), k.float()
    out = fa.flash_attention_bthd(q32, k32, k32)
    torch.testing.assert_close(out, fa.flash_attention_plain(q32, k32, k32),
                               rtol=1e-4, atol=1e-4)


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


# -- the LayerNorm kernels -----------------------------------------------------

def _ln_inputs(cuda, N, C, dtype, seed=0):
    rs = np.random.RandomState(seed)
    x, dy = (torch.from_numpy(rs.randn(N, C).astype(np.float32))
             .to(cuda, dtype) for _ in range(2))
    w, b = (torch.from_numpy(rs.randn(C).astype(np.float32)).to(cuda, dtype)
            for _ in range(2))
    return x, w, b, dy


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("N,C", [(8, 768), (185, 128), (1000, 768),
                                 (300, 1024)])
def test_layer_norm_kernels_match_plain(cuda, dtype, N, C):
    """Ragged N (not a multiple of a block's rows), the decode rows (8),
    C below a lane round (128 in bf16) and above the main path's."""
    x, w, b, dy = _ln_inputs(cuda, N, C, dtype, seed=N)
    counter = ln.layer_norm_fused
    before = (counter.launches_fwd, counter.launches_bwd,
              counter.launches_bwd_reduce)
    y, mu, rs = ln.layer_norm_fwd(x, w, b, 1e-5)
    dx, dw, db = ln.layer_norm_bwd(x, w, mu, rs, dy)
    torch.cuda.synchronize()
    assert (counter.launches_fwd, counter.launches_bwd,
            counter.launches_bwd_reduce) == tuple(n + 1 for n in before)
    y_p, mu_p, rs_p = ln.layer_norm_fwd_plain(x, w, b, 1e-5)
    dx_p, dw_p, db_p = ln.layer_norm_bwd_plain(x, w, mu_p, rs_p, dy)
    assert y.dtype == dx.dtype == dtype and dw.dtype == torch.float32
    torch.testing.assert_close(y, y_p, **_tols(dtype))
    torch.testing.assert_close(mu, mu_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(rs, rs_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dx, dx_p, **_tols(dtype))
    torch.testing.assert_close(dw, dw_p, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(db, db_p, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_layer_norm_backward_repeats_bitwise(cuda):
    """No atomics: two backward runs give identical dx, dw and db."""
    x, w, b, dy = _ln_inputs(cuda, 16384, 768, torch.bfloat16)
    _, mu, rs = ln.layer_norm_fwd(x, w, b, 1e-5)
    one = ln.layer_norm_bwd(x, w, mu, rs, dy)
    two = ln.layer_norm_bwd(x, w, mu, rs, dy)
    assert all(torch.equal(a, c) for a, c in zip(one, two))


@pytest.mark.cuda
@pytest.mark.parametrize("C,dtype", [(1280, torch.float32),
                                     (2560, torch.bfloat16),
                                     (4096, torch.float32),
                                     (8192, torch.bfloat16)],
                         ids=["1280-f32", "2560-bf16", "4096-f32",
                              "8192-bf16"])
def test_layer_norm_wide_rows_match_plain(cuda, C, dtype):
    """Rows wider than a lane's registers hold (C > 1024 in f32, > 2048
    in bf16: GPT-2-large's 1280 and wider) run the wide kernels; ragged N.
    Tolerances as the register path's, dw and db at atol 1e-3 of 300
    rows."""
    x, w, b, dy = _ln_inputs(cuda, 300, C, dtype, seed=C)
    before = (ln.layer_norm_fused.launches_fwd,
              ln.layer_norm_fused.launches_bwd)
    y, mu, rs = ln.layer_norm_fwd(x, w, b, 1e-5)
    dx, dw, db = ln.layer_norm_bwd(x, w, mu, rs, dy)
    torch.cuda.synchronize()
    assert (ln.layer_norm_fused.launches_fwd,
            ln.layer_norm_fused.launches_bwd) == (before[0] + 1,
                                                  before[1] + 1)
    y_p, mu_p, rs_p = ln.layer_norm_fwd_plain(x, w, b, 1e-5)
    dx_p, dw_p, db_p = ln.layer_norm_bwd_plain(x, w, mu_p, rs_p, dy)
    torch.testing.assert_close(y, y_p, **_tols(dtype))
    torch.testing.assert_close(mu, mu_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(rs, rs_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dx, dx_p, **_tols(dtype))
    torch.testing.assert_close(dw, dw_p, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(db, db_p, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [768, 2560])
def test_layer_norm_backward_takes_f32_dy(cuda, C):
    """bf16 x with an f32 dy (the ``ln_matmul`` backward's dxln): dx in
    x's type, against the plain backward on the same f32 dy."""
    x, w, b, _ = _ln_inputs(cuda, 1000, C, torch.bfloat16, seed=C + 1)
    dy = torch.randn(1000, C, device=cuda)
    _, mu, rs = ln.layer_norm_fwd(x, w, b, 1e-5)
    dx, dw, db = ln.layer_norm_bwd(x, w, mu, rs, dy)
    torch.cuda.synchronize()
    dx_p, dw_p, db_p = ln.layer_norm_bwd_plain(x, w, mu, rs, dy)
    assert dx.dtype == torch.bfloat16
    torch.testing.assert_close(dx, dx_p, **_tols(torch.bfloat16))
    torch.testing.assert_close(dw, dw_p, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(db, db_p, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["full", "bwd"])
def test_layer_norm_fused_autograd_on_card(cuda, mode):
    x, w, b, dy = _ln_inputs(cuda, 300, 256, torch.float32, seed=1)
    ts = [t.clone().requires_grad_() for t in (x, w, b)]
    ln.enable_fused_layernorm(mode)
    try:
        before = ln.layer_norm_fused.launches_fwd
        ln.layer_norm_fused(*ts, 1e-5).backward(dy)
        assert ln.layer_norm_fused.launches_fwd - before == int(mode == "full")
    finally:
        ln.enable_fused_layernorm(False)
    refs = [t.clone().requires_grad_() for t in (x, w, b)]
    torch.nn.functional.layer_norm(refs[0], (256,), refs[1], refs[2],
                                   1e-5).backward(dy)
    for t, r in zip(ts, refs):
        torch.testing.assert_close(t.grad, r.grad, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("N,K,M", [(8, 768, 3072), (300, 256, 200),
                                   (1000, 768, 2304), (77, 128, 100)])
def test_ln_matmul_kernel_matches_plain(cuda, dtype, N, K, M):
    """Ragged N, M (200: vector stores stop short; 100: scalar edge) and
    the GPT widths, against the plain version on the same operands.  The
    scales are a layer's (g ~ 1, b ~ 0, W ~ 1/sqrt(K)), so outputs are
    O(1): in bf16 a normalised row's element may round the other way (the
    statistics differ in their last bits), which moves an output by about
    2^-8 |W| -- inside the one-rounding tolerance at this scale."""
    rs = np.random.RandomState(N + M)

    def dev(a):
        return torch.from_numpy(a.astype(np.float32)).to(cuda, dtype)

    x = dev(rs.randn(N, K))
    w = dev(rs.randn(M, K) / np.sqrt(K))
    g, b = dev(1 + 0.1 * rs.randn(K)), dev(0.1 * rs.randn(K))
    before = lnmm.ln_matmul.launches
    got = lnmm.ln_matmul(x, g, b, w)
    torch.cuda.synchronize()
    assert lnmm.ln_matmul.launches == before + 1
    want = lnmm.ln_matmul_plain(x, g, b, w, 1e-5)
    assert got.shape == (N, M) and got.dtype == dtype
    torch.testing.assert_close(got, want, **_tols(dtype))


def _lnmm_operands(cuda, N, K, M, seed):
    """bf16 x, W ~ 1/sqrt(K) and g ~ 1, b ~ 0 at a layer's scales."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(N, K, device=cuda, generator=gen).bfloat16()
    w = (torch.randn(M, K, device=cuda, generator=gen) / K ** 0.5).bfloat16()
    g = (1 + 0.1 * torch.randn(K, device=cuda, generator=gen)).bfloat16()
    b = (0.1 * torch.randn(K, device=cuda, generator=gen)).bfloat16()
    return x, g, b, w


@pytest.mark.cuda
@pytest.mark.parametrize("N,K,M", [(16384, 768, 2304), (16384, 768, 3072),
                                   (4096, 1280, 3840), (2048, 1024, 4096)],
                         ids=["qkv", "fc0", "1280", "1024"])
def test_ln_matmul_kernel_matches_plain_at_model_shapes(cuda, N, K, M):
    """The bf16 wgmma kernel at GPT-2-small's two projections and at the
    widths 1024 and 1280: within one bf16 rounding of the plain version."""
    x, g, b, w = _lnmm_operands(cuda, N, K, M, seed=K + M)
    got = lnmm.ln_matmul(x, g, b, w)
    torch.cuda.synchronize()
    want = lnmm.ln_matmul_plain(x, g, b, w, 1e-5)
    torch.testing.assert_close(got, want, **_tols(torch.bfloat16))


@pytest.mark.cuda
def test_ln_matmul_backward_runs_on_the_layernorm_kernels(cuda):
    """At the qkv shape in bf16: the backward launches the LayerNorm
    forward (xln) and backward (dx, dgamma, dbeta from an f32 dxln) once
    each, and agrees with the plain chain in f32 torch ops (the
    reference's ``_bwd``): dx within one bf16 rounding, dgamma and dbeta
    (f32 sums of 16384 rows) within 1e-4 (1 + max).  dW is held against
    the f32 product over the kernel's own xln (one bf16 rounding): an
    element of xln from other statistics bits may round the other way,
    which moves a dW element by ~2^-8 |dy| -- more than 1e-2 near 0."""
    N, K, M = 16384, 768, 2304
    x, g, b, w = _lnmm_operands(cuda, N, K, M, seed=7)
    g, b = g.float(), b.float()
    dy = torch.randn(N, M, device=cuda).bfloat16()
    ts = [t.clone().requires_grad_() for t in (x, g, b, w)]
    before = (ln.layer_norm_fused.launches_fwd,
              ln.layer_norm_fused.launches_bwd)
    lnmm.ln_matmul(*ts).backward(dy)
    torch.cuda.synchronize()
    assert (ln.layer_norm_fused.launches_fwd,
            ln.layer_norm_fused.launches_bwd) == (before[0] + 1,
                                                  before[1] + 1)
    xf = x.float()
    mu = xf.mean(1, keepdim=True)
    rs = torch.rsqrt(((xf - mu) ** 2).mean(1, keepdim=True) + 1e-5)
    xhat = (xf - mu) * rs
    xln = ln.layer_norm_fwd(x, g, b, 1e-5)[0]
    dw = (dy.float().t() @ xln.float()).bfloat16()
    dxln = dy.float() @ w.float()
    gg = dxln * g
    dx = (rs * (gg - gg.mean(1, keepdim=True)
                - xhat * (gg * xhat).mean(1, keepdim=True))).bfloat16()
    for name, t, want in (("dx", ts[0], dx), ("dW", ts[3], dw)):
        torch.testing.assert_close(t.grad, want, **_tols(torch.bfloat16),
                                   msg=name)
    for name, t, want in (("dgamma", ts[1], (dxln * xhat).sum(0)),
                          ("dbeta", ts[2], dxln.sum(0))):
        tol = 1e-4 * (1 + float(want.abs().max()))
        assert float((t.grad - want).abs().max()) <= tol, name


@pytest.mark.cuda
def test_ln_matmul_reads_the_weight_in_place(cuda):
    """The [M, K] weight goes in as it is: its storage is untouched and
    the call allocates no M x K buffer (only the [N, M] output)."""
    M, K, N = 3072, 768, 8
    w = torch.randn(M, K, device=cuda, dtype=torch.bfloat16)
    x = torch.randn(N, K, device=cuda, dtype=torch.bfloat16)
    g = torch.ones(K, device=cuda, dtype=torch.bfloat16)
    b = torch.zeros(K, device=cuda, dtype=torch.bfloat16)
    ptr = w.data_ptr()
    lnmm.ln_matmul(x, g, b, w)           # the first call builds the library
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = lnmm.ln_matmul(x, g, b, w)
    torch.cuda.synchronize()
    assert w.data_ptr() == ptr
    assert torch.cuda.max_memory_allocated() - base < M * K * 2 // 4
    assert out.shape == (N, M)


@pytest.mark.cuda
def test_fused_ln_train_step_on_card_matches_cpu(cuda):
    """Three AdamW steps of gpt-tiny, f32, both toggles on (LN "full"), on
    the card (kernels) and on the CPU (plain versions) from the same
    weights: losses within 1e-4 relative; 2 layers, so 4 ln_matmul
    launches and 5 LayerNorm forwards and backwards a step (one of each in
    every ln_matmul backward, and the final norm's)."""
    from paddle_tpu_torch.distributed import make_train_step
    from paddle_tpu_torch.models import (GPTPretrainingCriterion, build_gpt,
                                         load_jax_state, to_jax_state)
    from paddle_tpu_torch.optimizer import AdamW

    ids = np.random.RandomState(1).randint(0, 1024, (2, 129))
    state = to_jax_state(build_gpt("gpt-tiny", device="cpu", seed=4))
    losses = {}
    ln.enable_fused_layernorm("full")
    lnmm.enable_ln_matmul(True)
    try:
        for dev in ("cpu", cuda):
            model = build_gpt("gpt-tiny", device=dev, hidden_dropout_prob=0.0,
                              attention_dropout_prob=0.0)
            load_jax_state(model, state)
            step = make_train_step(model, AdamW(1e-3, parameters=model),
                                   loss_fn=GPTPretrainingCriterion())
            n0 = (lnmm.ln_matmul.launches, ln.layer_norm_fused.launches_fwd,
                  ln.layer_norm_fused.launches_bwd)
            losses[str(dev)] = [float(step(ids[:, :-1], ids[:, 1:]))
                                for _ in range(3)]
            n1 = (lnmm.ln_matmul.launches, ln.layer_norm_fused.launches_fwd,
                  ln.layer_norm_fused.launches_bwd)
            want = (0, 0, 0) if dev == "cpu" else (12, 15, 15)
            assert tuple(b - a for a, b in zip(n0, n1)) == want
    finally:
        ln.enable_fused_layernorm(False)
        lnmm.enable_ln_matmul(False)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


# -- the conv+BN experiment kernels (rows 11-13) --------------------------------

def _conv_case(cuda, x_shape, C, w_shape, fan_in, seed, b_pos=False):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(*x_shape).astype(np.float32))
    s = torch.from_numpy((1 + 0.1 * rs.randn(C)).astype(np.float32))
    b = torch.from_numpy((0.1 * rs.randn(C)).astype(np.float32))
    if b_pos:
        b = 0.5 + b.abs()
    w = torch.from_numpy((rs.randn(*w_shape) / np.sqrt(fan_in)).astype(
        np.float32))
    return (x.to(cuda, torch.bfloat16), s.to(cuda), b.to(cuda),
            w.to(cuda, torch.bfloat16))


def _close_stats(got, want):
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(1024, 64, 256), (3000, 256, 64),
                                   (77, 512, 136), (256, 2048, 512),
                                   (20000, 64, 64), (20000, 128, 128),
                                   (20000, 64, 256), (20000, 64, 136)])
def test_conv1x1_kernels_match_plain(cuda, M, K, N):
    """Every 1x1 body (``_kernel``, ``_k_mm``, ``_k_stat``, ``_k_pro``) at
    a ragged M (3000, 77, 20000: not a multiple of 64 or 128), a ragged N
    (136: a partial column tile) and the scripts' channel counts, over
    the wgmma kernel's tile instances (``conv_plan``); one launch each
    (each ``run_mm`` body on its own counter, all on the wgmma route),
    plus one column sum under the statistics."""
    x, s, b, w = _conv_case(cuda, (M, K), K, (K, N), K, seed=M + N)
    w0 = cb.run_mm.launches_wgmma
    n0 = (cb.fused_conv1x1_bn.launches, cb.run_mm.launches,
          cb.run_mm.launches_mm, cb.run_mm.launches_stat,
          cb.run_pro.launches, cb.conv_bn_column_sum.launches)
    y, st = cb.fused_conv1x1_bn(x, s, b, w, bn=N)
    yp, stp = cb.fused_conv1x1_bn_plain(x, s, b, w)
    torch.testing.assert_close(y, yp, **_tols(torch.bfloat16))
    _close_stats(st, stp)
    torch.testing.assert_close(cb.run_pro(x, s, b, w, bm=M, bn=N),
                               cb.run_pro_plain(x, s, b, w),
                               **_tols(torch.bfloat16))
    torch.testing.assert_close(cb.run_mm(x, w, bm=M, bn=N),
                               cb.run_mm_plain(x, w), **_tols(torch.bfloat16))
    ym, stm = cb.run_mm(x, w, bm=M, bn=N, kern=cb._k_stat, nstat=True)
    ymp, stmp = cb.run_mm_plain(x, w, stats=True)
    torch.testing.assert_close(ym, ymp, **_tols(torch.bfloat16))
    _close_stats(stm, stmp)
    torch.cuda.synchronize()
    n1 = (cb.fused_conv1x1_bn.launches, cb.run_mm.launches,
          cb.run_mm.launches_mm, cb.run_mm.launches_stat,
          cb.run_pro.launches, cb.conv_bn_column_sum.launches)
    assert tuple(b_ - a for a, b_ in zip(n0, n1)) == (1, 2, 1, 1, 1, 2)
    assert cb.run_mm.launches_wgmma - w0 == 2


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(300, 200, 64), (20000, 200, 128),
                                   (20000, 72, 256), (300, 2120, 64),
                                   (20000, 200, 512)])
def test_conv1x1_prologue_reads_zero_past_the_edges(cuda, M, K, N):
    """b > 0, so relu(0 * s + b) > 0: the rows past M and the columns
    past K (K = 200, 72, 2120: not a multiple of the 64-wide K slice)
    that TMA fills with zeros must stay 0 after the prologue, in y and in
    the statistics; in the kernel (one column tile; K = 2120 reads s and
    b where they lie) and through the prologue pass (N = 512)."""
    x, s, b, w = _conv_case(cuda, (M, K), K, (K, N), K, seed=K + N,
                            b_pos=True)
    y, st = cb.fused_conv1x1_bn(x, s, b, w, bn=N)
    yp, stp = cb.fused_conv1x1_bn_plain(x, s, b, w)
    torch.testing.assert_close(y, yp, **_tols(torch.bfloat16))
    _close_stats(st, stp)
    torch.testing.assert_close(cb.run_pro(x, s, b, w, bm=M, bn=N),
                               cb.run_pro_plain(x, s, b, w),
                               **_tols(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("n,H,W,C,Co,b_pos", [
    (2, 56, 56, 64, 64, False), (4, 7, 7, 512, 512, False),
    (3, 5, 9, 16, 40, True), (2, 14, 14, 256, 256, True),
    (8, 14, 14, 256, 256, True), (64, 7, 7, 512, 512, True),
    (32, 28, 28, 128, 128, False), (24, 28, 28, 64, 256, True),
    (3, 5, 9, 64, 40, True)])
def test_fused3x3_kernel_matches_plain(cuda, n, H, W, C, Co, b_pos):
    """The implicit-GEMM 3x3 at the scripts' widths, Co = 64 at 56^2, the
    small-M n = 8 14^2 and the 7^2 shape, over the wgmma kernel's tile
    instances, and small ragged images (5 x 9, Co = 40; C = 16 takes the
    kept mma.sync kernel); b > 0 holds the zero padding after the
    prologue at the border and past the last row."""
    x, s, b, w = _conv_case(cuda, (n, H, W, C), C, (3, 3, C, Co), 9 * C,
                            seed=H * C, b_pos=b_pos)
    before = cb.fused3x3.launches
    y, st = cb.fused3x3(x, s, b, w, bn_blk=1)
    torch.cuda.synchronize()
    assert cb.fused3x3.launches == before + 1
    yp, stp = cb.fused3x3_plain(x, s, b, w)
    assert y.shape == (n, H, W, Co) and y.is_contiguous()
    torch.testing.assert_close(y, yp, **_tols(torch.bfloat16))
    _close_stats(st, stp)


@pytest.mark.cuda
def test_conv_bn_statistics_repeat_bitwise(cuda):
    """No atomics: two launches give the same bits, y and statistics, on
    each kernel: conv1x1_wgmma (the fused body and ``_k_stat``),
    conv3x3_wgmma and the kept mma.sync 3x3."""
    x, s, b, w = _conv_case(cuda, (50176, 128), 128, (128, 512), 128, seed=3)
    for call in (lambda: cb.fused_conv1x1_bn(x, s, b, w),
                 lambda: cb.run_mm(x, w, bm=50176, kern=cb._k_stat,
                                   nstat=True)):
        first, second = call(), call()
        for a, b_ in zip(first, second):
            assert torch.equal(a, b_)
    for shape, C, Co in (((8, 28, 28, 128), 128, 128),
                         ((3, 5, 9, 16), 16, 40)):
        x3, s3, b3, w3 = _conv_case(cuda, shape, C, (3, 3, C, Co), 9 * C,
                                    seed=4)
        first = cb.fused3x3(x3, s3, b3, w3, bn_blk=1)
        second = cb.fused3x3(x3, s3, b3, w3, bn_blk=1)
        for a, b_ in zip(first, second):
            assert torch.equal(a, b_)


# the experiment scripts' shapes (chip_smoke.py phase 18)
_SCRIPT_1X1 = ((200704, 64, 256), (200704, 256, 64), (50176, 512, 128),
               (50176, 128, 512), (12544, 1024, 256), (12544, 256, 1024),
               (3136, 2048, 512), (3136, 512, 2048), (13312, 1024, 256))
_SCRIPT_3X3 = ((64, 56, 56, 64, 64), (64, 28, 28, 128, 128),
               (64, 14, 14, 256, 256), (64, 7, 7, 512, 512),
               (8, 14, 14, 256, 256))


@pytest.mark.cuda
def test_conv_bn_routes_by_shape(cuda, monkeypatch):
    """Every script shape launches the wgmma kernels, each launch on its
    route's counter, after one prologue pass where the plan takes one;
    the ragged (3, 5, 9, 16, 40) launches the kept mma.sync 3x3.  The
    statistics' partials have the plan's ``groups`` rows."""
    seen = []
    column_sum = cb.conv_bn_column_sum

    def spy(part):
        seen.append(tuple(part.shape))
        return column_sum(part)
    # the wrapper counts its launches on the module's name: the spy's
    spy.launches = column_sum.launches
    monkeypatch.setattr(cb, "conv_bn_column_sum", spy)
    for M, K, N in _SCRIPT_1X1:
        x, s, b, w = _conv_case(cuda, (M, K), K, (K, N), K, seed=1)
        n0 = (cb.fused_conv1x1_bn.launches_wgmma, cb.run_mm.launches_wgmma,
              cb.run_pro.launches_wgmma)
        p0 = cb.conv_bn_prologue.launches
        cb.fused_conv1x1_bn(x, s, b, w, bn=N)
        cb.run_mm(x, w, bm=M, bn=N)
        cb.run_pro(x, s, b, w, bm=M, bn=N)
        torch.cuda.synchronize()
        assert (cb.fused_conv1x1_bn.launches_wgmma, cb.run_mm.launches_wgmma,
                cb.run_pro.launches_wgmma) == tuple(v + 1 for v in n0)
        plan = cb.conv_plan(M, N, sms=cb._sms(x.device))
        assert plan["route"] == "wgmma"
        # fused_conv1x1_bn and run_pro: one pass each where the plan says
        assert cb.conv_bn_prologue.launches - p0 == 2 * (
            plan["prologue"] == "pass")
        assert seen.pop() == (2, plan["groups"], N)
    for n, H, W, C, Co in _SCRIPT_3X3 + ((3, 5, 9, 16, 40),):
        x, s, b, w = _conv_case(cuda, (n, H, W, C), C, (3, 3, C, Co), 9 * C,
                                seed=2)
        n0 = (cb.fused3x3.launches_wgmma, cb.fused3x3.launches_mma)
        p0 = cb.conv_bn_prologue.launches
        cb.fused3x3(x, s, b, w, bn_blk=1)
        torch.cuda.synchronize()
        plan = cb.conv_plan(n * H * W, Co, C, sms=cb._sms(x.device))
        mma = C % 64 != 0
        assert plan["route"] == ("mma" if mma else "wgmma")
        assert (cb.fused3x3.launches_wgmma,
                cb.fused3x3.launches_mma) == (n0[0] + (not mma),
                                              n0[1] + mma)
        assert cb.conv_bn_prologue.launches - p0 == (not mma)
        assert seen.pop() == (2, plan["groups"], Co)
    column_sum.launches = spy.launches


@pytest.mark.cuda
def test_conv_bn_kernels_refuse_what_they_cannot_read(cuda):
    x, s, b, w = _conv_case(cuda, (256, 64), 64, (64, 128), 64, seed=5)
    with pytest.raises(TypeError, match="bfloat16"):
        cb.run_mm(x.float(), w.float())
    with pytest.raises(ValueError, match="contiguous"):
        cb.run_mm(x, w.t().contiguous().t())
    with pytest.raises(TypeError, match="float32"):
        cb.run_pro(x, s.to(torch.bfloat16), b, w)
    x12, s12, b12, w12 = _conv_case(cuda, (256, 12), 12, (12, 128), 12, 6)
    with pytest.raises(ValueError, match="multiples of 8"):
        cb.run_mm(x12, w12)

"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; those are held
here against the JAX kernels run in Pallas interpret mode, on the same
numpy inputs (rtol/atol 2e-5: both sides compute in f32, in another
order).  The CUDA kernels themselves are held against their plain
versions on the card in ``test_torch_cuda.py``.  Also here: the package
rules (no JAX import, entry points that raise without a card) and the
build's failure modes.
"""
import ast
import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.kernels import paged_attention as jpa

import paddle_tpu_torch
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import paged_attention as pa
from test_torch_cuda import _case, _qkv

TOL = dict(rtol=2e-5, atol=2e-5)
PKG = pathlib.Path(paddle_tpu_torch.__file__).parent

# gpt-tiny shapes gain nothing from intra-op threads; one thread keeps
# these tests from crowding the timing-sensitive tests of other workers
torch.set_num_threads(1)


FLASH_CASES = [  # (Tq, Tk, causal): square, ragged, Tq < Tk, full
    (16, 16, True), (37, 37, True), (24, 40, True), (37, 37, False),
    (20, 45, False)]


@pytest.mark.parametrize("tq,tk,causal", FLASH_CASES)
def test_flash_plain_matches_jax(tq, tk, causal):
    B, H, D = 2, 3, 32
    q, k, v = _qkv(B, tq, tk, H, D, seed=tq + tk)
    jfa.use_interpret_mode(True)
    want = np.asarray(jfa.flash_attention_bthd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    q3, k3, v3 = (jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, -1, D))
                  for x in (q, k, v))
    _, want_lse = jfa._flash_fwd(q3, k3, v3, 1.0 / math.sqrt(D), causal)
    got, lse = fa.flash_attention_bthd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, return_lse=True)
    assert got.shape == (B, tq, H, D) and lse.shape == (B * H, tq, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


# causal Tq > Tk: (200, 120) one reference tile each way (the one-pass
# forward, the single-tile backward); (1100, 600) two q tiles and one kv
# tile; (2100, 1000) a first q tile whose rows the split backward skips;
# (3100, 1100) a first q tile with no live kv tile (zero rows forward)
DEAD_CASES = [(200, 120), (1100, 600), (2100, 1000), (3100, 1100)]


@pytest.mark.parametrize("tq,tk", DEAD_CASES,
                         ids=[f"{a}x{b}" for a, b in DEAD_CASES])
def test_dead_causal_rows_match_jax(tq, tk):
    """Rows i < Tq - Tk of a causal call have no live key; the reference's
    output, lse and gradients there follow its own tiles (``dead_rows``).
    The plain forward and backward against ``_flash_fwd`` and
    ``_flash_bwd`` in interpret mode on the same f32 inputs: TOL for the
    forward, and for the gradients rtol 2e-5 with atol 2e-5 of the
    largest gradient (sums of up to 1100 terms in another order)."""
    B, H, D = 1, 2, 32
    q, k, v = _qkv(B, tq, tk, H, D, seed=tq)
    do = np.random.RandomState(tk).randn(B, tq, H, D).astype(np.float32)
    jfa.use_interpret_mode(True)
    q3, k3, v3, do3 = (jnp.asarray(x.transpose(0, 2, 1, 3).reshape(
        B * H, -1, D)) for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(D)
    out_j, lse_j = jfa._flash_fwd(q3, k3, v3, scale, True)
    grads_j = jfa._flash_bwd(q3, k3, v3, out_j, lse_j, do3, scale, True)
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = fa.flash_attention_plain(qt, kt, vt, causal=True,
                                        return_lse=True)

    def bthd(a):
        return np.asarray(a).reshape(B, H, -1, D).transpose(0, 2, 1, 3)

    np.testing.assert_allclose(out.numpy(), bthd(out_j), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **TOL)
    grads = fa.flash_attention_bwd_plain(qt, kt, vt, out, lse, dot,
                                         causal=True)
    for name, g, w in zip("qkv", grads, grads_j):
        w = bthd(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-5,
                                   atol=2e-5 * np.abs(w).max(),
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("mask_kind", ["bool", "additive"])
def test_masked_sdpa_matches_jax_ref(mask_kind):
    """Masked calls keep the plain math on both sides (``_sdpa_ref``)."""
    from paddle_tpu.nn.functional.attention import _sdpa_ref
    from paddle_tpu_torch.nn.functional import scaled_dot_product_attention

    B, T, H, D = 2, 12, 3, 16
    q, k, v = _qkv(B, T, T, H, D, seed=5)
    rs = np.random.RandomState(6)
    if mask_kind == "bool":
        mask = rs.rand(B, 1, T, T) < 0.7
        mask[..., 0] = True                       # every row attends
    else:
        mask = rs.randn(B, 1, T, T).astype(np.float32)
    want = np.asarray(_sdpa_ref(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(mask), 0.0, True,
                                1.0 / math.sqrt(D), False))
    got = scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        attn_mask=torch.from_numpy(mask), is_causal=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("T", [16, 37])
def test_fused_flash_plain_matches_jax(T):
    """The fused forward on one [B, T, nh, 3, hd] tensor against JAX's
    ``flash_attention_qkv_fused`` on its [B*nh, 3, T, hd] layout."""
    B, H, D = 2, 3, 32
    qkv = np.random.RandomState(T).randn(B, T, H, 3, D).astype(np.float32)
    jfa.use_interpret_mode(True)
    qkv_j = jnp.asarray(qkv.transpose(0, 2, 3, 1, 4).reshape(B * H, 3, T, D))
    want = np.asarray(jfa.flash_attention_qkv_fused(qkv_j))
    _, want_lse = jfa._flash_fused_fwd_impl(qkv_j, 1.0 / math.sqrt(D), True)
    got, lse = fa.flash_attention_qkv_fused_plain(torch.from_numpy(qkv),
                                                  return_lse=True)
    assert got.shape == (B, T, H * D) and lse.shape == (B * H, T, 1)
    np.testing.assert_allclose(
        got.numpy(), want.reshape(B, H, T, D).transpose(0, 2, 1, 3)
        .reshape(B, T, H * D), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


def test_fused_role_views_are_strided_not_copied():
    """The kernels read q, k, v of the fused projection through strides:
    the role views share the buffer and a unit-stride head dimension is
    all the launch asks for; anything else raises."""
    qkv = torch.zeros(2, 5, 3, 3, 8)
    q, k, v = fa._split_qkv(qkv)
    assert q.data_ptr() == qkv.data_ptr()
    assert k.data_ptr() - q.data_ptr() == 8 * qkv.element_size()
    st = list(fa._stride_array((q, "q"), (k, "k"), (v, "v")))
    assert st == [5 * 3 * 3 * 8, 3 * 3 * 8, 3 * 8] * 3
    with pytest.raises(ValueError, match="unit-stride"):
        fa._strides(qkv[..., ::2], "q")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa._kernel_dtype(q.half(), k)


def test_flash_cpu_takes_plain_without_launch():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 8, 2, 32, 0))
    before = fa.flash_attention_bthd.launches
    out = fa.flash_attention_bthd(q, k, v)
    torch.testing.assert_close(out, fa.flash_attention_plain(q, k, v))
    assert fa.flash_attention_bthd.launches == before


def test_flash_other_device_raises_instead_of_plain():
    q = torch.empty(1, 8, 2, 32, device="meta")
    with pytest.raises(ValueError, match="no flash attention for device"):
        fa.flash_attention_bthd(q, q, q)


def test_flash_cost_counts_causal_pairs():
    flops, nbytes = fa.flash_cost(1, 4, 4, 1, 8, causal=True)
    assert flops == 4.0 * (1 + 2 + 3 + 4) * 8
    assert nbytes == 4.0 * (2 * 4 * 8 + 2 * 4 * 8 + 4)
    assert fa.flash_cost(1, 4, 4, 1, 8, causal=False)[0] == 4.0 * 16 * 8


# -- paged decode ------------------------------------------------------------

def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("n_pt", [4, 16])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("W", [1, 4, 8])
def test_paged_plain_matches_jax(W, quant, n_pt):
    q, kp, vp, pt, lengths, ks, vs = _case(W, quant, n_pt=n_pt)
    want = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(lengths),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs)))
    got = pa.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(pt),
                                    _t(lengths), _t(ks), _t(vs)).numpy()
    live = lengths < pt.shape[1] * kp.shape[1]       # parked rows: unread
    np.testing.assert_allclose(got[live], want[live], **TOL)


def test_paged_scale_validation():
    q, kp, vp, pt, lengths, ks, vs = (_t(x) for x in _case(1, True))
    with pytest.raises(ValueError, match="int8 pools need"):
        pa.paged_decode_attention(q, kp, vp, pt, lengths)
    qf, kf, vf, ptf, lf, _, _ = (_t(x) for x in _case(1, False))
    with pytest.raises(ValueError, match="must not pass"):
        pa.paged_decode_attention(qf, kf, vf, ptf, lf, k_scale=ks,
                                  v_scale=vs)
    with pytest.raises(ValueError, match="int8 pools need"):
        pa.paged_decode_attention(q, kp, vp, pt, lengths, k_scale=ks)


# (B, W, H, D, P, n_pt, quant) -> (grid, chunk positions, workspace bytes):
# the serving shape, the table the whole-row kernel refused, one page
PLANS = [
    ((9, 1, 12, 64, 16, 40, False), ((1080,), 64, 4 * 9 * 10 * 12 * 66)),
    ((4, 8, 2, 32, 16, 1024, False),
     ((2048,), 64, 4 * 4 * 256 * 2 * 8 * 34)),
    ((2, 4, 12, 64, 16, 1, True), ((24,), 16, 4 * 2 * 1 * 12 * 4 * 66)),
]


@pytest.mark.parametrize("shape,want", PLANS, ids=["serve", "wide", "page"])
def test_paged_plan(shape, want, monkeypatch):
    """The launch comes from the shapes alone; no width is refused: the
    call reaches the kernel with the planned chunking and workspace, or
    with a plan the caller passes."""
    B, W, H, D, P, n_pt, quant = shape
    plan = pa.paged_plan(*shape[:6])
    assert (plan["grid"], plan["chunk"], plan["workspace_bytes"]) == want
    assert plan["grid"] == (B * H * plan["n_chunks"],)
    assert plan["n_chunks"] * plan["chunk"] >= n_pt * P
    assert P % plan["segment"] == 0
    assert plan["chunk"] == plan["segments"] * plan["segment"]
    calls = []

    class Lib:
        def paddle_paged_decode_attention(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(_build, "library", lambda: Lib())
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    NP = 4
    pool = torch.zeros(NP, P, H, D, dtype=torch.int8 if quant else
                       torch.float32)
    scales = (torch.ones(NP, P), torch.ones(NP, P)) if quant else (None,
                                                                   None)
    args = (torch.zeros(B, W, H, D), pool, pool,
            torch.zeros(B, n_pt, dtype=torch.int32),
            torch.zeros(B, dtype=torch.int32), *scales, 0.125, quant)
    before = pa.paged_decode_attention.launches
    out = pa._launch(*args)
    assert out.shape == (B, W, H, D)
    assert pa.paged_decode_attention.launches == before + 1
    small = pa.paged_plan(*shape[:6], chunk_positions=8)
    pa._launch(*args, plan=small)
    assert [c[10:20] for c in calls] == [
        (B, W, H, D, P, n_pt, NP, p["segment"], p["segments"],
         p["n_chunks"]) for p in (plan, small)]
    assert small["segment"] == 8 and small["chunk"] == 8


def test_paged_cost_counts_resident_tokens():
    flops, nbytes = pa.paged_cost([5, 32], W=1, H=2, D=8, P=8, n_pt=4,
                                  quant=False)
    assert flops == 4.0 * 2 * 1 * 6 * 8            # only row 0 is live
    assert nbytes == 2 * (4 * 5 + 2 * 4 * 2 * 8) + 2.0 * 6 * 2 * 8 * 4
    _, qbytes = pa.paged_cost([5], W=1, H=2, D=8, P=8, n_pt=4, quant=True)
    assert qbytes == 4 * 5 + 2 * 4 * 2 * 8 + 2.0 * 6 * 2 * 8 + 2.0 * 6 * 4


# -- the build ---------------------------------------------------------------

def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_build_digest_follows_sources():
    srcs = _build._sources()
    assert {s.name for s in srcs} == {"flash_attention_fwd.cu",
                                      "flash_attention_bwd.cu",
                                      "paged_attention.cu", "layer_norm.cu",
                                      "ln_matmul.cu", "conv_bn.cu",
                                      "conv_wgmma_1x1.cu",
                                      "conv_wgmma_3x3.cu"}
    assert _build._digest(srcs) == _build._digest(srcs)
    assert _build._digest(srcs[:1]) != _build._digest(srcs)


def test_build_check_raises_on_cuda_error():
    _build.check(0, "ok")
    with pytest.raises(RuntimeError, match="error 9"):
        _build.check(9, "paged")


# -- package rules -----------------------------------------------------------

def test_import_pulls_in_no_jax():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.kernels, "
            "paddle_tpu_torch.models, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.nn, paddle_tpu_torch.vision, "
            "paddle_tpu_torch.kernels.conv_bn\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(PKG.parent), timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_jax_import_in_package_source():
    bad = []
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "paddle_tpu"):
                    bad.append(f"{path.name}: {n}")
    assert not bad, bad


def test_entry_points_raise_without_a_card(monkeypatch):
    from paddle_tpu_torch.models import build_gpt
    from paddle_tpu_torch.serving import Engine

    model = build_gpt("gpt-tiny", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build_gpt("gpt-tiny")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Engine(model, max_slots=2, max_len=32)
    assert resolve_device("cpu") == torch.device("cpu")

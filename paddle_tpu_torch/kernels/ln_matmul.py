"""LayerNorm fused into the projection it feeds: ``y = LN(x) @ W^T``, a
CUDA kernel for Hopper beside its plain PyTorch version.

Replaces the Pallas TPU kernel of ``paddle_tpu/kernels/ln_matmul.py``
(``_ln_matmul_fwd_impl`` -> ``_kernel``) by ``csrc/ln_matmul.cu``.  bf16:
a statistics pass writes every row's f32 mean and rstd, then a persistent
``wgmma`` kernel streams x's and W's K-slices in by TMA, normalises x's
slice in place in shared memory (rounded to x's type before the product,
as the reference casts ``xln``) and multiplies it with the weight's slice
as it landed, with f32 accumulation.  f32: one CUDA-core kernel with FMAs
and the statistics in a prologue.  The output is in x's type; the
projection's bias is added outside, as in the reference.

Layout: the weight is ``[M, K]`` (a ``torch.nn.Linear.weight``; the JAX
kernel takes ``[K, M]``); the kernel reads it in place, with no
transposed copy.  ``F.fused_ln_linear`` takes the JAX package's ``[K, M]``
and hands this function its ``.t()`` view.

The backward is the reference's ``_bwd`` (``ln_matmul.py:128-152``; plain
code outside any Pallas kernel there too) on the port's kernels: the
LayerNorm forward (``layer_norm_fwd``) rebuilds the normalised rows in
x's type with their statistics (one read of x, one write, the same bytes
as applying saved statistics, so none are saved); ``torch.matmul`` gives
the weight's gradient and one product with an f32 result the gradient of
the normalised rows, unrounded as the reference's
``preferred_element_type=jnp.float32``; then the LayerNorm backward
(``layer_norm_bwd``, f32 dy beside x's type) gives dx, dgamma and dbeta
in one kernel and its column sum.

Opt-in, as in the reference (``enable_ln_matmul``); unlike it there is no
probe compile that quietly keeps the flag off: a build or launch failure
raises at the first launch.  CPU tensors take :func:`ln_matmul_plain`;
CUDA tensors launch the kernel or raise.  Launch counter:
``ln_matmul.launches``.
"""
from __future__ import annotations

import torch

from .flash_attention import _on_card
from .layer_norm import layer_norm_bwd, layer_norm_fwd

__all__ = ["enable_ln_matmul", "ln_matmul_enabled", "ln_matmul",
           "ln_matmul_ok", "ln_matmul_plain", "ln_matmul_cost"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ENABLED = False


def enable_ln_matmul(flag: bool):
    """Opt in to (or out of) the fused kernel."""
    global _ENABLED
    _ENABLED = bool(flag)


def ln_matmul_enabled() -> bool:
    return _ENABLED


def _stats(x2, eps):
    xf = x2.float()
    mu = xf.mean(dim=1, keepdim=True)
    d = xf - mu
    return d, torch.rsqrt((d * d).mean(dim=1, keepdim=True) + eps)


def ln_matmul_plain(x2, g, b, w, eps):
    """The plain forward: ``[N, K]`` rows normalised in f32, rounded to
    x's type, multiplied with ``w`` ``[M, K]`` in f32 (``w^T``), the
    result rounded to x's type."""
    d, rs = _stats(x2, eps)
    xln = (d * rs * g.float() + b.float()).to(x2.dtype)
    return torch.matmul(xln.float(), w.float().t()).to(x2.dtype)


def ln_matmul_cost(N, K, M, itemsize=4):
    """Analytic work of one forward: (flops, bytes).  Flops count the
    product (2 a multiply-add); bytes count x and w read once, the
    LayerNorm parameters read once and the output written once."""
    return (2.0 * N * K * M,
            itemsize * (N * K + M * K + N * M) + 2.0 * itemsize * K)


# -- the kernel ----------------------------------------------------------------

def _check(x2, g, b, w):
    if x2.dim() != 2 or w.dim() != 2 or w.shape[1] != x2.shape[1]:
        raise ValueError(f"ln_matmul takes x [N, K] and w [M, K], got "
                         f"{tuple(x2.shape)} and {tuple(w.shape)}")
    if x2.dtype not in _DTYPE_CODE or w.dtype != x2.dtype:
        raise TypeError(f"the ln_matmul kernel takes float32 or bfloat16 x "
                        f"and w of one type, got {x2.dtype} and {w.dtype}")
    K = x2.shape[1]
    for t, what in ((x2, "x"), (w, "w")):
        if (K % 8 or t.stride(1) != 1 or t.stride(0) % 8
                or t.data_ptr() % 16):
            raise ValueError(f"the ln_matmul kernel reads {what} rows with "
                             f"16-byte loads: K % 8 == 0, unit-stride rows, "
                             f"a row stride that is a multiple of 8 and a "
                             f"16-byte aligned base; got shape "
                             f"{tuple(t.shape)} strides {t.stride()}")
    for p in (g, b):
        if (p.shape != (K,) or p.dtype not in _DTYPE_CODE
                or not p.is_contiguous() or p.data_ptr() % 16):
            raise ValueError(f"ln_matmul takes contiguous, 16-byte aligned "
                             f"float32 or bfloat16 [{K}] LayerNorm "
                             f"parameters, got {tuple(p.shape)} {p.dtype}")
    if not (x2.device == w.device == g.device == b.device):
        raise ValueError("ln_matmul's operands must lie on one device")


def _fwd(x2, g, b, w, eps):
    if not _on_card(x2, "ln_matmul"):
        return ln_matmul_plain(x2, g, b, w, eps)
    from . import _build

    _check(x2, g, b, w)
    N, K = x2.shape
    M = w.shape[0]
    out = torch.empty(N, M, dtype=x2.dtype, device=x2.device)
    if N == 0 or M == 0:
        return out
    # the bf16 path's rows' mean and rstd, from its statistics pass
    stats = torch.empty(2, N, dtype=torch.float32, device=x2.device)
    lib = _build.library()
    err = lib.paddle_ln_matmul(
        x2.data_ptr(), x2.stride(0), g.data_ptr(), b.data_ptr(),
        w.data_ptr(), w.stride(0), out.data_ptr(), stats.data_ptr(), N, K, M,
        float(eps), _DTYPE_CODE[x2.dtype], _DTYPE_CODE[g.dtype],
        _DTYPE_CODE[b.dtype],
        torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, "ln_matmul")
    ln_matmul.launches += 1
    return out


def _mm_f32(a, b):
    """``a @ b`` with an f32 result and f32 accumulation: on the card one
    cuBLAS product of the operands as they are (``out_dtype``), on the CPU
    the same product of f32 copies (a bf16 value is an f32 value)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


class _LnMatmul(torch.autograd.Function):
    """``_ln_matmul``'s ``custom_vjp``: the kernel forward; the backward
    is the reference's ``_bwd`` (``ln_matmul.py:128-152``) on the
    LayerNorm kernels."""

    @staticmethod
    def forward(ctx, x2, g, b, w, eps):
        ctx.save_for_backward(x2, g, b, w)
        ctx.eps = eps
        return _fwd(x2, g, b, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x2, g, b, w = ctx.saved_tensors
        x2 = x2.contiguous()
        xln, mu, rs = layer_norm_fwd(x2, g, b, ctx.eps)
        # the weight's layout is [M, K]: dW = dy^T @ xln, dxln = dy @ W
        dw = torch.matmul(dy.t(), xln)
        dxln = _mm_f32(dy, w)
        dx, dgamma, dbeta = layer_norm_bwd(x2, g, mu, rs, dxln)
        return dx, dgamma.to(g.dtype), dbeta.to(b.dtype), dw.to(w.dtype), None


def ln_matmul(x, ln_weight, ln_bias, w, bias=None, eps=1e-5):
    """``y = LayerNorm(x over the last axis; ln_weight, ln_bias) @ w^T
    (+ bias)``.  x ``[..., K]``, w ``[M, K]`` (``nn.Linear.weight``);
    returns ``[..., M]`` in x's type.  Differentiable through
    ``_LnMatmul``."""
    shape = x.shape
    y = _LnMatmul.apply(x.reshape(-1, shape[-1]), ln_weight, ln_bias, w,
                        float(eps))
    y = y.reshape(*shape[:-1], w.shape[0])
    return y if bias is None else y + bias


def ln_matmul_ok(x, w, mesh_free: bool) -> bool:
    """Routing predicate: opted in, no mesh, K and M multiples of 128
    (``w`` is ``[M, K]``).  No platform test: a CPU tensor takes the plain
    version."""
    if not _ENABLED or not mesh_free:
        return False
    return not (x.shape[-1] % 128 or w.shape[0] % 128)


ln_matmul.launches = 0

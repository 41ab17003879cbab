"""Fused LayerNorm over the last axis: CUDA kernels for Hopper beside their
plain PyTorch versions.

Replaces the Pallas TPU kernels of ``paddle_tpu/kernels/layer_norm.py``:

* ``_ln_fwd_impl`` -> ``_ln_fwd_kernel``: ``y = (x - mu) * rstd * w + b``
  in x's type, with the f32 row mean and rstd saved for the backward;
* ``_ln_bwd_impl`` -> ``_ln_bwd_kernel``: ``dx`` in x's type and the f32
  column sums ``dw = sum(dy * xhat)``, ``db = sum(dy)``.  ``dy`` comes in
  x's type or, beside bf16 x, in f32 (the ``ln_matmul`` backward's f32
  gradient of the normalised rows).

Both live in ``csrc/layer_norm.cu``.  The TPU carried dw and db across a
sequential grid in scratch memory; here the backward is two kernels: one
writes dx and one f32 partial of dw and db per block, the other sums the
partials column by column in a fixed order.  No atomics, so gradients
repeat bitwise.  A lane holds its part of a row in registers up to C =
2048 (bf16) or 1024 (f32); wider rows, any C % 8 == 0, run kernels that
sweep the row more than once with the same arithmetic.

The path is opt-in, as in the reference: ``enable_fused_layernorm`` takes
``"off"`` (the default), ``"full"`` (kernel forward and backward, through
``_FusedLN``) or ``"bwd"`` (the forward in torch ops, the kernel
backward, through ``_HybridLN``).  ``layer_norm_fused_ok`` is the routing
predicate of ``nn.functional.layer_norm``.

Every wrapper picks the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.  Launch counters:
``layer_norm_fused.launches_fwd``, ``.launches_bwd`` (the dx kernel) and
``.launches_bwd_reduce`` (the dw/db column sum), and each by the rows'
dtype in ``.launches_by_dtype``.
"""
from __future__ import annotations

import torch

from .flash_attention import _on_card

__all__ = ["enable_fused_layernorm", "fused_layernorm_mode",
           "layer_norm_fused", "layer_norm_fused_ok", "layer_norm_fwd",
           "layer_norm_bwd", "layer_norm_fwd_plain", "layer_norm_bwd_plain",
           "layernorm_cost"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: "off" | "full" (kernel forward and backward) | "bwd" (torch forward,
#: kernel backward)
_MODE = "off"


def enable_fused_layernorm(flag):
    """False/"off" disables; any other truthy non-string (True included)
    means "full"; "bwd" is the hybrid (torch forward, kernel backward)."""
    global _MODE
    if not flag:
        _MODE = "off"
    elif not isinstance(flag, str):
        _MODE = "full"
    elif flag in ("off", "full", "bwd"):
        _MODE = flag
    else:
        raise ValueError(
            f"enable_fused_layernorm: unknown mode {flag!r} "
            f"(expected off|full|bwd)")


def fused_layernorm_mode() -> str:
    """The routing mode :func:`enable_fused_layernorm` set: "off", "full"
    or "bwd" (a serving engine keys its decode graph on it)."""
    return _MODE


# -- plain versions ------------------------------------------------------------

def layer_norm_fwd_plain(x2, w, b, eps):
    """The plain forward of ``[N, C]`` rows, JAX's ``_jnp_ln`` in torch
    ops: ``(y, mu, rs)``, f32 statistics, ``y`` in x's type, ``mu`` and
    ``rs`` ``[N, 1]`` f32."""
    xf = x2.float()
    mu = xf.mean(dim=1, keepdim=True)
    d = xf - mu
    rs = torch.rsqrt((d * d).mean(dim=1, keepdim=True) + eps)
    y = (d * rs * w.float() + b.float()).to(x2.dtype)
    return y, mu, rs


# mode "bwd"'s forward: the same torch ops, but not a kernel's stand-in, so
# it keeps a name of its own (a check that the kernels ran replaces
# ``layer_norm_fwd_plain`` and must not catch it)
_torch_ln = layer_norm_fwd_plain


def layer_norm_bwd_plain(x2, w, mu, rs, dy):
    """The plain backward: ``(dx, dw, db)`` from the saved statistics,
    ``dx`` in x's type, ``dw`` and ``db`` ``[C]`` f32."""
    x = x2.float()
    dyf = dy.float()
    xhat = (x - mu) * rs
    dyw = dyf * w.float()
    m1 = dyw.mean(dim=1, keepdim=True)
    m2 = (dyw * xhat).mean(dim=1, keepdim=True)
    dx = (rs * (dyw - m1 - xhat * m2)).to(x2.dtype)
    return dx, (dyf * xhat).sum(dim=0), dyf.sum(dim=0)


def layernorm_cost(N, C, itemsize=4, part="fwd", w_itemsize=None,
                   dy_itemsize=None):
    """Analytic work of one call: (flops, bytes).  ``part="fwd"``: x read
    and y written once (``itemsize`` bytes an element), w and b read once,
    the f32 mean and rstd written once; ``part="bwd"``: x and dy
    (``dy_itemsize`` bytes, x's by default) read and dx written once, the
    statistics and w read once, f32 dw and db written once.  Flops count
    the element-wise arithmetic (7 an element forward, 12 backward)."""
    wi = itemsize if w_itemsize is None else w_itemsize
    di = itemsize if dy_itemsize is None else dy_itemsize
    if part == "fwd":
        return 7.0 * N * C, itemsize * 2.0 * N * C + 2.0 * wi * C + 8.0 * N
    if part == "bwd":
        return (12.0 * N * C, (2.0 * itemsize + di) * N * C + 8.0 * N
                + wi * C + 8.0 * C)
    raise ValueError(f"part must be 'fwd' or 'bwd', got {part!r}")


# -- kernel launches -----------------------------------------------------------

def _check_rows(x2, what, *params):
    """The kernels read ``[N, C]`` rows and ``[C]`` parameters with
    16-byte loads: contiguous, 16-byte aligned, C a multiple of 8."""
    if x2.dim() != 2:
        raise ValueError(f"{what} takes [N, C] rows, got {tuple(x2.shape)}")
    if x2.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what} takes float32 or bfloat16 rows, got "
                        f"{x2.dtype}")
    C = x2.shape[1]
    if C % 8 or not x2.is_contiguous() or x2.data_ptr() % 16:
        raise ValueError(f"{what} reads contiguous 16-byte aligned rows "
                         f"with C % 8 == 0, got shape {tuple(x2.shape)} "
                         f"strides {x2.stride()}")
    for p in params:
        if (p.shape != (C,) or p.dtype not in _DTYPE_CODE
                or not p.is_contiguous() or p.device != x2.device
                or p.data_ptr() % 16):
            raise ValueError(f"{what} takes contiguous, 16-byte aligned "
                             f"float32 or bfloat16 [{C}] parameters on "
                             f"{x2.device}, got {tuple(p.shape)} {p.dtype} "
                             f"on {p.device}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def layer_norm_fwd(x2, w, b, eps):
    """Forward of ``[N, C]`` rows: ``(y, mu, rs)`` as
    :func:`layer_norm_fwd_plain` returns them.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (any failure raises)."""
    if not _on_card(x2, "fused LayerNorm"):
        return layer_norm_fwd_plain(x2, w, b, eps)
    from . import _build

    _check_rows(x2, "the LayerNorm forward kernel", w, b)
    N, C = x2.shape
    y = torch.empty_like(x2)
    mu = torch.empty(N, 1, dtype=torch.float32, device=x2.device)
    rs = torch.empty(N, 1, dtype=torch.float32, device=x2.device)
    if N == 0:
        return y, mu, rs
    lib = _build.library()
    err = lib.paddle_layer_norm_fwd(
        x2.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
        mu.data_ptr(), rs.data_ptr(), N, C, float(eps),
        _DTYPE_CODE[x2.dtype], _DTYPE_CODE[w.dtype], _DTYPE_CODE[b.dtype],
        _stream(x2))
    _build.check(err, "layer_norm_fwd")
    _count("launches_fwd", x2)
    return y, mu, rs


def _count(what, x2):
    """One launch of kernel ``what`` on rows ``x2``: adds one to
    ``layer_norm_fused.<what>`` and to ``layer_norm_fused.
    launches_by_dtype[(what, x's dtype name)]``."""
    setattr(layer_norm_fused, what, getattr(layer_norm_fused, what) + 1)
    by = layer_norm_fused.launches_by_dtype
    key = (what, str(x2.dtype).replace("torch.", ""))
    by[key] = by.get(key, 0) + 1


def layer_norm_bwd(x2, w, mu, rs, dy):
    """Backward from the saved statistics: ``(dx, dw, db)`` as
    :func:`layer_norm_bwd_plain` returns them.  ``dy`` in x's type, or f32
    beside bf16 x.  CPU tensors take the plain version; CUDA tensors
    launch the dx kernel and the dw/db column sum (any failure raises)."""
    if not _on_card(x2, "fused LayerNorm backward"):
        return layer_norm_bwd_plain(x2, w, mu, rs, dy)
    from . import _build

    dy = dy.contiguous()
    _check_rows(x2, "the LayerNorm backward kernel", w)
    _check_rows(dy, "the LayerNorm backward kernel")
    if dy.shape != x2.shape or dy.dtype not in (x2.dtype, torch.float32):
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match x "
                         f"{tuple(x2.shape)} {x2.dtype} (dy takes x's type "
                         f"or float32)")
    N, C = x2.shape
    for s in (mu, rs):
        if s.dtype != torch.float32 or s.numel() != N or not s.is_contiguous():
            raise ValueError("the LayerNorm backward takes the forward's f32 "
                             "[N, 1] mean and rstd")
    dx = torch.empty_like(x2)
    if N == 0:
        z = torch.zeros(C, dtype=torch.float32, device=x2.device)
        return dx, z, z.clone()
    lib = _build.library()
    nblk = lib.paddle_layer_norm_bwd_blocks(N)
    part = torch.empty(2, nblk, C, dtype=torch.float32, device=x2.device)
    dwb = torch.empty(2, C, dtype=torch.float32, device=x2.device)
    # rows wider than a lane's registers keep two f32 sums a row aside
    m12 = (torch.empty(2, N, dtype=torch.float32, device=x2.device)
           if C > lib.paddle_layer_norm_max_c(_DTYPE_CODE[x2.dtype]) else None)
    stream = _stream(x2)
    err = lib.paddle_layer_norm_bwd(
        x2.data_ptr(), w.data_ptr(), mu.data_ptr(), rs.data_ptr(),
        dy.data_ptr(), dx.data_ptr(), part.data_ptr(),
        0 if m12 is None else m12.data_ptr(), N, C, nblk,
        _DTYPE_CODE[x2.dtype], _DTYPE_CODE[w.dtype], _DTYPE_CODE[dy.dtype],
        stream)
    _build.check(err, "layer_norm_bwd")
    _count("launches_bwd", x2)
    err = lib.paddle_layer_norm_bwd_reduce(part.data_ptr(), dwb.data_ptr(),
                                           nblk, C, stream)
    _build.check(err, "layer_norm_bwd_reduce")
    _count("launches_bwd_reduce", x2)
    return dx, dwb[0], dwb[1]


class _FusedLN(torch.autograd.Function):
    """``_fused_ln``'s ``custom_vjp``: kernel forward, kernel backward;
    saves (x2, w, mu, rs)."""

    @staticmethod
    def forward(ctx, x2, w, b, eps):
        y, mu, rs = layer_norm_fwd(x2, w, b, eps)
        ctx.save_for_backward(x2, w, mu, rs)
        ctx.b_dtype = b.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, w, mu, rs = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(x2, w, mu, rs, dy)
        return dx, dw.to(w.dtype), db.to(ctx.b_dtype), None


class _HybridLN(torch.autograd.Function):
    """``_hybrid_ln``: the forward in torch ops (it is no Pallas kernel in
    the reference either), the kernel backward."""

    @staticmethod
    def forward(ctx, x2, w, b, eps):
        y, mu, rs = _torch_ln(x2, w, b, eps)
        ctx.save_for_backward(x2, w, mu, rs)
        ctx.b_dtype = b.dtype
        return y

    backward = _FusedLN.backward


def layer_norm_fused(x, weight, bias, eps):
    """LayerNorm over the last axis of ``x`` (rank >= 2) with ``[C]``
    weight and bias, differentiable: through ``_HybridLN`` in mode "bwd",
    else ``_FusedLN``."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    fn = _HybridLN if _MODE == "bwd" else _FusedLN
    return fn.apply(x2, weight, bias, float(eps)).reshape(shape)


def layer_norm_fused_ok(x, axes, weight, bias) -> bool:
    """Routing predicate: opted in, affine (weight and bias given), over
    the last axis only, C a multiple of 128.  Unlike the reference there
    is no platform test: a CPU tensor takes the plain version."""
    if _MODE == "off":
        return False
    if weight is None or bias is None or len(axes) != 1:
        return False
    return not (axes[0] != x.dim() - 1 or x.dim() < 2 or x.shape[-1] % 128)


layer_norm_fused.launches_fwd = 0
layer_norm_fused.launches_bwd = 0
layer_norm_fused.launches_bwd_reduce = 0
layer_norm_fused.launches_by_dtype = {}

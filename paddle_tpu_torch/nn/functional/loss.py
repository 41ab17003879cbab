"""Loss functionals (``paddle_tpu.nn.functional.loss`` counterparts).

``fused_nll_loss`` is the GPT criterion's loss: per-position f32 losses
``logsumexp(logits) - logits[label]``, zeros at ignored labels.  Its
backward is written out (``_FusedNLL``) so that the f32 upcast of the
logits lives only inside the forward and inside the backward, never
across the model's whole backward: at batch 16 x 1024 over a 50304 vocab
the bf16 logits are 1.65 GB and their f32 upcast 3.3 GB.

``fused_linear_nll_loss`` goes further: the LM head's product and the loss
in one pass over vocab chunks (``_FusedLinearNLL``), so the ``[N, V]``
logits never exist, in any type.
"""
from __future__ import annotations

import torch

from ...kernels.ln_matmul import _mm_f32

__all__ = ["fused_nll_loss", "fused_linear_nll_loss", "cross_entropy"]


class _FusedNLL(torch.autograd.Function):
    """Saves the logits in their own type and the f32 lse; the backward
    recomputes ``softmax - onehot`` in one f32 buffer, updated in place."""

    @staticmethod
    def forward(ctx, logits, labels, ignore_index):
        valid = labels != ignore_index
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        lse = torch.logsumexp(logits.float(), dim=-1)
        tgt = logits.gather(-1, safe.unsqueeze(-1)).squeeze(-1).float()
        ctx.save_for_backward(logits, safe, valid, lse)
        return torch.where(valid, lse - tgt, torch.zeros_like(lse))

    @staticmethod
    def backward(ctx, g):
        logits, safe, valid, lse = ctx.saved_tensors
        gv = torch.where(valid, g.float(), torch.zeros_like(lse))
        grad = torch.empty_like(logits, dtype=torch.float32).copy_(logits)
        grad.sub_(lse.unsqueeze(-1)).exp_()
        grad.mul_(gv.unsqueeze(-1))
        grad.scatter_add_(-1, safe.unsqueeze(-1), -gv.unsqueeze(-1))
        return grad.to(logits.dtype), None, None


class _FusedLinearNLL(torch.autograd.Function):
    """``paddle_tpu``'s ``_fused_linear_nll`` ``custom_vjp``
    (``nn/functional/loss.py:32-115``) on ``h [N, H]`` and ``w [V, H]``.

    Forward: an online logsumexp over vocab chunks of ``chunk`` rows of
    ``w``, each chunk's logits ``h @ w_c^T`` in f32 (f32 accumulation, as
    JAX's ``preferred_element_type``), the target logit picked from the
    chunk that holds it.  The last chunk is a shorter slice where JAX pads
    ``w`` with zero rows and masks their columns to ``-inf``: the same
    sums.  Saves ``h``, ``w``, the labels and the f32 lse.

    Backward, written out: each chunk's softmax is recomputed from its
    logits and the lse (one more head product), ``(p - onehot) * g`` is
    rounded to ``h``'s type, and gives ``dh += gl @ w_c`` and the chunk's
    rows of ``dw = gl^T @ h``.  At most one ``[N, chunk]`` f32 buffer is
    alive at a time; the products are ``torch.mm`` (JAX computes them
    outside any Pallas kernel too)."""

    @staticmethod
    def forward(ctx, h, w, labels, ignore_index, chunk):
        n, v = h.shape[0], w.shape[0]
        valid = labels != ignore_index
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        m = torch.full((n,), float("-inf"), device=h.device)
        s = torch.zeros(n, device=h.device)
        tgt = torch.zeros(n, device=h.device)
        for c0 in range(0, v, chunk):
            w_c = w[c0:c0 + chunk].to(h.dtype)
            cols = w_c.shape[0]
            logits = _mm_f32(h, w_c.t())                # [N, C] f32
            off = safe - c0
            picked = logits.gather(1, off.clamp(0, cols - 1)[:, None])[:, 0]
            tgt = torch.where((off >= 0) & (off < cols), picked, tgt)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + logits.sub_(
                m_new[:, None]).exp_().sum(dim=-1)
            m = m_new
        lse = m + torch.log(s)
        ctx.save_for_backward(h, w, labels, lse)
        ctx.ignore_index, ctx.chunk = ignore_index, chunk
        return torch.where(valid, lse - tgt, torch.zeros_like(lse))

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        valid = labels != ctx.ignore_index
        gv = torch.where(valid, g.float(), torch.zeros_like(lse))
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        dh = torch.zeros_like(h)
        dw = torch.empty(w.shape, dtype=h.dtype, device=h.device)
        for c0 in range(0, w.shape[0], ctx.chunk):
            w_c = w[c0:c0 + ctx.chunk].to(h.dtype)
            cols = w_c.shape[0]
            p = _mm_f32(h, w_c.t()).sub_(lse[:, None]).exp_()
            off = safe - c0
            hit = (off >= 0) & (off < cols) & valid
            p.scatter_add_(1, off.clamp(0, cols - 1)[:, None],
                           -hit.to(p.dtype)[:, None])
            gl = p.mul_(gv[:, None]).to(h.dtype)        # dlogits [N, C]
            dh.addmm_(gl, w_c)
            torch.mm(gl.t(), h, out=dw[c0:c0 + cols])
        return dh, dw.to(w.dtype), None, None, None


def fused_linear_nll_loss(hidden, weight, labels, ignore_index=-100,
                          transpose_weight=True, chunk_size=8192):
    """The LM head fused into the NLL: per-position f32 losses
    ``logsumexp(h @ W^T) - (h @ W^T)[label]`` (0 at ``ignore_index``)
    without the ``[..., V]`` logits.  ``weight`` is ``[V, H]`` with
    ``transpose_weight`` (the tied embedding), else ``[H, V]``."""
    w = weight if transpose_weight else weight.t()
    shape = hidden.shape[:-1]
    nll = _FusedLinearNLL.apply(hidden.reshape(-1, hidden.shape[-1]), w,
                                labels.reshape(-1).long(), int(ignore_index),
                                int(chunk_size))
    return nll.reshape(shape)


def fused_nll_loss(logits, labels, ignore_index=-100):
    """Per-position losses ``[...]`` in f32 over the last axis of
    ``logits``; positions whose label is ``ignore_index`` give 0 (through
    ``where``, so a non-finite row there cannot poison the loss)."""
    return _FusedNLL.apply(logits, labels.long(), int(ignore_index))


def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """The hard-label subset: softmax cross entropy over the last axis
    with ``reduction="mean"`` over the positions whose label is not
    ``ignore_index``.  The other options raise ``NotImplementedError``."""
    unported = [name for name, off in (
        ("weight", weight is None), ("reduction", reduction == "mean"),
        ("soft_label", not soft_label),
        ("axis", axis in (-1, input.dim() - 1)),
        ("use_softmax", use_softmax), ("label_smoothing",
                                       not label_smoothing)) if not off]
    if unported:
        raise NotImplementedError(
            f"cross_entropy {', '.join(unported)}: the port has the "
            f"hard-label mean over the last axis; the rest of "
            f"nn/functional/loss.py is ROADMAP module item 3")
    if label.dim() == input.dim():
        label = label.squeeze(-1)
    loss = fused_nll_loss(input, label, ignore_index)
    n = (label != ignore_index).sum().clamp(min=1)
    return loss.sum() / n

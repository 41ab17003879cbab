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

``binary_cross_entropy_with_logits`` is the JAX package's arithmetic:
``max(z, 0) - z y + log1p(exp(-|z|))``, times ``(pos_weight - 1) y + 1``
and ``weight`` where given.

``ctc_loss`` keeps the JAX function's three rules: it guesses the layout
(time-major ``[T, B, C]`` unless ``log_probs.shape[0] ==
labels.shape[0]``, so T == B reads batch-first), applies ``log_softmax``
itself (in f32 here), and its ``"mean"`` is the plain mean of the
per-sample losses (not divided by the label lengths).  The forward
algorithm is ``torch.nn.functional.ctc_loss`` (the JAX package scans it
in ``lax.scan``, no Pallas kernel); where the two differ the JAX result
is restored: an input length outside ``[1, T]`` is clipped to it (the
JAX ``t_idx`` clip), an empty label's loss is ``log 2`` lower (JAX adds
the all-blank path's probability twice), and an alignment that does not
fit the input gives JAX's 1e30 (the -1e30 floor of its log space) with
a zero gradient (JAX's gradient of that floor is not copied).
"""
from __future__ import annotations

import math

import torch

from ...kernels.ln_matmul import _mm_f32

__all__ = ["fused_nll_loss", "fused_linear_nll_loss", "cross_entropy",
           "binary_cross_entropy_with_logits", "ctc_loss"]


def _reduce(val, reduction):
    if reduction == "mean":
        return val.mean()
    if reduction == "sum":
        return val.sum()
    return val


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


def _host_ints(x):
    if torch.is_tensor(x):
        return x.reshape(-1).tolist()
    return [int(v) for v in (x.reshape(-1) if hasattr(x, "reshape") else x)]


def _on(vals, device):
    """Host ints as an int64 tensor on ``device`` without waiting for the
    device: a fill when they are equal, else a pinned copy."""
    if len(set(vals)) == 1:
        return torch.full((len(vals),), vals[0], dtype=torch.int64,
                          device=device)
    t = torch.tensor(vals, dtype=torch.int64)
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    base = (logit.clamp(min=0) - logit * label
            + torch.log1p(torch.exp(-logit.abs())))
    if pos_weight is not None:
        base = base * ((pos_weight - 1) * label + 1)
    if weight is not None:
        base = base * weight
    return _reduce(base, reduction)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False, name=None):
    """CTC over ``log_probs`` ``[T, B, C]`` (or batch-first, by the JAX
    layout rule) and padded ``labels`` ``[B, L]``; f32 losses."""
    if log_probs.dim() == 3 and log_probs.shape[0] != labels.shape[0]:
        lp = log_probs
    else:
        lp = log_probs.transpose(0, 1)
    lp = torch.log_softmax(lp.float(), dim=-1)
    T = lp.shape[0]
    dev = lp.device
    # torch's CTC reads the lengths on the host: from a CUDA tensor that is
    # one wait for the device, from host values none
    in_host = [min(max(int(v), 1), T) for v in _host_ints(input_lengths)]
    lab_host = _host_ints(label_lengths)
    in_len, lab_len = _on(in_host, dev), _on(lab_host, dev)
    labels = labels.long()
    loss = torch.nn.functional.ctc_loss(
        lp, labels, in_host, lab_host, blank=blank, reduction="none",
        zero_infinity=True)
    # an alignment fits when T covers the labels and a blank between each
    # repeated pair
    pos = torch.arange(labels.shape[1] - 1, device=dev)
    repeats = ((labels[:, 1:] == labels[:, :-1])
               & (pos < lab_len[:, None] - 1)).sum(1)
    fits = in_len >= lab_len + repeats
    loss = torch.where(fits, loss, torch.full_like(loss, 1e30))
    loss = loss - math.log(2.0) * (lab_len == 0).to(loss.dtype)
    return _reduce(loss, reduction)

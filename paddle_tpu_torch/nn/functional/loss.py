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

``cross_entropy`` has every option of the JAX function (see there), and
the other losses are its arithmetic literally (``nll_loss``'s plain
``"mean"`` counts the ignored positions, as there).  ``hinge_embedding_loss``
and ``cosine_embedding_loss`` are not in the op registry: their label
only selects (``label == 1``), so torch gives it no gradient where the
JAX tape gives it zeros.

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

from ...core.op import defop
from ...core.tensor import Tensor
from ...kernels.ln_matmul import _mm_f32

__all__ = ["fused_nll_loss", "fused_linear_nll_loss", "cross_entropy",
           "softmax_with_cross_entropy", "nll_loss", "mse_loss", "l1_loss",
           "smooth_l1_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "triplet_margin_loss",
           "sigmoid_focal_loss", "square_error_cost", "log_loss", "ctc_loss"]


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


@defop(register=False)
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


@defop(register=False)
def fused_nll_loss(logits, labels, ignore_index=-100):
    """Per-position losses ``[...]`` in f32 over the last axis of
    ``logits``; positions whose label is ``ignore_index`` give 0 (through
    ``where``, so a non-finite row there cannot poison the loss)."""
    return _FusedNLL.apply(logits, labels.long(), int(ignore_index))


@defop
def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy over ``axis``, the JAX function's options
    and arithmetic: hard labels (``ignore_index`` positions give 0 and
    leave the mean's count; with ``weight`` the mean divides by the
    valid positions' weights) or ``soft_label`` distributions;
    ``label_smoothing`` mixes in the uniform distribution;
    ``use_softmax=False`` reads ``input`` as probabilities (``log``
    of them clipped to [1e-15, 1]).  The hard-label mean over the last
    axis with none of the options runs ``fused_nll_loss`` (f32, the
    logits never upcast whole): the models' path."""
    if (weight is None and reduction == "mean" and not soft_label
            and use_softmax and not label_smoothing
            and axis in (-1, input.dim() - 1)):
        if label.dim() == input.dim():
            label = label.squeeze(-1)
        loss = fused_nll_loss(input, label, ignore_index)
        n = (label != ignore_index).sum().clamp(min=1)
        return loss.sum() / n
    if use_softmax:
        logp = torch.log_softmax(input, dim=axis)
    else:
        logp = torch.log(input.clamp(1e-15, 1.0))
    if soft_label:
        lbl = label
        if label_smoothing > 0.0:
            lbl = (1 - label_smoothing) * lbl \
                + label_smoothing / input.shape[axis]
        loss = -(lbl * logp).sum(dim=axis)
        if weight is not None:
            loss = loss * (lbl * weight).sum(dim=axis)
        return _reduce(loss, reduction)
    lbl = label.squeeze(axis) if label.dim() == logp.dim() else label
    lbl = lbl.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    picked = logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0.0:
        picked = (1 - label_smoothing) * picked \
            + label_smoothing * logp.mean(dim=axis)
    loss = -picked
    zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
    if weight is not None:
        w = weight[safe]
        loss = loss * w
        if reduction == "mean":
            denom = torch.where(valid, w, zero).sum()
            return torch.where(valid, loss, zero).sum() / denom.clamp(
                min=1e-12)
    loss = torch.where(valid, loss, zero)
    if reduction == "mean":
        return loss.sum() / valid.sum().to(loss.dtype).clamp(min=1.0)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """Per-position losses with the class axis kept (size 1), and the
    softmax with ``return_softmax``."""
    from .activation import softmax
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    from ...ops.manipulation import unsqueeze
    loss = unsqueeze(loss, axis) if isinstance(loss, Tensor) else \
        loss.unsqueeze(axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


@defop
def nll_loss(input, label, weight=None, ignore_index=-100,  # noqa: A002
             reduction="mean", name=None):
    lbl = label.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    loss = -input.gather(1, safe.unsqueeze(1)).squeeze(1)
    zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
    if weight is not None:
        w = weight[safe]
        loss = loss * w
        if reduction == "mean":
            return torch.where(valid, loss, zero).sum() / torch.where(
                valid, w, zero).sum().clamp(min=1e-12)
    return _reduce(torch.where(valid, loss, zero), reduction)


@defop
def mse_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return _reduce((input - label) ** 2, reduction)


@defop
def l1_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return _reduce((input - label).abs(), reduction)


@defop
def smooth_l1_loss(input, label, reduction="mean", delta=1.0,  # noqa: A002
                   name=None):
    d = input - label
    loss = torch.where(d.abs() < delta, 0.5 * d * d,
                       delta * (d.abs() - 0.5 * delta))
    return _reduce(loss, reduction)


@defop
def binary_cross_entropy(input, label, weight=None,  # noqa: A002
                         reduction="mean", name=None):
    x = input.clamp(1e-12, 1.0 - 1e-12)
    loss = -(label * torch.log(x) + (1 - label) * torch.log1p(-x))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@defop
def kl_div(input, label, reduction="mean", name=None):  # noqa: A002
    loss = label * (torch.log(label.clamp(min=1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


@defop
def margin_ranking_loss(input, other, label, margin=0.0,  # noqa: A002
                        reduction="mean", name=None):
    return _reduce((-label * (input - other) + margin).clamp(min=0.0),
                   reduction)


@defop(register=False)
def hinge_embedding_loss(input, label, margin=1.0,  # noqa: A002
                         reduction="mean", name=None):
    loss = torch.where(label == 1, input, (margin - input).clamp(min=0.0))
    return _reduce(loss, reduction)


@defop(register=False)
def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    norms = torch.linalg.vector_norm(input1, dim=-1) \
        * torch.linalg.vector_norm(input2, dim=-1)
    cos = (input1 * input2).sum(dim=-1) / norms.clamp(min=1e-12)
    loss = torch.where(label == 1, 1 - cos, (cos - margin).clamp(min=0.0))
    return _reduce(loss, reduction)


@defop
def triplet_margin_loss(input, positive, negative, margin=1.0,  # noqa: A002
                        p=2.0, epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def pdist(a, b):
        return torch.pow(torch.pow((a - b).abs() + epsilon, p).sum(dim=-1),
                         1.0 / p)
    dp = pdist(input, positive)
    dn = pdist(input, negative)
    if swap:
        dn = torch.minimum(dn, pdist(positive, negative))
    return _reduce((dp - dn + margin).clamp(min=0.0), reduction)


@defop
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    p = torch.sigmoid(logit)
    ce = logit.clamp(min=0) - logit * label \
        + torch.log1p(torch.exp(-logit.abs()))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * torch.pow(1 - p_t, gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


@defop
def square_error_cost(input, label, name=None):  # noqa: A002
    return (input - label) ** 2


@defop
def log_loss(input, label, epsilon=1e-4, name=None):  # noqa: A002
    return -label * torch.log(input + epsilon) \
        - (1 - label) * torch.log(1 - input + epsilon)


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


@defop
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


@defop
def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False, name=None):
    """CTC over ``log_probs`` ``[T, B, C]`` (or batch-first, by the JAX
    layout rule) and padded ``labels`` ``[B, L]``; the losses are computed
    in f32 and given in ``log_probs``' dtype."""
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
    return _reduce(loss, reduction).to(log_probs.dtype)

"""Loss functionals (``paddle_tpu.nn.functional.loss`` counterparts).

``fused_nll_loss`` is the GPT criterion's loss: per-position f32 losses
``logsumexp(logits) - logits[label]``, zeros at ignored labels.  Its
backward is written out (``_FusedNLL``) so that the f32 upcast of the
logits lives only inside the forward and inside the backward, never
across the model's whole backward: at batch 16 x 1024 over a 50304 vocab
the bf16 logits are 1.65 GB and their f32 upcast 3.3 GB.
"""
from __future__ import annotations

import torch

__all__ = ["fused_nll_loss", "cross_entropy"]


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

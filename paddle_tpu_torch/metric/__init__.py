"""paddle.metric parity (reference: python/paddle/metric/metrics.py; the
port's copy of ``paddle_tpu/metric/__init__.py``).

Accuracy — the metric the hapi fit/eval loop updates EVERY batch —
computes on the Tensors' device: top-k and the correctness compare run
in torch, and only ``len(topk)`` scalars cross to the host per update.
The ranking is the JAX package's ``lax.top_k`` rule: among equal scores
the lower index comes first.  ``torch.topk`` promises no order for ties
on CUDA, so the port ranks with a stable descending sort, which keeps
equal scores in index order.  Precision and Recall reduce their counts
on the device the same way.  Auc keeps a host histogram by design — it
needs the full score distribution, and its inputs are ``[N]`` score
vectors, not ``[N, C]`` logits.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor


def _host_small(x):
    """Host view of a SMALL operand (labels, score vectors).  The big
    per-batch operands — predictions — never come through here: their
    reductions run on device."""
    if isinstance(x, Tensor):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return Tensor._wrap(x).numpy()
    return np.asarray(x)


def _device(x, like=None):
    if isinstance(x, Tensor):
        return x._value
    if isinstance(x, torch.Tensor):
        return x
    t = torch.as_tensor(np.asarray(x))
    return t.to(like.device) if like is not None else t


def top_k_indices(p: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the ``k`` largest entries along the last axis, the
    lower index first among equal scores (``lax.top_k``'s order): a
    stable descending sort."""
    return torch.sort(p, dim=-1, descending=True, stable=True)[1][..., :k]


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self._name = name or "acc"
        self.maxk = max(self.topk)
        self.reset()

    def compute(self, pred, label, *args):
        if isinstance(pred, Tensor):
            # top-k + compare stay on device; the [N, C] predictions are
            # never downloaded — update() syncs len(topk) scalars
            p = pred._value
            lab = _device(label, p)
            order = top_k_indices(p, self.maxk)
            if lab.ndim == p.ndim and lab.shape[-1] == 1:
                lab = lab[..., 0]
            correct = (order == lab[..., None]).to(torch.float32)
            return Tensor._wrap(correct)
        pred_np = np.asarray(pred)
        label_np = _host_small(label)
        order = np.argsort(-pred_np, axis=-1)[..., :self.maxk]
        if label_np.ndim == pred_np.ndim and label_np.shape[-1] == 1:
            label_np = label_np.squeeze(-1)
        correct = (order == label_np[..., None]).astype(np.float32)
        return Tensor(correct)

    def update(self, correct, *args):
        c = correct._value if isinstance(correct, Tensor) else \
            np.asarray(correct)
        n = int(c.shape[0]) if c.ndim else 1
        accs = []
        for i, k in enumerate(self.topk):
            num = float(c[..., :k].sum())   # one scalar per k on device
            accs.append(num / max(n, 1))
            self.total[i] += num
            self.count[i] += n
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        pb = (_device(preds) > 0.5).reshape(-1)
        lb = (_device(labels, pb).to(torch.int32) == 1).reshape(-1)
        tp = pb & lb
        fp = pb & ~lb
        # two scalars cross the host boundary (was two full downloads)
        self.tp += int(tp.sum())
        self.fp += int(fp.sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        pb = (_device(preds) > 0.5).reshape(-1)
        lb = (_device(labels, pb).to(torch.int32) == 1).reshape(-1)
        tp = pb & lb
        fn = ~pb & lb
        self.tp += int(tp.sum())
        self.fn += int(fn.sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """Streaming AUC with histogram buckets (reference: metrics.py Auc +
    framework/fleet/metrics.cc BasicAucCalculator).  Host-side by
    design: the bucketed count update needs the score distribution."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        p = _host_small(preds)
        if p.ndim == 2:
            p = p[:, -1]
        lab = _host_small(labels).reshape(-1)
        bins = np.clip((p * self.num_thresholds).astype(np.int64), 0,
                       self.num_thresholds)
        for b, y in zip(bins, lab):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, np.int64)

    def accumulate(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_pos + tot_pos) * (new_neg - tot_neg) / 2.0
            tot_pos, tot_neg = new_pos, new_neg
        denom = tot_pos * tot_neg
        return float(auc / denom) if denom else 0.0

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):  # noqa: A002
    if isinstance(input, Tensor):
        p = input._value
        lab = _device(label, p).reshape(-1)
        order = top_k_indices(p, int(k))
        hit = (order == lab[:, None]).any(dim=1)
        return Tensor._wrap(hit.to(torch.float32).mean())
    pred = np.asarray(input)
    lab = _host_small(label).reshape(-1)
    order = np.argsort(-pred, axis=-1)[:, :k]
    correct_np = (order == lab[:, None]).any(axis=1).mean()
    return Tensor(np.float32(correct_np))

"""The ``nn`` layer long tail (``paddle_tpu.nn.layer.extra`` counterparts):
``Fold`` / ``Unfold``, ``MaxUnPool1D/2D/3D``, ``Softmax2D``,
``ThresholdedReLU``, ``PairwiseDistance``, the three margin-loss layers,
``HSigmoidLoss`` and the seq2seq pair ``BeamSearchDecoder`` /
``dynamic_decode``.

The decoder keeps the JAX package's host protocol: each step the cell
runs on the device and the log-softmax of its output too; one read brings
the ``[B * k, V]`` log-probabilities to the host, where numpy ranks the
candidates (``argsort``), keeps the beams and their bookkeeping
(finished beams extend only with ``end_token`` at no cost), and every
``[B * k, ...]`` leaf of the cell state is gathered along the surviving
beams on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.tensor import Tensor
from .. import functional as F
from ..layer_base import Layer

__all__ = ["Fold", "Unfold", "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D",
           "Softmax2D", "ThresholdedReLU", "PairwiseDistance",
           "SoftMarginLoss", "MultiLabelSoftMarginLoss",
           "TripletMarginWithDistanceLoss", "HSigmoidLoss",
           "BeamSearchDecoder", "dynamic_decode"]


def _raw(t):
    return t._value if isinstance(t, Tensor) else t


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self._args = (output_sizes, kernel_sizes, strides, paddings,
                      dilations)

    def forward(self, x):
        return F.fold(x, *self._args)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self._args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self._args)


class _UnPool(Layer):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, data_format=None,
                 output_size=None, name=None):
        super().__init__()
        self._kw = dict(kernel_size=kernel_size, stride=stride,
                        padding=padding, output_size=output_size,
                        data_format=data_format or self._format)

    def forward(self, x, indices):
        return getattr(F, self._fn)(x, indices, **self._kw)


class MaxUnPool1D(_UnPool):
    _fn, _format = "max_unpool1d", "NCL"


class MaxUnPool2D(_UnPool):
    _fn, _format = "max_unpool2d", "NCHW"


class MaxUnPool3D(_UnPool):
    _fn, _format = "max_unpool3d", "NCDHW"


class Softmax2D(Layer):
    """Softmax over the channels of [C, H, W] or [N, C, H, W] inputs."""

    def forward(self, x):
        if x.ndim not in (3, 4):
            raise ValueError(f"Softmax2D expects a 3-D or 4-D input, got "
                             f"{x.ndim}-D")
        return F.softmax(x, axis=-3)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.thresholded_relu(x, self._threshold)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self._kw = dict(p=p, epsilon=epsilon, keepdim=keepdim)

    def forward(self, x, y):
        return F.pairwise_distance(x, y, **self._kw)


class SoftMarginLoss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.soft_margin_loss(input, label, self._reduction)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self._weight = weight
        self._reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.multi_label_soft_margin_loss(input, label,
                                              _raw(self._weight),
                                              self._reduction)


class TripletMarginWithDistanceLoss(Layer):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self._kw = dict(distance_function=distance_function, margin=margin,
                        swap=swap, reduction=reduction)

    def forward(self, input, positive, negative):  # noqa: A002
        return F.triplet_margin_with_distance_loss(input, positive,
                                                   negative, **self._kw)


class HSigmoidLoss(Layer):
    """The hierarchical sigmoid head: ``weight`` [num_classes - 1,
    feature_size] and ``bias`` [num_classes - 1, 1], one row per internal
    node of the tree."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        if num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        self._num_classes = num_classes
        self.weight = self.create_parameter(
            (num_classes - 1, feature_size), attr=weight_attr)
        self.bias = self.create_parameter((num_classes - 1, 1),
                                          attr=bias_attr, is_bias=True)

    def forward(self, input, label, path_table=None,  # noqa: A002
                path_code=None):
        p = self._parameters
        return F.hsigmoid_loss(input, label, self._num_classes, p["weight"],
                               p.get("bias"), path_table, path_code)


# -- seq2seq decoding ---------------------------------------------------------

class BeamSearchDecoder:
    """Beam search over a step cell ``cell(inputs, states) -> (output,
    new_states)``, with the ``embedding_fn`` / ``output_fn`` hooks; run it
    with ``dynamic_decode``."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def initialize(self, initial_states, batch_size):
        """Start tokens, log-probabilities (beam 0 live, the others at
        -1e9), finished flags, the states as given."""
        k = self.beam_size
        tokens = np.full((batch_size, k), self.start_token, np.int64)
        log_probs = np.full((batch_size, k), -1e9, np.float64)
        log_probs[:, 0] = 0.0
        finished = np.zeros((batch_size, k), bool)
        return tokens, log_probs, finished, initial_states

    def step(self, tokens, states):
        """The cell on the ``[B * k]`` tokens (a Tensor on the current
        place); returns the host ``[B * k, V]`` log-probabilities (one
        read) and the new states."""
        inp = Tensor(tokens.reshape(-1))
        if self.embedding_fn is not None:
            inp = self.embedding_fn(inp)
        out, new_states = self.cell(inp, states)
        if self.output_fn is not None:
            out = self.output_fn(out)
        logits = _raw(out)
        logits = logits if isinstance(logits, torch.Tensor) \
            else torch.as_tensor(np.asarray(logits))
        logp = torch.log_softmax(logits.detach(), dim=-1)
        return logp.float().cpu().numpy(), new_states


def _reorder_states(states, beam_src, b, k):
    """Every ``[b * k, ...]`` leaf of the cell state gathered along the
    beam axis, so each hidden state follows the beam that produced it."""
    flat = beam_src + np.arange(b)[:, None] * k
    idx = flat.reshape(-1)

    def gather(leaf):
        val = _raw(leaf)
        if getattr(val, "ndim", 0) < 1 or val.shape[0] != b * k:
            return leaf
        if isinstance(val, torch.Tensor):
            out = val[torch.as_tensor(idx, device=val.device)]
            return Tensor._wrap(out) if isinstance(leaf, Tensor) else out
        return np.asarray(val)[idx]

    def walk(s):
        if isinstance(s, dict):
            return {key: walk(v) for key, v in s.items()}
        if isinstance(s, (list, tuple)):
            return type(s)(walk(v) for v in s)
        return gather(s)

    return walk(states)


def dynamic_decode(decoder, inits=None, max_step_num=None, batch_size=1,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Run ``decoder`` until every beam finishes or ``max_step_num``
    steps; returns (token ids [B, T, beam], final log-probabilities [B,
    beam]) and the lengths with ``return_length``, as Tensors on the
    current place."""
    if max_step_num is None:
        raise ValueError("max_step_num is required")
    tokens, log_probs, finished, states = decoder.initialize(inits,
                                                             batch_size)
    b, k = tokens.shape
    history = []
    lengths = np.zeros((b, k), np.int64)
    for _ in range(int(max_step_num)):
        logp, states = decoder.step(tokens, states)
        v = logp.shape[-1]
        logp = logp.reshape(b, k, v)
        end_only = np.full((v,), -1e9)
        end_only[decoder.end_token] = 0.0
        step_logp = np.where(finished[:, :, None], end_only[None, None],
                             logp)
        flat = (log_probs[:, :, None] + step_logp).reshape(b, k * v)
        top = np.argsort(-flat, axis=1)[:, :k]
        log_probs = np.take_along_axis(flat, top, axis=1)
        beam_src = top // v
        tokens = (top % v).astype(np.int64)
        states = _reorder_states(states, beam_src, b, k)
        finished = np.take_along_axis(finished, beam_src, axis=1) | (
            tokens == decoder.end_token)
        lengths = np.take_along_axis(lengths, beam_src, axis=1) + (
            ~finished).astype(np.int64)
        history = [np.take_along_axis(h, beam_src, axis=1) for h in history]
        history.append(tokens)
        if finished.all():
            break
    out = np.stack(history, axis=1)                     # [b, T, k]
    if output_time_major:
        out = out.transpose(1, 0, 2)
    ids, scores = Tensor(out), Tensor(log_probs)
    if return_length:
        return ids, scores, Tensor(lengths)
    return ids, scores

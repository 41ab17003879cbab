"""paddle.text of the port (``paddle_tpu.text`` counterpart): viterbi
decoding for sequence labeling (ViterbiDecoder at
text/viterbi_decode.py:93 in the reference, over the port's
``viterbi_decode`` op) and the text datasets (``text/datasets.py``, the
JAX module's copy)."""
from __future__ import annotations

import torch

from ..core.tensor import Tensor
from ..nn.layer_base import Layer

from .datasets import (Conll05st, Imdb, Imikolov,  # noqa: F401
                       Movielens, UCIHousing, WMT14, WMT16)

__all__ = ["viterbi_decode", "ViterbiDecoder", "Imdb", "Imikolov",
           "UCIHousing", "Movielens", "Conll05st", "WMT14", "WMT16"]


def viterbi_decode(potentials, transition_params, lengths=None,
                   include_bos_eos_tag=True, name=None):
    """viterbi_decode op parity: returns (scores, best_paths).

    potentials: [B, T, N] emission scores; transition_params: [N, N] (when
    include_bos_eos_tag, row N-1 is the start/BOS transition and row N-2
    the stop/EOS transition); lengths: [B] int actual lengths.  Torch
    tensors in give torch tensors out; surface Tensors or host arrays in
    give surface Tensors out (the paths with ``stop_gradient``), as the
    JAX function returns.  Delegates to ``ops.extended.viterbi_decode``.
    """
    from ..ops.extended import viterbi_decode as _op

    def surface(v):
        return v if isinstance(v, (Tensor, torch.Tensor)) else \
            Tensor._wrap(torch.as_tensor(v))

    pot, trans = surface(potentials), surface(transition_params)
    if lengths is not None:
        lengths = surface(lengths)
    scores, paths = _op(pot, trans, lengths=lengths,
                        include_bos_eos_tag=include_bos_eos_tag)
    if isinstance(paths, Tensor):
        paths.stop_gradient = True
    return scores, paths


class ViterbiDecoder(Layer):
    """text/viterbi_decode.py:93 parity."""

    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        super().__init__()
        self.transitions = transitions
        self.include_bos_eos_tag = include_bos_eos_tag

    def forward(self, potentials, lengths=None):
        trans = self.transitions
        if isinstance(trans, Tensor):      # the forward reads torch values
            trans = trans._value
        return viterbi_decode(potentials, trans, lengths,
                              self.include_bos_eos_tag)


from . import datasets  # noqa: F401,E402

"""paddle.dataset.imikolov — legacy readers (reference
python/paddle/dataset/imikolov.py: train/test/build_dict).  Delegates to
paddle.text.datasets.Imikolov (local PTB simple-examples tar)."""
from __future__ import annotations

import numpy as np

__all__ = ["train", "test", "build_dict"]


def build_dict(min_word_freq=50, data_file=None):
    from ..text.datasets import Imikolov
    ds = Imikolov(data_file=data_file, mode="train",
                  min_word_freq=min_word_freq)
    return ds.word_idx


def _creator(mode, word_idx, n, data_type, data_file):
    from ..text.datasets import Imikolov

    def reader():
        ds = Imikolov(data_file=data_file, data_type=data_type,
                      window_size=n, mode=mode)
        for sample in ds:
            yield tuple(np.asarray(s) for s in sample) \
                if isinstance(sample, (list, tuple)) else np.asarray(sample)

    return reader


def train(word_idx=None, n=5, data_type="NGRAM", data_file=None):
    return _creator("train", word_idx, n, data_type, data_file)


def test(word_idx=None, n=5, data_type="NGRAM", data_file=None):
    return _creator("test", word_idx, n, data_type, data_file)

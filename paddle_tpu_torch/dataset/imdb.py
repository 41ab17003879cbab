"""paddle.dataset.imdb — legacy readers (reference
python/paddle/dataset/imdb.py: train/test/word_dict).  Delegates to
paddle.text.datasets.Imdb (local aclImdb tar)."""
from __future__ import annotations

import numpy as np

__all__ = ["train", "test", "word_dict"]


def _ds(mode, data_file, cutoff=150):
    from ..text.datasets import Imdb
    return Imdb(data_file=data_file, mode=mode, cutoff=cutoff)


def word_dict(data_file=None, cutoff=150):
    """Vocabulary dict word -> id (imdb.py word_dict)."""
    return _ds("train", data_file, cutoff).word_idx


def _creator(mode, data_file):
    def reader():
        for ids, label in _ds(mode, data_file):
            yield np.asarray(ids, np.int64), int(np.asarray(label))

    return reader


def train(word_idx=None, data_file=None):
    return _creator("train", data_file)


def test(word_idx=None, data_file=None):
    return _creator("test", data_file)

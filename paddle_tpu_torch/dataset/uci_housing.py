"""paddle.dataset.uci_housing — legacy readers (reference
python/paddle/dataset/uci_housing.py: train:92, test:117).  Samples:
(float32 features[13], float32 target[1]); delegates to
paddle.text.datasets.UCIHousing."""
from __future__ import annotations

import numpy as np

__all__ = ["train", "test"]


def _creator(mode, data_file):
    from ..text.datasets import UCIHousing

    def reader():
        ds = UCIHousing(data_file=data_file, mode=mode)
        for feat, target in ds:
            yield np.asarray(feat, np.float32), np.asarray(target, np.float32)

    return reader


def train(data_file=None):
    return _creator("train", data_file)


def test(data_file=None):
    return _creator("test", data_file)

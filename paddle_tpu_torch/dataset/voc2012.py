"""paddle.dataset.voc2012 — legacy readers (reference
python/paddle/dataset/voc2012.py: train:74, val:98).  Delegates to
paddle.vision.datasets.VOC2012 (local VOCtrainval tar)."""
from __future__ import annotations

import numpy as np

__all__ = ["train", "val", "test"]


def _creator(mode, data_file):
    from ..vision.datasets import VOC2012

    def reader():
        ds = VOC2012(data_file=data_file, mode=mode)
        for img, label in ds:
            yield np.asarray(img), np.asarray(label)

    return reader


def train(data_file=None):
    return _creator("train", data_file)


def val(data_file=None):
    return _creator("valid", data_file)


def test(data_file=None):
    return _creator("test", data_file)

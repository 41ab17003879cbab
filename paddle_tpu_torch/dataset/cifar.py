"""paddle.dataset.cifar — legacy reader creators (reference
python/paddle/dataset/cifar.py: train10:121, test10:144, train100:81,
test100:101).  Samples: (float32 image/255 flattened [3072], int label).
Delegates to paddle.vision.datasets.Cifar10/Cifar100 (local tar)."""
from __future__ import annotations

import numpy as np

__all__ = ["train10", "test10", "train100", "test100"]


def _creator(cls_name, data_file, mode, cycle=False):
    from ..vision import datasets as vds

    def reader():
        ds = getattr(vds, cls_name)(data_file=data_file, mode=mode)
        while True:
            for img, label in ds:
                img = np.asarray(img, np.float32).reshape(-1) / 255.0
                yield img, int(np.asarray(label).reshape(()))
            if not cycle:
                break

    return reader


def train10(data_file=None, cycle=False):
    return _creator("Cifar10", data_file, "train", cycle)


def test10(data_file=None, cycle=False):
    return _creator("Cifar10", data_file, "test", cycle)


def train100(data_file=None):
    return _creator("Cifar100", data_file, "train")


def test100(data_file=None):
    return _creator("Cifar100", data_file, "test")

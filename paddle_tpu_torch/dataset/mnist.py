"""paddle.dataset.mnist — legacy reader creators (reference
python/paddle/dataset/mnist.py: train:~80, test, reader_creator).
Samples are (flattened [-1,1] float32 image[784], int label), exactly
the reference's normalization.  Delegates to
paddle.vision.datasets.MNIST (local idx-ubyte files)."""
from __future__ import annotations

import numpy as np

__all__ = ["train", "test"]


def reader_creator(image_path, label_path, buffer_size=100):
    from ..vision.datasets import MNIST

    def reader():
        ds = MNIST(image_path=image_path, label_path=label_path)
        for img, label in ds:
            img = np.asarray(img, np.float32).reshape(-1)
            yield img / 127.5 - 1.0, int(np.asarray(label).reshape(()))

    return reader


def train(image_path=None, label_path=None):
    """Training reader creator.  The reference downloads; pass the local
    train-images/train-labels idx files here instead (no egress)."""
    return reader_creator(image_path, label_path)


def test(image_path=None, label_path=None):
    return reader_creator(image_path, label_path)

"""paddle.dataset.flowers — legacy reader creators (reference
python/paddle/dataset/flowers.py: train:152, test:185, valid:218).
Samples: (image array, 0-based int label); delegates to
paddle.vision.datasets.Flowers (local 102flowers tars)."""
from __future__ import annotations

import numpy as np

__all__ = ["train", "test", "valid"]


def _creator(mode, data_file, label_file, setid_file, mapper=None,
             cycle=False):
    from ..vision.datasets import Flowers

    def reader():
        ds = Flowers(data_file=data_file, label_file=label_file,
                     setid_file=setid_file, mode=mode)
        while True:
            for img, label in ds:
                sample = (np.asarray(img), int(np.asarray(label).reshape(())))
                yield mapper(*sample) if mapper is not None else sample
            if not cycle:
                break

    return reader


def train(mapper=None, buffered_size=1024, use_xmap=False, cycle=False,
          data_file=None, label_file=None, setid_file=None):
    return _creator("train", data_file, label_file, setid_file, mapper,
                    cycle)


def test(mapper=None, buffered_size=1024, use_xmap=False, cycle=False,
         data_file=None, label_file=None, setid_file=None):
    return _creator("test", data_file, label_file, setid_file, mapper, cycle)


def valid(mapper=None, buffered_size=1024, use_xmap=False,
          data_file=None, label_file=None, setid_file=None):
    return _creator("valid", data_file, label_file, setid_file, mapper)

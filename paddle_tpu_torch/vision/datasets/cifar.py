"""Cifar10/100 — parity with python/paddle/vision/datasets/cifar.py
(python-pickle batch format), local files only."""
from __future__ import annotations

import os
import pickle
import tarfile

import numpy as np

from ...io.dataset import Dataset


class Cifar10(Dataset):
    _LABEL_KEY = b"labels"

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        if data_file is None:
            raise ValueError(
                "cifar: this build has no network egress; pass the local "
                "cifar tar.gz path as data_file")
        if not os.path.exists(data_file):
            raise FileNotFoundError(data_file)
        self.mode = mode
        self.transform = transform
        self.data = []
        with tarfile.open(data_file) as tf:
            for member in tf.getmembers():
                name = os.path.basename(member.name)
                if (mode == "train" and ("data_batch" in name or
                                         name == "train")) or \
                        (mode == "test" and ("test_batch" in name or
                                             name == "test")):
                    batch = pickle.load(tf.extractfile(member),
                                        encoding="bytes")
                    images = batch[b"data"].reshape(-1, 3, 32, 32)
                    labels = batch.get(self._LABEL_KEY,
                                       batch.get(b"fine_labels"))
                    for img, lbl in zip(images, labels):
                        self.data.append((img, lbl))

    def __getitem__(self, idx):
        img, label = self.data[idx]
        img = img.transpose(1, 2, 0)  # HWC for transforms
        if self.transform is not None:
            img = self.transform(img)
        return img, np.array([label], dtype="int64")

    def __len__(self):
        return len(self.data)


class Cifar100(Cifar10):
    _LABEL_KEY = b"fine_labels"

"""MNIST/FashionMNIST — parity with python/paddle/vision/datasets/mnist.py
(idx-ubyte file parsing), local files only."""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ...io.dataset import Dataset


def _read_idx(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


class MNIST(Dataset):
    NAME = "mnist"

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend=None):
        if download and (image_path is None or label_path is None):
            raise ValueError(
                f"{self.NAME}: this build has no network egress; pass local "
                "image_path/label_path (idx-ubyte, optionally .gz)")
        if image_path is None or label_path is None:
            raise ValueError("image_path and label_path are required")
        if not os.path.exists(image_path) or not os.path.exists(label_path):
            raise FileNotFoundError(f"{image_path} / {label_path}")
        self.mode = mode
        self.transform = transform
        self.images = _read_idx(image_path)
        self.labels = _read_idx(label_path).astype("int64")

    def __getitem__(self, idx):
        img = self.images[idx]
        label = self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, np.array([label], dtype="int64")

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    NAME = "fashion-mnist"

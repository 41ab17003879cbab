"""FakeData — synthetic image classification dataset for tests and smoke
training (fills the role of the reference's fake readers in tests)."""
from __future__ import annotations

import numpy as np

from ...io.dataset import Dataset


class FakeData(Dataset):
    def __init__(self, size=100, image_shape=(3, 224, 224), num_classes=10,
                 transform=None, seed=0):
        self.size = size
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        self.seed = seed

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed + idx)
        img = rng.standard_normal(self.image_shape).astype("float32")
        label = np.array([int(rng.integers(0, self.num_classes))], "int64")
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return self.size

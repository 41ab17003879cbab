"""Flowers — parity with python/paddle/vision/datasets/flowers.py, local
files only.  The reference reads scipy .mat label/setid files; this no-scipy
build accepts .npy/.npz equivalents (labels: [N] int array, 1-based like the
original; setid: npz with 'trnid'/'valid'/'tstid' or a plain index array)."""
from __future__ import annotations

import io
import os
import tarfile

import numpy as np

from ...io.dataset import Dataset

_MODE_KEY = {"train": "trnid", "valid": "valid", "test": "tstid"}


class Flowers(Dataset):
    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=False, backend=None):
        if data_file is None:
            raise ValueError(
                "flowers: this build has no network egress; pass local "
                "data_file/label_file/setid_file paths")
        for p in (data_file, label_file, setid_file):
            if p is not None and not os.path.exists(p):
                raise FileNotFoundError(p)
        self.transform = transform
        self.mode = mode
        self._tar = tarfile.open(data_file)
        names = sorted(m.name for m in self._tar.getmembers() if m.isfile())
        self.labels = np.load(label_file) if label_file else None

        if setid_file is not None:
            setid = np.load(setid_file)
            if hasattr(setid, "files"):  # npz with per-split keys
                idxs = setid[_MODE_KEY[mode]]
            else:
                idxs = setid
            # reference setids are 1-based image numbers
            self._indices = [int(i) - 1 for i in np.ravel(idxs)]
        else:
            self._indices = list(range(len(names)))
        self._names = names

    def __getitem__(self, idx):
        i = self._indices[idx]
        data = self._tar.extractfile(self._names[i]).read()
        try:
            from PIL import Image
            img = np.asarray(Image.open(io.BytesIO(data)))
        except ImportError as e:  # pragma: no cover
            raise RuntimeError("Flowers requires PIL for jpeg decode") from e
        if self.transform is not None:
            img = self.transform(img)
        label = int(self.labels[i]) if self.labels is not None else -1
        return img, np.array([label], "int64")

    def __len__(self):
        return len(self._indices)

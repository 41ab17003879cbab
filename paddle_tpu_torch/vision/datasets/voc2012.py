"""VOC2012 segmentation dataset — parity with
python/paddle/vision/datasets/voc2012.py (parses the VOCtrainval tar:
JPEGImages/*.jpg + SegmentationClass/*.png keyed by the ImageSets/
Segmentation/{train,val,trainval}.txt lists), local archive only.

Images decode through Pillow when available; without it the dataset still
indexes the archive and raises a clear error on access.
"""
from __future__ import annotations

import io
import os
import tarfile
from typing import Optional

import numpy as np

from ...io.dataset import Dataset

__all__ = ["VOC2012"]

_SETS = {"train": "train.txt", "valid": "val.txt", "test": "trainval.txt"}


class VOC2012(Dataset):
    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 transform=None, download: bool = False, backend=None):
        if data_file is None:
            raise ValueError(
                "VOC2012: this build has no network egress; pass data_file= "
                "pointing at the locally-downloaded VOCtrainval tar")
        if not os.path.exists(data_file):
            raise FileNotFoundError(data_file)
        if mode not in _SETS:
            raise ValueError(f"mode must be one of {sorted(_SETS)}")
        if backend not in (None, "numpy"):
            # decoding always yields ndarrays; reject backends whose return
            # type we would silently betray ('pil' images, 'cv2') loudly
            raise ValueError(f"unsupported backend {backend!r}; this build "
                             "returns numpy arrays (use None or 'numpy')")
        self.transform = transform
        self._tar_path = data_file
        # one TarFile per (pid) — forked DataLoader workers must not share
        # the parent's file offset (concurrent extractfile would interleave)
        self._tars: dict = {}
        tar = self._tar()
        try:
            names = {m.name: m for m in tar.getmembers()}
            list_name = next(
                (n for n in names
                 if n.endswith(f"ImageSets/Segmentation/{_SETS[mode]}")),
                None)
            if list_name is None:
                raise ValueError(
                    f"archive has no ImageSets/Segmentation/{_SETS[mode]}")
            ids = tar.extractfile(names[list_name]).read().decode().split()
        except Exception:
            self.close()
            raise
        root = list_name.split("ImageSets/")[0]
        self._pairs = []
        for i in ids:
            img = f"{root}JPEGImages/{i}.jpg"
            seg = f"{root}SegmentationClass/{i}.png"
            if img in names and seg in names:
                self._pairs.append((names[img], names[seg]))

    def _tar(self) -> tarfile.TarFile:
        pid = os.getpid()
        tar = self._tars.get(pid)
        if tar is None:
            tar = tarfile.open(self._tar_path, "r:*")
            self._tars[pid] = tar
        return tar

    def close(self) -> None:
        for tar in self._tars.values():
            try:
                tar.close()
            except OSError:
                pass
        self._tars.clear()

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass

    def _decode(self, member) -> np.ndarray:
        data = self._tar().extractfile(member).read()
        try:
            from PIL import Image
        except ImportError as e:  # pragma: no cover - PIL present here
            raise RuntimeError(
                "VOC2012 image decoding needs Pillow") from e
        return np.asarray(Image.open(io.BytesIO(data)))

    def __getitem__(self, idx):
        img_m, seg_m = self._pairs[idx]
        image = self._decode(img_m)
        label = self._decode(seg_m)
        if self.transform is not None:
            image = self.transform(image)
        return image, label

    def __len__(self):
        return len(self._pairs)

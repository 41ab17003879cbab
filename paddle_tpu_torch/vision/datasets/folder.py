"""Directory-tree image datasets (reference:
python/paddle/vision/datasets/folder.py:65 `DatasetFolder`, :297
`ImageFolder`) — the entry point of every reference CV recipe that trains
on a local directory of images.

Layout contracts:

``DatasetFolder``: ``root/<class_x>/**/*.ext`` — one sub-directory per
class, classes sorted by name to form `class_to_idx`; samples are
``(path, class_index)`` walked in sorted order.

``ImageFolder``: every valid file under ``root`` (recursively, sorted), no
labels — ``__getitem__`` returns ``[sample]`` like the reference.
"""
from __future__ import annotations

import os

from ...io import Dataset

__all__ = ["DatasetFolder", "ImageFolder", "has_valid_extension",
           "make_dataset", "IMG_EXTENSIONS", "default_loader", "pil_loader"]

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp")


def has_valid_extension(filename, extensions):
    """True when `filename` ends with one of `extensions` (case-folded)."""
    assert isinstance(extensions, (list, tuple)), \
        "`extensions` must be list or tuple."
    lowered = filename.lower()
    return any(lowered.endswith(str(ext).lower()) for ext in extensions)


def _walk_files(base):
    """Every file under `base` in the deterministic (sorted dirs, sorted
    names, symlinks followed) order the folder datasets contract fixes."""
    for root, _, fnames in sorted(os.walk(base, followlinks=True)):
        for fname in sorted(fnames):
            yield os.path.join(root, fname)


def make_dataset(dir, class_to_idx, extensions, is_valid_file=None):  # noqa: A002
    """Walk `dir/<class>/**` collecting (path, class_index) pairs in sorted
    order (folder.py make_dataset contract).  `extensions`, when given,
    replaces `is_valid_file` with the extension predicate."""
    base = os.path.expanduser(dir)
    if extensions is not None:
        def is_valid_file(path):  # noqa: F811
            return has_valid_extension(path, extensions)
    samples = []
    for target, idx in sorted(class_to_idx.items()):
        class_dir = os.path.join(base, target)
        if not os.path.isdir(class_dir):
            continue
        samples.extend((path, idx) for path in _walk_files(class_dir)
                       if is_valid_file(path))
    return samples


def pil_loader(path):
    from PIL import Image
    with open(path, "rb") as f:
        return Image.open(f).convert("RGB")


def cv2_loader(path):
    import cv2
    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)


def default_loader(path):
    from .. import get_image_backend  # deferred: vision imports datasets
    return cv2_loader(path) if get_image_backend() == "cv2" \
        else pil_loader(path)


class DatasetFolder(Dataset):
    """folder.py:65 parity: one class per sub-directory of `root`.

    Attributes: classes, class_to_idx, samples [(path, idx)], targets.
    """

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        # the documented contract: extensions and is_valid_file are
        # mutually exclusive; the default extension list applies only when
        # no predicate is given (otherwise the predicate would be silently
        # shadowed by the extension filter inside make_dataset)
        if extensions is not None and is_valid_file is not None:
            raise ValueError(
                "Both `extensions` and `is_valid_file` should not be "
                "passed.")
        if extensions is None and is_valid_file is None:
            extensions = IMG_EXTENSIONS
        classes, class_to_idx = self._find_classes(root)
        samples = make_dataset(root, class_to_idx, extensions, is_valid_file)
        if len(samples) == 0:
            raise RuntimeError(
                f"Found 0 directories in subfolders of: {root}\n"
                "Supported extensions are: "
                + ",".join(extensions or ()))
        self.loader = default_loader if loader is None else loader
        self.extensions = extensions
        self.classes = classes
        self.class_to_idx = class_to_idx
        self.samples = samples
        self.targets = [s[1] for s in samples]

    @staticmethod
    def _find_classes(dir):  # noqa: A002
        classes = sorted(d.name for d in os.scandir(dir) if d.is_dir())
        return classes, {c: i for i, c in enumerate(classes)}

    def __getitem__(self, index):
        path, target = self.samples[index]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """folder.py:297 parity: every valid file under `root`, unlabeled;
    items are returned as a one-element list like the reference."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        if extensions is not None and is_valid_file is not None:
            raise ValueError(
                "Both `extensions` and `is_valid_file` should not be "
                "passed.")
        if extensions is None and is_valid_file is None:
            extensions = IMG_EXTENSIONS
        if is_valid_file is None:
            def is_valid_file(path):
                return has_valid_extension(path, extensions)
        samples = [path for path in _walk_files(os.path.expanduser(root))
                   if is_valid_file(path)]
        if len(samples) == 0:
            raise RuntimeError(
                f"Found 0 files in subfolders of: {root}\n"
                "Supported extensions are: "
                + ",".join(extensions or ()))
        self.loader = default_loader if loader is None else loader
        self.extensions = extensions
        self.samples = samples
        self.transform = transform

    def __getitem__(self, index):
        sample = self.loader(self.samples[index])
        if self.transform is not None:
            sample = self.transform(sample)
        return [sample]

    def __len__(self):
        return len(self.samples)

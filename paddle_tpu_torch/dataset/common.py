"""paddle.dataset.common — parity with python/paddle/dataset/common.py
(DATA_HOME:44, md5file:66, download:75, split:142,
cluster_files_reader:180).  `download` verifies a LOCAL cache instead of
fetching: this build has no network egress."""
from __future__ import annotations

import glob
import hashlib
import os
import pickle

DATA_HOME = os.path.expanduser(os.path.join("~", ".cache", "paddle",
                                            "dataset"))

__all__ = ["DATA_HOME", "md5file", "download", "must_mkdirs", "split",
           "cluster_files_reader"]


def must_mkdirs(path):
    os.makedirs(path, exist_ok=True)


def md5file(fname):
    hash_md5 = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            hash_md5.update(chunk)
    return hash_md5.hexdigest()


def download(url, module_name, md5sum, save_name=None):
    """Resolve the file in the local DATA_HOME cache (reference
    common.py:75 downloads on miss; here a miss raises with instructions
    — no egress)."""
    dirname = os.path.join(DATA_HOME, module_name)
    filename = os.path.join(
        dirname, url.split("/")[-1] if save_name is None else save_name)
    if os.path.exists(filename):
        if md5sum and md5file(filename) != md5sum:
            raise IOError(f"{filename} exists but its md5 does not match "
                          f"{md5sum}; remove or replace the file")
        return filename
    raise IOError(
        f"this build has no network egress: place the file from {url} at "
        f"{filename} (md5 {md5sum}) and retry")


def split(reader, line_count, suffix="%05d.pickle", dumper=pickle.dump):
    """Split a reader's samples into pickled chunk files of `line_count`
    samples each; returns nothing (files land in cwd, reference
    semantics)."""
    indx_f = 0
    lines = []
    for i, d in enumerate(reader()):
        lines.append(d)
        if (i + 1) % line_count == 0:
            with open(suffix % indx_f, "wb") as f:
                dumper(lines, f)
            lines = []
            indx_f += 1
    if lines:
        with open(suffix % indx_f, "wb") as f:
            dumper(lines, f)


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=pickle.load):
    """Read this trainer's shard of the chunk files split() produced."""
    def reader():
        flist = sorted(glob.glob(files_pattern))
        my = flist[trainer_id::trainer_count]
        for fn in my:
            with open(fn, "rb") as f:
                lines = loader(f)
                for line in lines:
                    yield line

    return reader

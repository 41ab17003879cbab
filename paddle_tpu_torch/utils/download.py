"""``paddle_tpu.utils.download`` counterpart: ``get_path_from_url``
resolves and unpacks LOCAL files only, as the JAX package's does: a URL
that is not a local path needs its file placed under ``root_dir`` first,
and a missing file raises.  It downloads nothing.

The ``md5sum`` argument is checked before the archive is trusted, and
archive members whose resolved path leaves ``root_dir`` (``../`` or
absolute names, links out, device files) are refused before extraction.
"""
from __future__ import annotations

import os
import tarfile
import zipfile

__all__ = ["get_weights_path_from_url", "get_path_from_url"]


def _md5check(fname, md5sum):
    if md5sum is None:
        return
    from ..dataset.common import md5file
    got = md5file(fname)
    if got != md5sum:
        raise IOError(
            f"md5 mismatch for {fname}: expected {md5sum}, got {got}")


def _check_members(names, root_dir):
    root = os.path.realpath(root_dir)
    for name in names:
        dest = os.path.realpath(os.path.join(root_dir, name))
        if not (dest == root or dest.startswith(root + os.sep)):
            raise IOError(
                f"archive member {name!r} escapes extraction root "
                f"{root_dir!r}; refusing to extract")


def get_path_from_url(url, root_dir, md5sum=None, check_exist=True,
                      decompress=True):
    fname = os.path.join(root_dir, os.path.basename(url))
    if os.path.exists(url):              # already a local path
        fname = url
    elif not os.path.exists(fname):
        raise IOError(
            f"no network egress: place {os.path.basename(url)} under "
            f"{root_dir} (from {url}) and retry")
    _md5check(fname, md5sum)
    if decompress and tarfile.is_tarfile(fname):
        with tarfile.open(fname) as tf:
            names = tf.getnames()
            _check_members(names, root_dir)
            for m in tf.getmembers():
                # internal relative links are fine (pkg/latest -> v1.0);
                # only targets resolving outside root are refused
                if m.isdev():     # CHR/BLK devices and FIFOs
                    # match the 3.12+ filter='data' policy on older Pythons
                    raise IOError(
                        f"archive member {m.name!r} is a special file "
                        f"(device/FIFO); refusing")
                if m.issym() or m.islnk():
                    if m.issym():
                        resolved = os.path.normpath(os.path.join(
                            os.path.dirname(m.name), m.linkname))
                    else:            # hardlink target is archive-root-relative
                        resolved = os.path.normpath(m.linkname)
                    if os.path.isabs(m.linkname) or resolved == ".." \
                            or resolved.startswith(".." + os.sep):
                        raise IOError(
                            f"archive member {m.name!r} links to "
                            f"{m.linkname!r} outside the extraction root; "
                            f"refusing")
            try:
                tf.extractall(root_dir, filter="data")
            except TypeError:        # Python < 3.12: no filter kwarg
                tf.extractall(root_dir)
        return os.path.join(root_dir, names[0].split("/")[0])
    if decompress and zipfile.is_zipfile(fname):
        with zipfile.ZipFile(fname) as zf:
            names = zf.namelist()
            _check_members(names, root_dir)
            zf.extractall(root_dir)
        return os.path.join(root_dir, names[0].split("/")[0])
    return fname


def get_weights_path_from_url(url, md5sum=None):
    home = os.path.expanduser("~/.cache/paddle/weights")
    os.makedirs(home, exist_ok=True)
    return get_path_from_url(url, home, md5sum)

"""paddle.dataset.wmt14 — legacy readers (reference
python/paddle/dataset/wmt14.py: train/test/gen).  Delegates to
paddle.text.datasets.WMT14 (local tar)."""
from __future__ import annotations

__all__ = ["train", "test", "gen"]


def _creator(mode, dict_size, data_file):
    from ..text.datasets import WMT14

    def reader():
        ds = WMT14(data_file=data_file, mode=mode, dict_size=dict_size)
        for sample in ds:
            yield sample

    return reader


def train(dict_size, data_file=None):
    return _creator("train", dict_size, data_file)


def test(dict_size, data_file=None):
    return _creator("test", dict_size, data_file)


def gen(dict_size, data_file=None):
    return _creator("gen", dict_size, data_file)

"""paddle.dataset.movielens — legacy readers (reference
python/paddle/dataset/movielens.py: train/test + metadata helpers).
Delegates to paddle.text.datasets.Movielens (local ml-1m.zip)."""
from __future__ import annotations

import numpy as np

__all__ = ["train", "test", "get_movie_title_dict", "max_movie_id",
           "max_user_id", "max_job_id", "movie_categories"]

_cache = {}


def _ds(mode, data_file):
    key = (mode, data_file)
    if key not in _cache:
        from ..text.datasets import Movielens
        _cache[key] = Movielens(data_file=data_file, mode=mode)
    return _cache[key]


def _creator(mode, data_file):
    def reader():
        for sample in _ds(mode, data_file):
            yield sample

    return reader


def train(data_file=None):
    return _creator("train", data_file)


def test(data_file=None):
    return _creator("test", data_file)


def get_movie_title_dict(data_file=None):
    """Title-word -> id dict (movielens.py get_movie_title_dict)."""
    return _ds("train", data_file).movie_title_dict


def movie_categories(data_file=None):
    return _ds("train", data_file).categories_dict


def max_movie_id(data_file=None):
    return int(max(np.asarray(s[4]) for s in _ds("train", data_file)))


def max_user_id(data_file=None):
    return int(max(np.asarray(s[0]) for s in _ds("train", data_file)))


def max_job_id(data_file=None):
    return int(max(np.asarray(s[3]) for s in _ds("train", data_file)))

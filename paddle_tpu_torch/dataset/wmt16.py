"""paddle.dataset.wmt16 — legacy readers (reference
python/paddle/dataset/wmt16.py: train:148, test:201, validation:254,
get_dict:305).  Delegates to paddle.text.datasets.WMT16 (local tar)."""
from __future__ import annotations

__all__ = ["train", "test", "validation", "get_dict"]


def _creator(mode, src_dict_size, trg_dict_size, src_lang, data_file):
    from ..text.datasets import WMT16

    def reader():
        ds = WMT16(data_file=data_file, mode=mode,
                   src_dict_size=src_dict_size,
                   trg_dict_size=trg_dict_size, lang=src_lang)
        for sample in ds:
            yield sample

    return reader


def train(src_dict_size, trg_dict_size, src_lang="en", data_file=None):
    return _creator("train", src_dict_size, trg_dict_size, src_lang,
                    data_file)


def test(src_dict_size, trg_dict_size, src_lang="en", data_file=None):
    return _creator("test", src_dict_size, trg_dict_size, src_lang,
                    data_file)


def validation(src_dict_size, trg_dict_size, src_lang="en", data_file=None):
    return _creator("val", src_dict_size, trg_dict_size, src_lang,
                    data_file)


def get_dict(lang, dict_size, reverse=False, data_file=None):
    """Word dict for `lang` truncated to dict_size (wmt16.py:305);
    reverse=True returns id -> word."""
    from ..text.datasets import WMT16
    ds = WMT16(data_file=data_file, mode="train",
               src_dict_size=dict_size, trg_dict_size=dict_size, lang=lang)
    d = ds.src_dict if lang == ds.lang else ds.trg_dict
    if reverse:
        return {v: k for k, v in d.items()}
    return dict(d)

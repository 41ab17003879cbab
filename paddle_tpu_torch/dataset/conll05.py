"""paddle.dataset.conll05 — legacy readers (reference
python/paddle/dataset/conll05.py: test/get_dict/get_embedding).
Delegates to paddle.text.datasets.Conll05st (local release tar +
dict files)."""
from __future__ import annotations

__all__ = ["test", "get_dict", "get_embedding"]


def _ds(**kw):
    from ..text.datasets import Conll05st
    return Conll05st(**kw)


def get_dict(data_file=None, word_dict_file=None, verb_dict_file=None,
             target_dict_file=None):
    """(word_dict, verb_dict, label_dict) — conll05.py get_dict."""
    ds = _ds(data_file=data_file, word_dict_file=word_dict_file,
             verb_dict_file=verb_dict_file,
             target_dict_file=target_dict_file)
    return ds.word_dict, ds.predicate_dict, ds.label_dict


def get_embedding(emb_file=None):
    """Path-through of the embedding file (conll05.py get_embedding
    downloads it; here the local path is returned after an existence
    check)."""
    import os
    if emb_file is None or not os.path.exists(emb_file):
        raise IOError("no network egress: pass the local emb_file path")
    return emb_file


def test(data_file=None, word_dict_file=None, verb_dict_file=None,
         target_dict_file=None):
    """CoNLL-2005 SRL test reader (the reference ships only the test
    split through this API too)."""
    def reader():
        ds = _ds(data_file=data_file, word_dict_file=word_dict_file,
                 verb_dict_file=verb_dict_file,
                 target_dict_file=target_dict_file)
        for sample in ds:
            yield sample

    return reader

"""paddle.text.datasets parity — Imdb, Imikolov, UCIHousing, Movielens,
Conll05st, WMT14, WMT16 (the port's copy of ``paddle_tpu/text/datasets.py``).

Reference: python/paddle/text/datasets/{imdb,imikolov,uci_housing,
movielens}.py.  The reference downloads from its mirror at construction;
this build has no network egress, so every dataset takes a local
`data_file` in the SAME archive format the reference downloads, and
parses it identically (tokenization, vocabulary building, rating tuples).
"""
from __future__ import annotations

import os
import re
import tarfile
import zipfile
from collections import Counter
from typing import Dict, List, Optional

import numpy as np

from ..io.dataset import Dataset

__all__ = ["Imdb", "Imikolov", "UCIHousing", "Movielens",
           "Conll05st", "WMT14", "WMT16"]


def _require(data_file: Optional[str], name: str) -> str:
    if data_file is None:
        raise ValueError(
            f"{name}: this build has no network egress; pass data_file= "
            f"pointing at the locally-downloaded archive")
    if not os.path.exists(data_file):
        raise FileNotFoundError(data_file)
    return data_file


class Imdb(Dataset):
    """IMDB sentiment (aclImdb tar.gz layout: aclImdb/<mode>/<pos|neg>/
    *.txt).  Builds the word vocab from the archive like imdb.py, yields
    (ids int64 array, label 0/1)."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 cutoff: int = 150):
        data_file = _require(data_file, "Imdb")
        if mode not in ("train", "test"):
            raise ValueError(f"mode must be train|test, got {mode!r}")
        self.mode = mode
        # vocabulary spans BOTH splits (imdb.py build_dict scans
        # train|test) so train/test instances share word ids; `cutoff` is a
        # minimum-frequency threshold, not a vocab size
        vocab_pat = re.compile(r"aclImdb/(train|test)/(pos|neg)/.*\.txt$")
        pat = re.compile(rf"aclImdb/{mode}/(pos|neg)/.*\.txt$")
        tokenize = re.compile(r"[A-Za-z0-9']+")
        texts: List[List[str]] = []
        labels: List[int] = []
        counter: Counter = Counter()
        with tarfile.open(data_file, "r:*") as tf:
            for member in tf.getmembers():
                vm = vocab_pat.search(member.name)
                if not vm:
                    continue
                words = tokenize.findall(
                    tf.extractfile(member).read().decode(
                        "utf-8", "ignore").lower())
                counter.update(words)
                m = pat.search(member.name)
                if m:
                    texts.append(words)
                    labels.append(0 if m.group(1) == "neg" else 1)
        # frequency-sorted vocab above the cutoff (alphabetical on ties,
        # matching the reference's (-count, word) sort), <unk> = last id
        vocab_words = [w for w, c in sorted(counter.items(),
                                            key=lambda kv: (-kv[1], kv[0]))
                       if c > cutoff]
        self.word_idx: Dict[str, int] = {w: i for i, w in
                                         enumerate(vocab_words)}
        self.word_idx["<unk>"] = len(self.word_idx)
        unk = self.word_idx["<unk>"]
        self.docs = [np.array([self.word_idx.get(w, unk) for w in words],
                              dtype=np.int64) for words in texts]
        self.labels = np.array(labels, dtype=np.int64)

    def __getitem__(self, idx):
        return self.docs[idx], self.labels[idx]

    def __len__(self):
        return len(self.docs)


class Imikolov(Dataset):
    """PTB language-model n-grams (imikolov.py): simple-examples tar.gz
    with ./data/ptb.{train,valid}.txt; data_type NGRAM -> sliding windows
    of `window_size`, SEQ -> whole <s> .. <e> sentences."""

    def __init__(self, data_file: Optional[str] = None, data_type="NGRAM",
                 window_size: int = 5, mode: str = "train",
                 min_word_freq: int = 50):
        data_file = _require(data_file, "Imikolov")
        if data_type not in ("NGRAM", "SEQ"):
            raise ValueError("data_type must be NGRAM or SEQ")
        if mode not in ("train", "test"):
            raise ValueError(f"mode must be train|test, got {mode!r}")
        split = {"train": "train", "test": "valid"}[mode]
        with tarfile.open(data_file, "r:*") as tf:
            train_lines = self._lines(tf, "ptb.train.txt")
            lines = train_lines if split == "train" else \
                self._lines(tf, "ptb.valid.txt")
        counter: Counter = Counter()
        for ln in train_lines:
            counter.update(["<s>"] + ln + ["<e>"])   # markers join the vocab
        counter.pop("<unk>", None)
        vocab = sorted((w for w, c in counter.items()
                        if c >= min_word_freq))
        self.word_idx = {w: i for i, w in enumerate(vocab)}
        self.word_idx["<unk>"] = len(self.word_idx)
        unk = self.word_idx["<unk>"]
        self.data: List[np.ndarray] = []
        for ln in lines:
            ids = [self.word_idx.get(w, unk)
                   for w in (["<s>"] + ln + ["<e>"])]
            if data_type == "NGRAM":
                if len(ids) >= window_size:
                    for i in range(window_size, len(ids) + 1):
                        self.data.append(np.array(ids[i - window_size:i],
                                                  dtype=np.int64))
            else:
                self.data.append(np.array(ids, dtype=np.int64))

    @staticmethod
    def _lines(tf: tarfile.TarFile, name: str) -> List[List[str]]:
        member = next(m for m in tf.getmembers() if m.name.endswith(name))
        raw = tf.extractfile(member).read().decode("utf-8", "ignore")
        return [ln.strip().split() for ln in raw.splitlines() if ln.strip()]

    def __getitem__(self, idx):
        return self.data[idx]

    def __len__(self):
        return len(self.data)


class UCIHousing(Dataset):
    """Boston housing regression (uci_housing.py): whitespace table of 14
    columns, feature-normalized, 80/20 train/test split."""

    FEATURE_DIM = 13

    def __init__(self, data_file: Optional[str] = None, mode: str = "train"):
        data_file = _require(data_file, "UCIHousing")
        raw = np.loadtxt(data_file).astype(np.float32)
        if raw.ndim != 2 or raw.shape[1] != self.FEATURE_DIM + 1:
            raise ValueError(
                f"UCIHousing expects {self.FEATURE_DIM + 1} columns, got "
                f"{raw.shape}")
        # normalize features by train-portion statistics (uci_housing.py
        # max/min/avg normalization)
        split = int(raw.shape[0] * 0.8)
        feats = raw[:, :-1]
        mx, mn, avg = (feats[:split].max(0), feats[:split].min(0),
                       feats[:split].mean(0))
        denom = np.where(mx - mn == 0, 1.0, mx - mn)
        feats = (feats - avg) / denom
        data = np.concatenate([feats, raw[:, -1:]], axis=1)
        self.data = data[:split] if mode == "train" else data[split:]

    def __getitem__(self, idx):
        row = self.data[idx]
        return row[:-1], row[-1:]

    def __len__(self):
        return len(self.data)


class Movielens(Dataset):
    """MovieLens-1M ratings (movielens.py): ml-1m.zip with users.dat /
    movies.dat / ratings.dat ('::' separated); yields (user_id, gender,
    age, job, movie_id, title_ids, category_ids, rating)."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 test_ratio: float = 0.1, rand_seed: int = 0):
        data_file = _require(data_file, "Movielens")
        users: Dict[int, tuple] = {}
        movies: Dict[int, tuple] = {}
        with zipfile.ZipFile(data_file) as zf:
            def read(name):
                member = next(n for n in zf.namelist()
                              if n.endswith(name))
                return zf.read(member).decode("latin1").splitlines()

            categories: Dict[str, int] = {}
            title_words: Dict[str, int] = {}
            for ln in read("movies.dat"):
                mid, title, cats = ln.strip().split("::")
                cat_ids = [categories.setdefault(c, len(categories))
                           for c in cats.split("|")]
                tw = [title_words.setdefault(w, len(title_words))
                      for w in re.findall(r"[A-Za-z0-9']+", title.lower())]
                movies[int(mid)] = (np.array(tw, np.int64),
                                    np.array(cat_ids, np.int64))
            for ln in read("users.dat"):
                uid, gender, age, job, _zip = ln.strip().split("::")
                users[int(uid)] = (0 if gender == "M" else 1, int(age),
                                   int(job))
            rng = np.random.RandomState(rand_seed)
            self.samples = []
            for ln in read("ratings.dat"):
                uid, mid, rating, _ts = ln.strip().split("::")
                uid, mid = int(uid), int(mid)
                if uid not in users or mid not in movies:
                    continue
                is_test = rng.rand() < test_ratio
                if (mode == "test") != is_test:
                    continue
                g, a, j = users[uid]
                tw, cats = movies[mid]
                self.samples.append((np.int64(uid), np.int64(g),
                                     np.int64(a), np.int64(j),
                                     np.int64(mid), tw, cats,
                                     np.float32(rating)))
        self.categories_dict = categories
        self.movie_title_dict = title_words

    def __getitem__(self, idx):
        return self.samples[idx]

    def __len__(self):
        return len(self.samples)


class Conll05st(Dataset):
    """CoNLL-2005 SRL test set (reference text/datasets/conll05.py:43).

    Parses the conll05st-release tar (words/props .gz members), builds the
    B-/I- label dict from the target dictionary file, and yields the
    9-tuple (word_idx, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, pred_idx,
    mark, label_idx) with the reference's predicate-context windows.
    """

    UNK_IDX = 0

    def __init__(self, data_file=None, word_dict_file=None,
                 verb_dict_file=None, target_dict_file=None, emb_file=None,
                 download=False):
        self.data_file = _require(data_file, "Conll05st")
        self.word_dict = self._load_dict(
            _require(word_dict_file, "Conll05st(word_dict_file)"))
        self.predicate_dict = self._load_dict(
            _require(verb_dict_file, "Conll05st(verb_dict_file)"))
        self.label_dict = self._load_label_dict(
            _require(target_dict_file, "Conll05st(target_dict_file)"))
        self.emb_file = emb_file
        self._load_anno()

    @staticmethod
    def _load_dict(filename):
        with open(filename) as f:
            return {line.strip(): i for i, line in enumerate(f)}

    @staticmethod
    def _load_label_dict(filename):
        # the reference collects the B-/I- tag set then enumerates pairs,
        # closing with "O" (conll05.py _load_label_dict)
        tags = set()
        with open(filename) as f:
            for line in f:
                line = line.strip()
                if line.startswith(("B-", "I-")):
                    tags.add(line[2:])
        # sorted: set iteration order is hash-randomized per process, and
        # the label ids must be stable across save/load boundaries
        d, index = {}, 0
        for tag in sorted(tags):
            d["B-" + tag] = index
            d["I-" + tag] = index + 1
            index += 2
        d["O"] = index
        return d

    def _load_anno(self):
        import gzip

        self.sentences, self.predicates, self.labels = [], [], []
        with tarfile.open(self.data_file) as tf:
            wf = tf.extractfile(
                "conll05st-release/test.wsj/words/test.wsj.words.gz")
            pf = tf.extractfile(
                "conll05st-release/test.wsj/props/test.wsj.props.gz")
            with gzip.GzipFile(fileobj=wf) as words_file, \
                    gzip.GzipFile(fileobj=pf) as props_file:
                sentences, labels, one_seg = [], [], []
                for word, label in zip(words_file, props_file):
                    word = word.strip().decode()
                    label = label.strip().decode().split()
                    if label:
                        sentences.append(word)
                        one_seg.append(label)
                        continue
                    # end of sentence: transpose the per-token prop columns
                    for i in range(len(one_seg[0]) if one_seg else 0):
                        labels.append([x[i] for x in one_seg])
                    if labels:
                        verb_list = [x for x in labels[0] if x != "-"]
                        for i, lbl in enumerate(labels[1:]):
                            self.sentences.append(sentences)
                            self.predicates.append(verb_list[i])
                            self.labels.append(self._spans_to_bio(lbl))
                    sentences, labels, one_seg = [], [], []

    @staticmethod
    def _spans_to_bio(lbl):
        """Bracketed span column -> BIO sequence (conll05.py:200-225)."""
        cur_tag, in_bracket, seq = "O", False, []
        for tok in lbl:
            if tok == "*":
                seq.append("I-" + cur_tag if in_bracket else "O")
            elif tok == "*)":
                seq.append("I-" + cur_tag)
                in_bracket = False
            elif "(" in tok and ")" in tok:
                cur_tag = tok[1:tok.find("*")]
                seq.append("B-" + cur_tag)
                in_bracket = False
            elif "(" in tok:
                cur_tag = tok[1:tok.find("*")]
                seq.append("B-" + cur_tag)
                in_bracket = True
            else:
                raise RuntimeError(f"Unexpected label: {tok}")
        return seq

    def __getitem__(self, idx):
        sentence, labels = self.sentences[idx], self.labels[idx]
        predicate = self.predicates[idx]
        n = len(sentence)
        v = labels.index("B-V")
        mark = [0] * len(labels)
        ctx = {}
        for off, key, pad in ((-2, "n2", "bos"), (-1, "n1", "bos"),
                              (0, "0", None), (1, "p1", "eos"),
                              (2, "p2", "eos")):
            j = v + off
            if 0 <= j < len(labels):
                mark[j] = 1
                ctx[key] = sentence[j]
            else:
                ctx[key] = pad
        word_idx = [self.word_dict.get(w, self.UNK_IDX) for w in sentence]
        out = [np.array(word_idx)]
        for key in ("n2", "n1", "0", "p1", "p2"):
            out.append(np.array(
                [self.word_dict.get(ctx[key], self.UNK_IDX)] * n))
        # OOV predicates fall back to UNK like the word path; labels index
        # directly so a tag missing from the target dict fails loudly at
        # parse time instead of yielding object arrays of None
        out.append(np.array(
            [self.predicate_dict.get(predicate, self.UNK_IDX)] * n))
        out.append(np.array(mark))
        out.append(np.array([self.label_dict[w] for w in labels]))
        return tuple(out)

    def __len__(self):
        return len(self.sentences)

    def get_dict(self):
        return self.word_dict, self.predicate_dict, self.label_dict

    def get_embedding(self):
        return self.emb_file


class WMT14(Dataset):
    """WMT14 en-fr subset (reference text/datasets/wmt14.py): tar with
    {train,test,gen}/ members plus src.dict / trg.dict; yields
    (src_ids, trg_ids, trg_ids_next) with <s>/<e> wrapping and the
    reference's len>80 training filter."""

    START, END, UNK_IDX = "<s>", "<e>", 2

    def __init__(self, data_file=None, mode="train", dict_size=-1,
                 download=False):
        if mode.lower() not in ("train", "test", "gen"):
            raise ValueError(
                f"mode should be 'train', 'test' or 'gen', but got {mode}")
        self.mode = mode.lower()
        self.data_file = _require(data_file, "WMT14")
        assert dict_size > 0, "dict_size should be set as positive number"
        self.dict_size = dict_size
        self._load_data()

    def _load_data(self):
        def to_dict(fd, size):
            out = {}
            for i, line in enumerate(fd):
                if i >= size:
                    break
                out[line.strip().decode()] = i
            return out

        self.src_ids, self.trg_ids, self.trg_ids_next = [], [], []
        with tarfile.open(self.data_file) as f:
            names = [m.name for m in f if m.name.endswith("src.dict")]
            assert len(names) == 1
            self.src_dict = to_dict(f.extractfile(names[0]), self.dict_size)
            names = [m.name for m in f if m.name.endswith("trg.dict")]
            assert len(names) == 1
            self.trg_dict = to_dict(f.extractfile(names[0]), self.dict_size)
            suffix = f"{self.mode}/{self.mode}"
            for name in [m.name for m in f if m.name.endswith(suffix)]:
                for line in f.extractfile(name):
                    parts = line.decode().strip().split("\t")
                    if len(parts) != 2:
                        continue
                    src_ids = [self.src_dict.get(w, self.UNK_IDX)
                               for w in [self.START] + parts[0].split()
                               + [self.END]]
                    trg_ids = [self.trg_dict.get(w, self.UNK_IDX)
                               for w in parts[1].split()]
                    if len(src_ids) > 80 or len(trg_ids) > 80:
                        continue
                    self.src_ids.append(src_ids)
                    self.trg_ids_next.append(trg_ids +
                                             [self.trg_dict[self.END]])
                    self.trg_ids.append([self.trg_dict[self.START]] + trg_ids)

    def __getitem__(self, idx):
        return (np.array(self.src_ids[idx]), np.array(self.trg_ids[idx]),
                np.array(self.trg_ids_next[idx]))

    def __len__(self):
        return len(self.src_ids)

    def get_dict(self, reverse=False):
        if reverse:
            return ({v: k for k, v in self.src_dict.items()},
                    {v: k for k, v in self.trg_dict.items()})
        return self.src_dict, self.trg_dict


class WMT16(Dataset):
    """WMT16 Multi30K en-de (reference text/datasets/wmt16.py): tar with
    wmt16/{train,test,val}; builds frequency-ranked dicts headed by
    <s>/<e>/<unk> from the train split (cached beside the archive) and
    yields (src_ids, trg_ids, trg_ids_next)."""

    START_MARK, END_MARK, UNK_MARK = "<s>", "<e>", "<unk>"
    TOTAL_EN_WORDS, TOTAL_DE_WORDS = 11250, 19220

    def __init__(self, data_file=None, mode="train", src_dict_size=-1,
                 trg_dict_size=-1, lang="en", download=False):
        if mode.lower() not in ("train", "test", "val"):
            raise ValueError(
                f"mode should be 'train', 'test' or 'val', but got {mode}")
        self.mode = mode.lower()
        self.data_file = _require(data_file, "WMT16")
        self.lang = lang
        assert src_dict_size > 0 and trg_dict_size > 0, \
            "dict_size should be set as positive number"
        self.src_dict_size = min(src_dict_size, self.TOTAL_EN_WORDS
                                 if lang == "en" else self.TOTAL_DE_WORDS)
        self.trg_dict_size = min(trg_dict_size, self.TOTAL_DE_WORDS
                                 if lang == "en" else self.TOTAL_EN_WORDS)
        self.src_dict = self._load_dict(lang, self.src_dict_size)
        self.trg_dict = self._load_dict("de" if lang == "en" else "en",
                                        self.trg_dict_size)
        self._load_data()

    def _dict_path(self, lang, size):
        return os.path.join(os.path.dirname(os.path.abspath(self.data_file)),
                            f"wmt16_{lang}_{size}.dict")

    def _load_dict(self, lang, dict_size, reverse=False):
        path = self._dict_path(lang, dict_size)
        # the filename encodes dict_size, so any cache at this path was
        # built for this request; a corpus with fewer than dict_size
        # distinct words legitimately yields a shorter file (exact-length
        # checking would rebuild the dict on every construction)
        found = False
        if os.path.exists(path):
            with open(path, "rb") as d:
                n = len(d.readlines())
                found = 3 <= n <= dict_size
        if not found:
            self._build_dict(path, dict_size, lang)
        out = {}
        with open(path, "rb") as f:
            for idx, line in enumerate(f):
                word = line.strip().decode()
                if reverse:
                    out[idx] = word
                else:
                    out[word] = idx
        return out

    def _build_dict(self, path, dict_size, lang):
        counts = Counter()
        col = 0 if lang == "en" else 1
        with tarfile.open(self.data_file) as f:
            for line in f.extractfile("wmt16/train"):
                parts = line.decode().strip().split("\t")
                if len(parts) != 2:
                    continue
                counts.update(parts[col].split())
        with open(path, "w") as fout:
            fout.write(f"{self.START_MARK}\n{self.END_MARK}\n"
                       f"{self.UNK_MARK}\n")
            for idx, (word, _) in enumerate(counts.most_common()):
                if idx + 3 == dict_size:
                    break
                fout.write(word + "\n")

    def _load_data(self):
        start_id = self.src_dict[self.START_MARK]
        end_id = self.src_dict[self.END_MARK]
        unk_id = self.src_dict[self.UNK_MARK]
        src_col = 0 if self.lang == "en" else 1
        self.src_ids, self.trg_ids, self.trg_ids_next = [], [], []
        with tarfile.open(self.data_file) as f:
            for line in f.extractfile(f"wmt16/{self.mode}"):
                parts = line.decode().strip().split("\t")
                if len(parts) != 2:
                    continue
                src_ids = [start_id] + \
                    [self.src_dict.get(w, unk_id)
                     for w in parts[src_col].split()] + [end_id]
                trg_ids = [self.trg_dict.get(w, unk_id)
                           for w in parts[1 - src_col].split()]
                self.src_ids.append(src_ids)
                self.trg_ids_next.append(trg_ids + [end_id])
                self.trg_ids.append([start_id] + trg_ids)

    def __getitem__(self, idx):
        return (np.array(self.src_ids[idx]), np.array(self.trg_ids[idx]),
                np.array(self.trg_ids_next[idx]))

    def __len__(self):
        return len(self.src_ids)

    def get_dict(self, lang, reverse=False):
        size = self.src_dict_size if lang == self.lang else self.trg_dict_size
        return self._load_dict(lang, size, reverse)

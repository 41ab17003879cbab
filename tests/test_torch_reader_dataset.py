"""The port's legacy readers and datasets against the JAX package's, on the
CPU: ``paddle.batch``, every ``paddle.reader`` decorator on the same
seeded readers, every Dataset class of ``vision.datasets`` and
``text.datasets`` and every reader creator of ``paddle.dataset`` on
archives the tests write in the formats the reference downloads (the
JAX tests' archive writers: ``test_text_datasets_mp.py``,
``test_datasets_folder_text.py``, ``test_legacy_namespaces.py``), sample
for sample and vocabulary for vocabulary, plus ``paddle.text``'s
``viterbi_decode`` / ``ViterbiDecoder`` and the image backend switch.
"""
import gzip
import io
import os
import pickle
import random
import struct
import tarfile

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import paddle_tpu as jpaddle
from paddle_tpu import dataset as jdataset
from paddle_tpu import reader as jreader
from paddle_tpu import text as jtext
from paddle_tpu import vision as jvision

import paddle_tpu_torch as paddle
from _torch_cpu_place import cpu_place  # noqa: F401
from paddle_tpu_torch import dataset as pdataset
from paddle_tpu_torch import reader as preader
from paddle_tpu_torch import text as ptext
from paddle_tpu_torch import vision as pvision
from test_datasets_folder_text import _conll_tar, _wmt14_tar
from test_text_datasets_mp import (_make_housing, _make_imdb, _make_ml1m,
                                   _make_ptb)


def _same(a, b, where="sample"):
    """Equal samples: numbers, arrays, PIL images, nested tuples/lists and
    dicts, element for element (and of the same dtype)."""
    if isinstance(a, dict):
        assert a == b, where
        return
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
        return
    if hasattr(a, "getdata"):                   # PIL images
        a, b = np.asarray(a), np.asarray(b)
    if isinstance(a, (np.ndarray, np.generic)):
        assert isinstance(b, (np.ndarray, np.generic)), where
        assert a.dtype == b.dtype, (where, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=where)
        return
    assert type(a) is type(b) and a == b, (where, a, b)


def _same_dataset(jds, pds):
    assert len(pds) == len(jds)
    for i in range(len(jds)):
        _same(jds[i], pds[i], f"item {i}")


def _same_reader(jr, pr):
    _same(list(jr()), list(pr()), "reader")


# -- paddle.batch and paddle.reader --------------------------------------------

def _range_reader(n):
    def reader():
        return iter(range(n))
    return reader


def _seeded_reader(n, seed=0):
    def reader():
        rs = np.random.RandomState(seed)
        for i in range(n):
            yield (rs.randn(3).astype(np.float32), i)
    return reader


@pytest.mark.parametrize("size,drop", [(3, False), (3, True), (1, False),
                                       (7, False), (8, True)])
def test_batch_matches_jax(size, drop):
    _same_reader(jpaddle.batch(_seeded_reader(7), size, drop_last=drop),
                 paddle.batch(_seeded_reader(7), size, drop_last=drop))


def test_batch_rejects_what_jax_rejects():
    for bad in (0, -1, 2.5):
        with pytest.raises(ValueError):
            jpaddle.batch(_range_reader(3), bad)
        with pytest.raises(ValueError):
            paddle.batch(_range_reader(3), bad)


def _decorated(mod, name):
    r = _seeded_reader(20)
    sq = lambda s: (s[0] * 2, s[1] * s[1])     # noqa: E731
    return {
        "cache": lambda: mod.cache(r),
        "map_readers": lambda: mod.map_readers(
            lambda a, b: a[1] + b[1], r, _seeded_reader(20, 1)),
        "shuffle": lambda: mod.shuffle(r, 6),
        "chain": lambda: mod.chain(r, _seeded_reader(4, 2)),
        "compose": lambda: mod.compose(r, _seeded_reader(20, 3)),
        "compose_unaligned": lambda: mod.compose(
            r, _range_reader(5), check_alignment=False),
        "buffered": lambda: mod.buffered(r, 3),
        "firstn": lambda: mod.firstn(r, 7),
        "xmap_ordered": lambda: mod.xmap_readers(sq, r, 4, 8, order=True),
    }[name]()


@pytest.mark.parametrize("name", ["cache", "map_readers", "shuffle", "chain",
                                  "compose", "compose_unaligned", "buffered",
                                  "firstn", "xmap_ordered"])
def test_reader_decorator_matches_jax(name):
    random.seed(5)
    want = list(_decorated(jreader, name)())
    random.seed(5)
    got = list(_decorated(preader, name)())
    _same(want, got, name)


def test_unordered_readers_give_the_same_samples():
    sq = lambda x: x * x                       # noqa: E731
    for mod_r in (jreader, preader):
        assert sorted(mod_r.xmap_readers(sq, _range_reader(40), 4, 8)()) \
            == [i * i for i in range(40)]
        assert sorted(mod_r.multiprocess_reader(
            [_range_reader(5), _range_reader(7)])()) == sorted(
                list(range(5)) + list(range(7)))


def test_compose_not_aligned_raises_like_jax():
    for mod_r in (jreader, preader):
        bad = mod_r.compose(_range_reader(2), _range_reader(3))
        with pytest.raises(mod_r.decorator.ComposeNotAligned):
            list(bad())
    assert set(preader.__all__) == set(jreader.__all__)


# -- vision.datasets -------------------------------------------------------------

def _write_idx(path, arr):
    arr = np.asarray(arr, np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x800 + arr.ndim))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.tobytes())


@pytest.fixture()
def mnist_files(tmp_path):
    rs = np.random.RandomState(0)
    _write_idx(tmp_path / "im.idx", rs.randint(0, 255, (6, 28, 28)))
    _write_idx(tmp_path / "lb.idx", np.arange(6) % 10)
    with gzip.open(tmp_path / "im.idx.gz", "wb") as g:
        g.write((tmp_path / "im.idx").read_bytes())
    return str(tmp_path / "im.idx"), str(tmp_path / "lb.idx")


def _add(tf, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


@pytest.fixture()
def cifar_tar(tmp_path):
    rs = np.random.RandomState(1)
    path = tmp_path / "cifar.tar.gz"
    with tarfile.open(path, "w:gz") as tf:
        for name, n in (("data_batch_1", 5), ("test_batch", 3),
                        ("train", 4), ("test", 2)):
            batch = {b"data": rs.randint(0, 255, (n, 3072)).astype(np.uint8),
                     b"labels": list(rs.randint(0, 10, n)),
                     b"fine_labels": list(rs.randint(0, 100, n))}
            _add(tf, f"cifar/{name}", pickle.dumps(batch))
    return str(path)


def _png_bytes(arr):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture()
def flowers_files(tmp_path):
    rs = np.random.RandomState(2)
    path = tmp_path / "102flowers.tgz"
    with tarfile.open(path, "w:gz") as tf:
        for i in range(6):
            _add(tf, f"jpg/image_{i:05d}.jpg",
                 _png_bytes(rs.randint(0, 255, (5, 4, 3), dtype=np.uint8)))
    np.save(tmp_path / "labels.npy", np.arange(1, 7))
    np.savez(tmp_path / "setid.npz", trnid=[1, 2, 3], valid=[4],
             tstid=[5, 6])
    return (str(path), str(tmp_path / "labels.npy"),
            str(tmp_path / "setid.npz"))


@pytest.fixture()
def voc_tar(tmp_path):
    rs = np.random.RandomState(3)
    path = tmp_path / "VOCtrainval.tar"
    root = "VOCdevkit/VOC2012/"
    with tarfile.open(path, "w") as tf:
        ids = ["a1", "b2", "c3"]
        for i in ids:
            _add(tf, f"{root}JPEGImages/{i}.jpg",
                 _png_bytes(rs.randint(0, 255, (4, 6, 3), dtype=np.uint8)))
            _add(tf, f"{root}SegmentationClass/{i}.png",
                 _png_bytes(rs.randint(0, 21, (4, 6), dtype=np.uint8)))
        for name, sel in (("train.txt", ids[:2]), ("val.txt", ids[2:]),
                          ("trainval.txt", ids)):
            _add(tf, f"{root}ImageSets/Segmentation/{name}",
                 "\n".join(sel).encode())
    return str(path)


@pytest.fixture()
def image_tree(tmp_path):
    rs = np.random.RandomState(4)
    for cls in ("cat", "dog"):
        d = tmp_path / "imgs" / cls / "sub"
        d.mkdir(parents=True)
        for i in range(3):
            (d / f"{i}.png").write_bytes(
                _png_bytes(rs.randint(0, 255, (8, 8, 3), dtype=np.uint8)))
            np.save(d / f"{i}.npy", rs.randn(3, 4, 4).astype(np.float32))
        (d / "notes.txt").write_text("not an image")
    return str(tmp_path / "imgs")


def test_mnist_and_fashion_match_jax(mnist_files):
    im, lb = mnist_files
    for cls in ("MNIST", "FashionMNIST"):
        _same_dataset(getattr(jvision.datasets, cls)(im, lb),
                      getattr(pvision.datasets, cls)(im, lb))
    _same_dataset(jvision.datasets.MNIST(im + ".gz", lb),
                  pvision.datasets.MNIST(im + ".gz", lb))
    for mod in (jvision.datasets, pvision.datasets):
        with pytest.raises(ValueError, match="egress"):
            mod.MNIST(download=True)


def test_cifar_match_jax(cifar_tar):
    for cls in ("Cifar10", "Cifar100"):
        for mode in ("train", "test"):
            _same_dataset(
                getattr(jvision.datasets, cls)(cifar_tar, mode=mode),
                getattr(pvision.datasets, cls)(cifar_tar, mode=mode))


def test_fake_data_matches_jax():
    _same_dataset(jvision.datasets.FakeData(5, (3, 8, 8), 7, seed=3),
                  pvision.datasets.FakeData(5, (3, 8, 8), 7, seed=3))


def test_flowers_match_jax(flowers_files):
    data, labels, setid = flowers_files
    for mode in ("train", "valid", "test"):
        _same_dataset(jvision.datasets.Flowers(data, labels, setid, mode),
                      pvision.datasets.Flowers(data, labels, setid, mode))


def test_voc2012_matches_jax(voc_tar):
    for mode in ("train", "valid", "test"):
        j = jvision.datasets.VOC2012(voc_tar, mode=mode)
        p = pvision.datasets.VOC2012(voc_tar, mode=mode)
        try:
            _same_dataset(j, p)
        finally:
            j.close()
            p.close()


def test_folders_match_jax(image_tree):
    jds, pds = (m.datasets.DatasetFolder(image_tree)
                for m in (jvision, pvision))
    assert (pds.classes, pds.class_to_idx, pds.targets) == \
        (jds.classes, jds.class_to_idx, jds.targets)
    assert [s[0] for s in pds.samples] == [s[0] for s in jds.samples]
    _same_dataset(jds, pds)
    # .npy images through a loader (what the card phase reads)
    jds, pds = (m.datasets.DatasetFolder(image_tree, loader=np.load,
                                         extensions=(".npy",))
                for m in (jvision, pvision))
    _same_dataset(jds, pds)
    assert len(pds) == 6 and pds[0][0].shape == (3, 4, 4)
    _same_dataset(jvision.datasets.ImageFolder(image_tree),
                  pvision.datasets.ImageFolder(image_tree))
    for m in (jvision, pvision):
        with pytest.raises(RuntimeError):
            m.datasets.DatasetFolder(image_tree, extensions=(".webp",))
        with pytest.raises(ValueError):
            m.datasets.DatasetFolder(image_tree, extensions=(".png",),
                                     is_valid_file=lambda p: True)


def test_image_backend_and_image_load(image_tree):
    path = os.path.join(image_tree, "cat", "sub", "0.png")
    prev = pvision.get_image_backend()
    try:
        for m in (jvision, pvision):
            m.set_image_backend("pil")
            assert m.get_image_backend() == "pil"
            with pytest.raises(ValueError):
                m.set_image_backend("nope")
        _same(jvision.image_load(path), pvision.image_load(path))
    finally:
        pvision.set_image_backend(prev)


# -- text.datasets ----------------------------------------------------------------

def test_text_datasets_match_jax(tmp_path):
    imdb, ptb = _make_imdb(tmp_path), _make_ptb(tmp_path)
    housing, ml = _make_housing(tmp_path), _make_ml1m(tmp_path)
    for mode in ("train", "test"):
        for cutoff in (0, 2):
            j = jtext.Imdb(data_file=imdb, mode=mode, cutoff=cutoff)
            p = ptext.Imdb(data_file=imdb, mode=mode, cutoff=cutoff)
            assert p.word_idx == j.word_idx
            _same_dataset(j, p)
        for dtype in ("NGRAM", "SEQ"):
            j = jtext.Imikolov(data_file=ptb, data_type=dtype,
                               window_size=3, mode=mode, min_word_freq=10)
            p = ptext.Imikolov(data_file=ptb, data_type=dtype,
                               window_size=3, mode=mode, min_word_freq=10)
            assert p.word_idx == j.word_idx
            _same_dataset(j, p)
        _same_dataset(jtext.UCIHousing(data_file=housing, mode=mode),
                      ptext.UCIHousing(data_file=housing, mode=mode))
        j = jtext.Movielens(data_file=ml, mode=mode, test_ratio=0.5,
                            rand_seed=1)
        p = ptext.Movielens(data_file=ml, mode=mode, test_ratio=0.5,
                            rand_seed=1)
        assert (p.categories_dict, p.movie_title_dict) == \
            (j.categories_dict, j.movie_title_dict)
        _same_dataset(j, p)
    for m in (jtext, ptext):
        with pytest.raises(ValueError, match="egress"):
            m.Imdb()


def test_seq2seq_and_srl_datasets_match_jax(tmp_path):
    data, wd, vd, td = _conll_tar(tmp_path)
    j = jtext.Conll05st(data_file=data, word_dict_file=wd,
                        verb_dict_file=vd, target_dict_file=td)
    p = ptext.Conll05st(data_file=data, word_dict_file=wd,
                        verb_dict_file=vd, target_dict_file=td)
    assert p.get_dict() == j.get_dict()
    _same_dataset(j, p)
    wmt14 = _wmt14_tar(tmp_path)
    for mode in ("train", "test", "gen"):
        j = jtext.WMT14(data_file=wmt14, mode=mode, dict_size=7)
        p = ptext.WMT14(data_file=wmt14, mode=mode, dict_size=7)
        assert p.get_dict() == j.get_dict()
        assert p.get_dict(reverse=True) == j.get_dict(reverse=True)
        _same_dataset(j, p)
    for lang in ("en", "de"):
        d = tmp_path / f"wmt16_{lang}"
        d.mkdir()
        tar = _wmt16_tar(d)
        for mode in ("train", "test", "val"):
            j = jtext.WMT16(data_file=tar, mode=mode, src_dict_size=6,
                            trg_dict_size=5, lang=lang)
            p = ptext.WMT16(data_file=tar, mode=mode, src_dict_size=6,
                            trg_dict_size=5, lang=lang)
            assert (p.src_dict, p.trg_dict) == (j.src_dict, j.trg_dict)
            _same_dataset(j, p)


def _wmt16_tar(d):
    pairs = [("a b b", "u v"), ("b c", "v w"), ("a", "u"), ("c c d", "w x")]
    path = d / "wmt16.tar.gz"
    with tarfile.open(path, "w:gz") as tf:
        body = "".join(f"{s}\t{t}\n" for s, t in pairs).encode()
        for mode in ("train", "test", "val"):
            _add(tf, f"wmt16/{mode}", body)
    return str(path)


def test_viterbi_decode_matches_jax():
    rs = np.random.RandomState(0)
    pot = rs.randn(3, 6, 5).astype(np.float32)
    trans = rs.randn(5, 5).astype(np.float32)
    lens = np.array([6, 3, 1], np.int64)
    for bos in (True, False):
        js, jp = jtext.viterbi_decode(pot, trans, lens, bos)
        ps, pp = ptext.viterbi_decode(pot, trans, lens, bos)
        assert isinstance(ps, paddle.Tensor) and pp.stop_gradient
        np.testing.assert_allclose(ps.numpy(), js.numpy(), rtol=1e-6)
        np.testing.assert_array_equal(pp.numpy(), jp.numpy())
        # torch in, torch out; the Layer over surface and torch inputs
        ts, tp = ptext.viterbi_decode(torch.from_numpy(pot),
                                      torch.from_numpy(trans),
                                      torch.from_numpy(lens), bos)
        assert isinstance(tp, torch.Tensor)
        np.testing.assert_array_equal(tp.numpy(), jp.numpy())
        dec = ptext.ViterbiDecoder(paddle.to_tensor(trans), bos)
        s2, p2 = dec(paddle.to_tensor(pot), paddle.to_tensor(lens))
        assert isinstance(p2, paddle.Tensor)
        np.testing.assert_array_equal(p2.numpy(), jp.numpy())
        s3, p3 = dec(torch.from_numpy(pot), torch.from_numpy(lens))
        assert isinstance(p3, torch.Tensor)
        np.testing.assert_array_equal(p3.numpy(), jp.numpy())


# -- paddle.dataset ------------------------------------------------------------------

def test_dataset_vision_readers_match_jax(mnist_files, cifar_tar,
                                          flowers_files, voc_tar):
    im, lb = mnist_files
    for fn in ("train", "test"):
        _same_reader(getattr(jdataset.mnist, fn)(im, lb),
                     getattr(pdataset.mnist, fn)(im, lb))
    for fn in ("train10", "test10", "train100", "test100"):
        _same_reader(getattr(jdataset.cifar, fn)(cifar_tar),
                     getattr(pdataset.cifar, fn)(cifar_tar))
    data, labels, setid = flowers_files
    mapper = lambda img, label: (img.mean(), label + 1)   # noqa: E731
    for fn in ("train", "test", "valid"):
        kw = dict(data_file=data, label_file=labels, setid_file=setid)
        _same_reader(getattr(jdataset.flowers, fn)(**kw),
                     getattr(pdataset.flowers, fn)(**kw))
        _same_reader(getattr(jdataset.flowers, fn)(mapper=mapper, **kw),
                     getattr(pdataset.flowers, fn)(mapper=mapper, **kw))
    for fn in ("train", "val", "test"):
        _same_reader(getattr(jdataset.voc2012, fn)(voc_tar),
                     getattr(pdataset.voc2012, fn)(voc_tar))


def test_dataset_text_readers_match_jax(tmp_path):
    imdb, ptb = _make_imdb(tmp_path), _make_ptb(tmp_path)
    housing, ml = _make_housing(tmp_path), _make_ml1m(tmp_path)
    for fn in ("train", "test"):
        _same_reader(getattr(jdataset.imdb, fn)(data_file=imdb),
                     getattr(pdataset.imdb, fn)(data_file=imdb))
        _same_reader(getattr(jdataset.imikolov, fn)(n=3, data_file=ptb),
                     getattr(pdataset.imikolov, fn)(n=3, data_file=ptb))
        _same_reader(getattr(jdataset.uci_housing, fn)(housing),
                     getattr(pdataset.uci_housing, fn)(housing))
        _same_reader(getattr(jdataset.movielens, fn)(ml),
                     getattr(pdataset.movielens, fn)(ml))
    assert pdataset.imdb.word_dict(imdb, cutoff=0) == \
        jdataset.imdb.word_dict(imdb, cutoff=0)
    assert pdataset.imikolov.build_dict(10, ptb) == \
        jdataset.imikolov.build_dict(10, ptb)
    for fn in ("get_movie_title_dict", "movie_categories", "max_movie_id",
               "max_user_id", "max_job_id"):
        assert getattr(pdataset.movielens, fn)(ml) == \
            getattr(jdataset.movielens, fn)(ml), fn
    data, wd, vd, td = _conll_tar(tmp_path)
    kw = dict(data_file=data, word_dict_file=wd, verb_dict_file=vd,
              target_dict_file=td)
    _same_reader(jdataset.conll05.test(**kw), pdataset.conll05.test(**kw))
    assert pdataset.conll05.get_dict(**kw) == jdataset.conll05.get_dict(**kw)
    assert pdataset.conll05.get_embedding(wd) == wd
    for m in (jdataset, pdataset):
        with pytest.raises(IOError, match="egress"):
            m.conll05.get_embedding(None)
    wmt14 = _wmt14_tar(tmp_path)
    for fn in ("train", "test", "gen"):
        _same_reader(getattr(jdataset.wmt14, fn)(7, wmt14),
                     getattr(pdataset.wmt14, fn)(7, wmt14))
    d = tmp_path / "w16"
    d.mkdir()
    wmt16 = _wmt16_tar(d)
    for fn in ("train", "test", "validation"):
        _same_reader(getattr(jdataset.wmt16, fn)(6, 5, "en", wmt16),
                     getattr(pdataset.wmt16, fn)(6, 5, "en", wmt16))
    for lang in ("en", "de"):
        for rev in (False, True):
            assert pdataset.wmt16.get_dict(lang, 6, rev, wmt16) == \
                jdataset.wmt16.get_dict(lang, 6, rev, wmt16)


def test_dataset_common_matches_jax(tmp_path):
    for name, m in (("jax", jdataset), ("port", pdataset)):
        d = tmp_path / name
        d.mkdir()
        cwd = os.getcwd()
        os.chdir(d)
        try:
            m.common.split(_seeded_reader(10), 4)
        finally:
            os.chdir(cwd)
        shards = [list(m.common.cluster_files_reader(
            str(d / "*.pickle"), 2, i)()) for i in range(2)]
        if name == "jax":
            want = shards
        else:
            _same(want, shards, "shards")
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))
    f = tmp_path / "port" / "00000.pickle"
    assert pdataset.common.md5file(str(f)) == jdataset.common.md5file(str(f))
    # download stays local-only and raises the same IOError
    for m in (jdataset, pdataset):
        with pytest.raises(IOError, match="egress"):
            m.common.download("http://x/y.tgz", "nosuch", "0" * 32)
    assert set(pdataset.__all__) == set(jdataset.__all__)
    assert pdataset.common.DATA_HOME == jdataset.common.DATA_HOME


def test_dataset_image_transforms_match_jax():
    rs = np.random.RandomState(0)
    im = rs.randint(0, 255, (40, 30, 3)).astype(np.uint8)
    for is_train in (False, True):
        np.random.seed(3)
        want = jdataset.image.simple_transform(im, 20, 16, is_train,
                                               mean=[1.0, 2.0, 3.0])
        np.random.seed(3)
        got = pdataset.image.simple_transform(im, 20, 16, is_train,
                                              mean=[1.0, 2.0, 3.0])
        _same(want, got)
    for fn, args in (("resize_short", (12,)), ("to_chw", ()),
                     ("center_crop", (10,)), ("left_right_flip", ())):
        _same(getattr(jdataset.image, fn)(im, *args),
              getattr(pdataset.image, fn)(im, *args), fn)
    np.random.seed(1)
    want = jdataset.image.random_crop(im, 9)
    np.random.seed(1)
    _same(want, pdataset.image.random_crop(im, 9))

"""The port's ``vision.transforms`` against the JAX package's, on the CPU.

The transforms are host numpy in both packages, the port's a line-for-
line copy: every case feeds the same seeded uint8 / float32 image to
both and requires the same array bit for bit (``assert_array_equal``
with equal dtypes).  The random transforms run under the same
``random.seed`` and ``np.random.seed`` on both sides, so they draw the
same crops, flips, angles and jitter.  ``to_tensor`` gives the port's
``Tensor`` over a CPU torch tensor, ``normalize`` keeps a ``Tensor`` a
``Tensor`` and ``erase`` writes into one.  The spec is
``tests/test_vision.py``'s transform tests and
``tests/test_vision_ops_extra.py::test_transforms_affine_perspective_erase``.
"""
import random

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import paddle_tpu as jpaddle
from paddle_tpu.vision import transforms as JT
from paddle_tpu.vision.transforms import functional as JF

import paddle_tpu_torch as paddle
from paddle_tpu_torch.vision import transforms as PT
from paddle_tpu_torch.vision.transforms import functional as PF
from _torch_cpu_place import cpu_place  # noqa: F401,E402


def _img(seed=0, shape=(20, 30, 3), dtype="uint8"):
    rng = np.random.RandomState(seed)
    if dtype == "uint8":
        return (rng.rand(*shape) * 255).astype("uint8")
    return rng.randn(*shape).astype(dtype)


def _np(v):
    if isinstance(v, (jpaddle.Tensor, paddle.Tensor)):
        return v.numpy()
    return np.asarray(v)


def _same(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _both(fn_name, *args, img=None, seed=0, **kw):
    """``fn_name`` of each functional module on a fresh copy of the
    image, under the same seeds."""
    outs = []
    for mod in (JF, PF):
        random.seed(seed)
        np.random.seed(seed)
        outs.append(getattr(mod, fn_name)(img.copy(), *args, **kw))
    return outs


FUNCTIONAL = [
    ("resize", ((10, 15),), {}),
    ("resize", (12,), {}),
    ("resize", (40,), {"interpolation": "nearest"}),
    ("resize", ((17, 9),), {"interpolation": "bilinear"}),
    ("crop", (2, 3, 10, 12), {}),
    ("center_crop", (8,), {}),
    ("center_crop", ((7, 11),), {}),
    ("hflip", (), {}),
    ("vflip", (), {}),
    ("pad", (2,), {}),
    ("pad", ((1, 3),), {"fill": 7}),
    ("pad", ((1, 2, 3, 4),), {"padding_mode": "reflect"}),
    ("pad", ((2, 2, 1, 1),), {"padding_mode": "edge"}),
    ("pad", ((3, 1, 2, 0),), {"padding_mode": "symmetric"}),
    ("normalize", ([0.5, 0.4, 0.3], [0.2, 0.25, 0.3]),
     {"data_format": "HWC"}),
    ("rotate", (45,), {}),
    ("rotate", (30,), {"interpolation": "bilinear"}),
    ("rotate", (-20,), {"expand": True, "fill": 3}),
    ("rotate", (60,), {"center": (4, 5), "interpolation": "bilinear"}),
    ("to_grayscale", (), {}),
    ("to_grayscale", (3,), {}),
    ("adjust_brightness", (1.5,), {}),
    ("adjust_contrast", (0.5,), {}),
    ("adjust_hue", (0.2,), {}),
    ("adjust_hue", (-0.45,), {}),
    ("affine", (30, (2, -1), 1.1, 5.0), {}),
    ("affine", (-15, (0, 3), 0.9, (4.0, -6.0)),
     {"interpolation": "bilinear", "fill": 9}),
    ("perspective", ([[0, 0], [29, 0], [29, 19], [0, 19]],
                     [[2, 1], [27, 3], [28, 18], [1, 17]]), {}),
    ("perspective", ([[0, 0], [29, 0], [29, 19], [0, 19]],
                     [[3, 2], [26, 1], [29, 16], [2, 19]]),
     {"interpolation": "bilinear"}),
    ("erase", (2, 3, 5, 6, 0), {}),
    ("erase", (1, 1, 4, 4, [10, 20, 30]), {}),
    ("to_tensor", (), {}),
    ("to_tensor", (), {"data_format": "HWC"}),
]


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("name,args,kw", FUNCTIONAL,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(FUNCTIONAL)])
def test_functional_matches_jax_bitwise(name, args, kw, dtype):
    img = _img(1, dtype=dtype)
    if dtype == "float32" and name.startswith("adjust_"):
        img = np.abs(img) * 60          # the colour ops clip to [0, 255]
    want, got = _both(name, *args, img=img, **kw)
    _same(got, want)


@pytest.mark.parametrize("name,args", [
    ("resize", ((9, 14),)), ("rotate", (25,)), ("pad", (1,)),
    ("hflip", ()), ("to_tensor", ()), ("center_crop", (6,))])
def test_functional_on_gray_images(name, args):
    want, got = _both(name, *args, img=_img(2, shape=(16, 21)))
    _same(got, want)


def test_to_tensor_and_normalize_give_port_tensors_on_the_cpu():
    img = _img(3)
    t = PF.to_tensor(img)
    assert isinstance(t, paddle.Tensor)
    assert t.value.device.type == "cpu" and t.value.is_contiguous()
    assert t.dtype == torch.float32 and t.shape == [3, 20, 30]
    n = PF.normalize(t, [0.5] * 3, [0.25] * 3)
    assert isinstance(n, paddle.Tensor)
    want = JF.normalize(JF.to_tensor(img), [0.5] * 3, [0.25] * 3)
    _same(n, want)


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("value", [0.5, [1.0, 2.0, 3.0], "noise"])
def test_erase_on_a_chw_tensor(value, inplace):
    img = _img(4, dtype="float32").transpose(2, 0, 1).copy()
    v = np.random.RandomState(5).randn(3, 4, 6) if value == "noise" \
        else value
    jt, pt = jpaddle.to_tensor(img), paddle.to_tensor(img)
    want = JF.erase(jt, 2, 3, 4, 6, v, inplace=inplace)
    got = PF.erase(pt, 2, 3, 4, 6, v, inplace=inplace)
    _same(got, want)
    assert (got is pt) == inplace
    if not inplace:
        _same(pt, img)


def _pair(build, img, seed=0, calls=6):
    """``calls`` draws of a transform built by ``build(module)`` in each
    package, under the same seeds."""
    outs = []
    for mod in (JT, PT):
        random.seed(seed)
        np.random.seed(seed)
        t = build(mod)
        outs.append([t(img.copy()) for _ in range(calls)])
    return outs


TRANSFORMS = {
    "Resize": lambda T: T.Resize((12, 16)),
    "RandomResizedCrop": lambda T: T.RandomResizedCrop(14),
    "RandomResizedCrop-scale": lambda T: T.RandomResizedCrop(
        (10, 12), scale=(0.5, 0.9), ratio=(0.5, 2.0),
        interpolation="nearest"),
    "CenterCrop": lambda T: T.CenterCrop(9),
    "RandomCrop": lambda T: T.RandomCrop(12),
    "RandomCrop-pad": lambda T: T.RandomCrop(24, padding=2,
                                             pad_if_needed=True, fill=5),
    "RandomHorizontalFlip": lambda T: T.RandomHorizontalFlip(),
    "RandomVerticalFlip": lambda T: T.RandomVerticalFlip(0.7),
    "RandomRotation": lambda T: T.RandomRotation(40),
    "RandomRotation-expand": lambda T: T.RandomRotation(
        (10, 80), interpolation="bilinear", expand=True),
    "Normalize": lambda T: T.Normalize(127.0, 50.0, data_format="HWC"),
    "Transpose": lambda T: T.Transpose(),
    "Pad": lambda T: T.Pad((1, 2), padding_mode="reflect"),
    "Grayscale": lambda T: T.Grayscale(3),
    "BrightnessTransform": lambda T: T.BrightnessTransform(0.4),
    "ContrastTransform": lambda T: T.ContrastTransform(0.4),
    "SaturationTransform": lambda T: T.SaturationTransform(0.4),
    "HueTransform": lambda T: T.HueTransform(0.3),
    "ColorJitter": lambda T: T.ColorJitter(0.4, 0.4, 0.4, 0.2),
    "RandomAffine": lambda T: T.RandomAffine(
        20, translate=(0.1, 0.2), scale=(0.8, 1.2), shear=(-5, 5, -3, 3)),
    "RandomAffine-scalar-shear": lambda T: T.RandomAffine(
        10, shear=6, interpolation="bilinear"),
    "RandomPerspective": lambda T: T.RandomPerspective(0.8, 0.4),
    "RandomErasing": lambda T: T.RandomErasing(0.9, value="random"),
    "RandomErasing-value": lambda T: T.RandomErasing(1.0, value=17),
    "ToTensor": lambda T: T.ToTensor(),
    "Compose": lambda T: T.Compose([
        T.Resize(40), T.CenterCrop(32), T.RandomHorizontalFlip(0.5),
        T.ToTensor(), T.Normalize(mean=[0.5] * 3, std=[0.5] * 3)]),
    "Compose-imagenet": lambda T: T.Compose([
        T.RandomResizedCrop(16), T.RandomHorizontalFlip(), T.ToTensor(),
        T.Normalize([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]),
        T.RandomErasing(0.5)]),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transform_draws_match_jax_bitwise(name):
    img = _img(6, shape=(24, 28, 3))
    want, got = _pair(TRANSFORMS[name], img, seed=11)
    for g, w in zip(got, want):
        _same(g, w)


def test_random_draws_follow_the_seeds():
    """Two seeds give other crops (the draws are read from the seeded
    generators, not fixed), and each package repeats its own."""
    img = _img(7, shape=(32, 32, 3))
    a = _pair(TRANSFORMS["RandomResizedCrop"], img, seed=1)[1]
    b = _pair(TRANSFORMS["RandomResizedCrop"], img, seed=2)[1]
    assert any(not np.array_equal(x, y) for x, y in zip(a, b))
    c = _pair(TRANSFORMS["RandomResizedCrop"], img, seed=1)[1]
    for x, y in zip(a, c):
        np.testing.assert_array_equal(x, y)


def test_fake_data_through_transforms_and_the_loader():
    """``FakeData`` with a transform, through the port's ``DataLoader``
    with ``num_workers=0``: the batches are the transformed samples
    stacked, on the current place."""
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.vision.datasets import FakeData

    t = PT.Compose([PT.RandomResizedCrop(8), PT.RandomHorizontalFlip(),
                    PT.ToTensor()])
    ds = FakeData(size=6, image_shape=(12, 12, 3), num_classes=4,
                  transform=t)
    random.seed(3)
    np.random.seed(3)
    xb, yb = next(iter(DataLoader(ds, batch_size=6)))
    random.seed(3)
    np.random.seed(3)
    want = np.stack([ds[i][0].numpy() for i in range(6)])
    assert xb.shape == [6, 3, 8, 8] and yb.shape == [6, 1]
    np.testing.assert_array_equal(xb.numpy(), want)

"""The port's YOLOv3 against the JAX package's, on the CPU.

A small YOLOv3 (``width=8``, ``neck_channel=16``, 4 classes, the default
anchors) at 64^2, batch 2, the JAX weights carried over with
``load_jax_state``; f32 values at 1e-5 relative with an absolute floor
of 1e-5 of the largest value compared (rtol 1e-4 where a case says so):

* the state dict's names and shapes, and ``yolov3()``'s parameter count
  at its defaults (80 classes, ``width=32``, ``neck_channel=128``);
* the three heads in training and in eval mode, and ``decode``;
* ``YOLOv3Loss`` on the heads, with the ground truth as the JAX list of
  (boxes, classes) an image and as the padded ``[N, M, 4]`` / ``[N, M]``
  form (negative labels padding) that ``make_train_step`` passes: the
  loss and its gradient on the heads;
* ``vision.ops.yolo_loss`` (``yolo_head_loss``) with ``ignore_thresh``
  at 0.99 (nothing ignored), 0.5 and 0.0, with ``gt_score`` and without
  label smoothing: the per-image losses and the gradient on the head;
  the JAX test's ordering (``tests/test_vision_ops_extra.py:165-185``);
* ``predict``'s rows an image against JAX's ``predict`` (the same
  boxes kept, in order; scores without ties);
* two Momentum steps through the port's ``make_train_step`` with
  ``YOLOv3Loss`` against the JAX eager tape: both losses at 1e-4, in
  f64 on both sides as for the zoo (``test_torch_vision_models.py``
  says why: batch norm in training mode over small maps makes f32 second
  steps chaotic).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as jpaddle
from paddle_tpu.vision import ops as jops
from paddle_tpu.vision.models import yolo as jyolo

from paddle_tpu_torch.distributed import make_train_step
from paddle_tpu_torch.models import load_jax_state
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision import ops as pops
from paddle_tpu_torch.vision.models import yolo as pyolo
from _torch_zoo import fast_jax_compiles  # noqa: F401,E402
from _torch_cpu_place import cpu_place  # noqa: F401,E402

torch.set_num_threads(2)
SMALL = dict(num_classes=4, width=8, neck_channel=16)
GT_BOXES = np.array([[[4, 6, 30, 40], [36, 10, 60, 28], [0, 0, 0, 0]],
                     [[10, 12, 50, 58], [0, 0, 0, 0], [0, 0, 0, 0]]],
                    np.float32)
GT_LABELS = np.array([[1, 3, -1], [2, -1, -1]], np.int64)


@pytest.fixture(scope="module", autouse=True)
def _fast(fast_jax_compiles):  # noqa: F811
    yield


def _np(v):
    if hasattr(v, "_value") and not torch.is_tensor(v):
        return np.asarray(v.numpy())
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _close(got, want, rtol=1e-5, err_msg=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    floor = rtol * max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor,
                               err_msg=err_msg)


def _pair(seed=0, **kw):
    jpaddle.seed(seed)
    jm = jyolo.YOLOv3(**{**SMALL, **kw})
    pm = pyolo.YOLOv3(**{**SMALL, **kw}, device="cpu")
    want = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in
            torch.nn.Module.state_dict(pm).items()} == want
    load_jax_state(pm, {k: np.asarray(v._value)
                        for k, v in jm.state_dict().items()})
    return jm, pm


def _images(seed=0, b=2, size=64):
    return np.random.RandomState(seed).randn(b, 3, size, size).astype(
        np.float32)


def _gt_list():
    return [(b[lab >= 0], lab[lab >= 0]) for b, lab in zip(GT_BOXES,
                                                           GT_LABELS)]


def test_default_config_holds_the_jax_parameters():
    want = sum(int(np.prod(p.shape)) for p in jyolo.yolov3().parameters())
    pm = pyolo.yolov3(device="cpu")
    assert sum(p.numel() for p in torch.nn.Module.parameters(pm)) == want
    assert pm.num_classes == 80 and pm.strides == (8, 16, 32)
    with pytest.raises(ValueError, match="pretrained"):
        pyolo.yolov3(pretrained=True, device="cpu")


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_heads_and_decode_match_jax(mode):
    jm, pm = _pair(seed=1)
    x = _images(1)
    if mode == "eval":
        jm.eval()
        pm.eval()
    jh = jm(jpaddle.to_tensor(x))
    with torch.no_grad():
        ph = pm(torch.from_numpy(x))
    for g, w in zip(ph, jh):
        _close(g, w, rtol=1e-4)
    img = np.array([[64, 64], [64, 48]], np.int32)
    jb, js = jm.decode(jh, jpaddle.to_tensor(img))
    pb, ps = pm.decode(ph, torch.from_numpy(img))
    _close(pb, jb, rtol=1e-4)
    _close(ps, js, rtol=1e-4)


def _heads(seed, size=64):
    """Head-shaped random logits for the loss cases (no model)."""
    rng = np.random.RandomState(seed)
    return [rng.randn(2, 3 * 9, size // s, size // s).astype(np.float32)
            for s in (8, 16, 32)]


@pytest.mark.parametrize("padded", [False, True], ids=["list", "padded"])
def test_yolov3_loss_and_gradient_match_jax(padded):
    jm, pm = _pair(seed=2)
    heads = _heads(3)
    jh = [jpaddle.to_tensor(h) for h in heads]
    for t in jh:
        t.stop_gradient = False
    ph = [torch.from_numpy(h).requires_grad_(True) for h in heads]
    jl = jyolo.YOLOv3Loss(jm)(jh, _gt_list())
    crit = pyolo.YOLOv3Loss(pm)
    pl = crit(ph, torch.from_numpy(GT_BOXES), torch.from_numpy(GT_LABELS)) \
        if padded else crit(ph, _gt_list())
    _close(pl, jl)
    jl.backward()
    pl.backward()
    for g, w in zip(ph, jh):
        _close(g.grad, w.grad)


YOLO_LOSS = {
    "strict": dict(ignore_thresh=0.99),
    "half": dict(ignore_thresh=0.5),
    "loose": dict(ignore_thresh=0.0),
    "gt_score": dict(ignore_thresh=0.7, gt_score=True),
    "no_smooth": dict(ignore_thresh=0.7, use_label_smooth=False),
}


@pytest.mark.parametrize("case", list(YOLO_LOSS))
def test_yolo_loss_matches_jax(case):
    kw = dict(YOLO_LOSS[case])
    rng = np.random.RandomState(4)
    x = rng.standard_normal((2, 3 * 9, 4, 4)).astype(np.float32)
    gtb = np.array([[[0.5, 0.5, 0.3, 0.4], [0.3, 0.6, 0.2, 0.1]],
                    [[0.2, 0.3, 0.1, 0.2], [0.0, 0.0, 0.0, 0.0]]],
                   np.float32)
    gtl = np.array([[1, 3], [2, 0]], np.int64)
    gs = np.array([[0.7, 0.4], [0.9, 1.0]], np.float32)
    common = dict(anchors=[10, 13, 16, 30, 33, 23, 30, 61],
                  anchor_mask=[0, 1, 2], class_num=4, downsample_ratio=8)
    jx = jpaddle.to_tensor(x)
    jx.stop_gradient = False
    px = torch.from_numpy(x).requires_grad_(True)
    jkw, pkw = dict(kw), dict(kw)
    if kw.pop("gt_score", False):
        jkw["gt_score"] = jpaddle.to_tensor(gs)
        pkw["gt_score"] = torch.from_numpy(gs)
    jl = jops.yolo_loss(jx, jpaddle.to_tensor(gtb), jpaddle.to_tensor(gtl),
                        **common, **jkw)
    pl = pops.yolo_loss(px, torch.from_numpy(gtb), torch.from_numpy(gtl),
                        **common, **pkw)
    assert tuple(pl.shape) == (2,)
    _close(pl, jl)
    w = np.array([1.0, 0.5], np.float32)
    (jl * jpaddle.to_tensor(w)).sum().backward()
    (pl * torch.from_numpy(w)).sum().backward()
    _close(px.grad, jx.grad)


def test_yolo_loss_ignore_thresh_and_gt_score_order():
    """The JAX test's ordering on the port alone: thresh 0 ignores every
    positive-IoU negative (a smaller loss than thresh 0.99), and a 0
    ``gt_score`` drops the positive's objectness term."""
    x = torch.zeros(1, 27, 4, 4)
    gtb = torch.tensor([[[0.5, 0.5, 0.5, 0.5]]])
    gtl = torch.tensor([[1]])
    kw = dict(anchors=[10, 13, 16, 30, 33, 23], anchor_mask=[0, 1, 2],
              class_num=4, downsample_ratio=8)
    strict = float(pops.yolo_loss(x, gtb, gtl, ignore_thresh=0.99,
                                  **kw).sum())
    loose = float(pops.yolo_loss(x, gtb, gtl, ignore_thresh=0.0, **kw).sum())
    half = float(pops.yolo_loss(x, gtb, gtl, ignore_thresh=0.99,
                                gt_score=torch.tensor([[0.0]]), **kw).sum())
    assert loose < strict and half < strict


def test_predict_rows_match_jax():
    jm, pm = _pair(seed=5)
    x = _images(5)
    img = np.array([[64, 64], [64, 64]], np.int32)
    want = jm.predict(jpaddle.to_tensor(x), jpaddle.to_tensor(img), top_k=20)
    got = pm.predict(torch.from_numpy(x), torch.from_numpy(img), top_k=20)
    assert pm.training and jm.training
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[0] > 0
        np.testing.assert_array_equal(g[:, 5], w[:, 5])
        _close(g, w, rtol=1e-4)


def test_two_momentum_steps_match_jax():
    jm, pm = _pair(seed=6)
    x = _images(6).astype(np.float64)
    jax.config.update("jax_enable_x64", True)
    try:
        jm.to(dtype="float64")
        jopt = jpaddle.optimizer.Momentum(learning_rate=0.001, momentum=0.9,
                                          parameters=jm.parameters(),
                                          weight_decay=5e-4)
        jcrit = jyolo.YOLOv3Loss(jm)
        want = []
        for _ in range(2):
            loss = jcrit(jm(jpaddle.to_tensor(x)), _gt_list())
            loss.backward()
            jopt.step()
            jopt.clear_grad()
            want.append(float(loss.numpy()))
    finally:
        jax.config.update("jax_enable_x64", False)
    pm.double()
    step = make_train_step(pm, Momentum(0.001, momentum=0.9, parameters=pm,
                                        weight_decay=5e-4),
                           loss_fn=pyolo.YOLOv3Loss(pm), num_labels=2)
    got = [float(step(x, GT_BOXES, GT_LABELS)) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[1] < got[0]

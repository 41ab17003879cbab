"""The port's detection slice against the JAX package, on the CPU: the
``nn`` layers and functionals PP-YOLOE needs, ``vision.ops.nms`` and
PP-YOLOE itself (f32; the JAX side at ``jax_default_matmul_precision``
"highest", as ``tests/conftest.py`` sets it).  Weights go from the JAX
model to the port's through ``load_jax_state``.

* ``Swish``, ``LeakyReLU``, ``Sigmoid``, ``GELU`` (both forms),
  ``one_hot`` (out-of-range indices included), ``interpolate`` /
  ``upsample`` (nearest at an integer and at non-integer scales; the
  linear modes and bicubic up and down, where ``jax.image.resize``
  antialiases), ``Upsample``, ``UpsamplingNearest2D``,
  ``binary_cross_entropy_with_logits`` and ``BCEWithLogitsLoss``: 1e-5
  relative (1e-6 absolute); ``LayerList`` names its children as JAX.
* ``nms``: the kept indices exactly, with tied scores, categories and
  ``top_k``.
* PP-YOLOE at the JAX test's size (``width=(8, 16, 32, 64, 128)``,
  ``depth=(1, 1, 1, 1)``, 2 x 3 x 64^2): head outputs in training and
  eval mode, ``decode`` and the loss and its gradient on the head
  outputs at 1e-5; the TAL assignment (``is_pos``, ``best_gt``) exactly
  equal to the JAX loss's, recomputed here with the JAX function's own
  jnp lines; ``fuse()`` in eval mode against JAX's fused model at 1e-5
  (and within 1e-3 of the unfused forward, the JAX test's bound);
  ``predict`` against JAX's ``decode`` + ``vision.ops.nms`` with the
  score filter composed here (the JAX ``predict`` raises, see ROADMAP
  section 3, item 4).
* Three Momentum steps of ``bench_ppyoloe``'s recipe (lr 0.01, momentum
  0.9, weight decay 5e-4; f32) through the port's ``make_train_step``
  against the JAX eager tape: losses and every parameter and running
  statistic at 1e-4 (the JAX package's compiled step gives models with
  batch norm other gradients, ROADMAP section 3 item 2).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.vision import ops as jops
from paddle_tpu.vision.models import PPYOLOE as JaxPPYOLOE
from paddle_tpu.vision.models import PPYOLOELoss as JaxPPYOLOELoss

import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.distributed import make_train_step
from paddle_tpu_torch.models import load_jax_state, to_jax_state
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision import ops as pops
from paddle_tpu_torch.vision.models import (PPYOLOE, PPYOLOELoss, conv_flops,
                                            ppyoloe_s, resnet18,
                                            resnet_conv_flops)
from paddle_tpu_torch.vision.models.ppyoloe import _boxes, _flat
from _torch_cpu_place import cpu_place  # noqa: F401,E402

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _fast_jax_compiles():
    """The JAX side runs op by op, and compiling each op dominates this
    file's time: XLA's optimisation passes are skipped while it runs (the
    same ops, the same f32 arithmetic), and restored after."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)

TOL = dict(rtol=1e-5, atol=1e-6)


def _close(got, want, err_msg=""):
    """A model's output at 1e-5 of its scale: rtol 1e-5 and atol 1e-5 of
    the largest |want| (f32 sums in another order through some 30
    convolutions and batch norms over their batch statistics)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=err_msg)

SMALL = dict(num_classes=4, width=(8, 16, 32, 64, 128), depth=(1, 1, 1, 1))
GT_BOXES = np.array([[[4, 4, 40, 40], [20, 10, 60, 50]],
                     [[8, 8, 32, 48], [0, 0, 0, 0]]], "float32")
GT_LABELS = np.array([[1, 3], [2, -1]], "int64")


def _np(t):
    return np.asarray(t._value) if hasattr(t, "_value") else \
        t.detach().cpu().numpy()


def _state(jm):
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


def _jt(a):
    return paddle.to_tensor(np.asarray(a))


# -- layers and functionals ---------------------------------------------------

ACTS = [("Swish", (), {}), ("LeakyReLU", (0.2,), {}), ("LeakyReLU", (), {}),
        ("Sigmoid", (), {}), ("GELU", (), {}), ("GELU", (True,), {})]


@pytest.mark.parametrize("name,args,kw", ACTS,
                         ids=[f"{a[0]}{a[1]}" for a in ACTS])
def test_activation_layers_match_jax(name, args, kw):
    x = np.random.RandomState(0).randn(3, 5, 7).astype(np.float32) * 3
    want = _np(getattr(jnn, name)(*args, **kw)(_jt(x)))
    got = getattr(pnn, name)(*args, **kw)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_layer_list_names_match_jax():
    jl = jnn.LayerList([jnn.Linear(3, 4), jnn.Linear(4, 2)])
    pl = pnn.LayerList([pnn.Linear(3, 4), pnn.Linear(4, 2)])
    assert sorted(jl.state_dict()) == sorted(pl.state_dict())
    assert len(pl) == 2 and isinstance(pl[-1], pnn.Linear)


@pytest.mark.parametrize("shape,n", [((5,), 4), ((2, 3), 7)])
def test_one_hot_matches_jax(shape, n):
    x = np.random.RandomState(1).randint(-1, n + 1, shape).astype(np.int64)
    want = _np(JF.one_hot(_jt(x), n))
    got = F.one_hot(torch.from_numpy(x), n)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# (input shape, data_format, kwargs): nearest at 2x and at sizes that are
# not a whole multiple, each linear mode up and down (downsampling
# antialiases in jax.image.resize), bicubic, NHWC, a 1-D and a 3-D case
INTERP = [
    ((2, 3, 5, 6), "NCHW", dict(scale_factor=2)),
    ((2, 3, 5, 6), "NCHW", dict(size=[7, 9])),
    ((2, 3, 9, 8), "NCHW", dict(size=[4, 5])),
    ((2, 3, 5, 6), "NCHW", dict(scale_factor=1.5)),
    ((2, 3, 5, 6), "NCHW", dict(scale_factor=2, mode="bilinear")),
    ((2, 3, 5, 6), "NCHW", dict(size=[7, 11], mode="bilinear")),
    ((2, 3, 9, 8), "NCHW", dict(size=[4, 3], mode="bilinear")),
    ((2, 3, 9, 8), "NCHW", dict(size=[4, 5], mode="area")),
    ((2, 3, 6, 5), "NCHW", dict(size=[9, 3], mode="bicubic")),
    ((2, 5, 6, 3), "NHWC", dict(scale_factor=2, mode="bilinear")),
    ((2, 5, 6, 3), "NHWC", dict(size=[3, 4])),
    ((2, 3, 7), "NCL", dict(size=[12], mode="linear")),
    ((1, 2, 3, 4, 5), "NCDHW", dict(size=[4, 6, 3], mode="trilinear")),
]


@pytest.mark.parametrize("shape,fmt,kw", INTERP,
                         ids=[f"{c[1]}-{c[2]}" for c in INTERP])
def test_interpolate_matches_jax(shape, fmt, kw):
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    want = _np(JF.interpolate(_jt(x), data_format=fmt, **kw))
    got = F.interpolate(torch.from_numpy(x), data_format=fmt, **kw)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    got_up = F.upsample(torch.from_numpy(x), data_format=fmt, **kw)
    np.testing.assert_array_equal(got_up.numpy(), got.numpy())


def test_interpolate_gradient_matches_jax():
    """The nearest and bilinear resizes carry gradients as JAX's."""
    x = np.random.RandomState(3).randn(2, 3, 5, 6).astype(np.float32)
    for kw in (dict(scale_factor=2), dict(size=[7, 4], mode="bilinear")):
        jx = _jt(x)
        jx.stop_gradient = False
        (JF.interpolate(jx, **kw) ** 2).sum().backward()
        tx = torch.from_numpy(x).requires_grad_()
        (F.interpolate(tx, **kw) ** 2).sum().backward()
        np.testing.assert_allclose(tx.grad.numpy(), _np(jx.grad), **TOL)


def test_upsample_layers_match_jax():
    x = np.random.RandomState(4).randn(2, 3, 4, 5).astype(np.float32)
    for jl, pl in ((jnn.Upsample(scale_factor=2, mode="bilinear"),
                    pnn.Upsample(scale_factor=2, mode="bilinear")),
                   (jnn.UpsamplingNearest2D(size=[7, 8]),
                    pnn.UpsamplingNearest2D(size=[7, 8]))):
        np.testing.assert_allclose(pl(torch.from_numpy(x)).numpy(),
                                   _np(jl(_jt(x))), **TOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["plain", "weight+pos_weight"])
def test_bce_with_logits_matches_jax(reduction, weighted):
    rs = np.random.RandomState(5)
    z = (rs.randn(4, 6) * 4).astype(np.float32)
    y = rs.rand(4, 6).astype(np.float32)
    w = rs.rand(4, 6).astype(np.float32) if weighted else None
    pw = (rs.rand(6) * 3).astype(np.float32) if weighted else None

    def jaxv(a):
        return None if a is None else _jt(a)

    def torv(a):
        return None if a is None else torch.from_numpy(a)

    want = _np(JF.binary_cross_entropy_with_logits(
        _jt(z), _jt(y), jaxv(w), reduction, jaxv(pw)))
    got = F.binary_cross_entropy_with_logits(
        torch.from_numpy(z), torch.from_numpy(y), torv(w), reduction,
        torv(pw))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    layer = pnn.BCEWithLogitsLoss(torv(w), reduction, torv(pw))
    np.testing.assert_array_equal(
        layer(torch.from_numpy(z), torch.from_numpy(y)).numpy(), got.numpy())


# -- nms ----------------------------------------------------------------------

def _boxes_scores(n, seed, ties=False):
    rs = np.random.RandomState(seed)
    xy = rs.rand(n, 2).astype(np.float32) * 50
    wh = (rs.rand(n, 2).astype(np.float32) * 20 + 4)
    boxes = np.concatenate([xy, xy + wh], 1)
    scores = rs.rand(n).astype(np.float32)
    if ties:
        scores = np.round(scores * 4) / 4        # many equal scores
    return boxes, scores


NMS = [dict(n=60, seed=0, thr=0.3), dict(n=60, seed=1, thr=0.5, ties=True),
       dict(n=60, seed=2, thr=0.4, cats=3), dict(n=60, seed=3, thr=0.3,
                                                 top_k=7),
       dict(n=60, seed=4, thr=0.2, ties=True, cats=2, top_k=11),
       dict(n=60, seed=5, thr=0.5, no_scores=True)]


@pytest.mark.parametrize("case", NMS, ids=[str(c) for c in NMS])
def test_nms_keeps_what_jax_keeps(case):
    boxes, scores = _boxes_scores(case["n"], case["seed"],
                                  case.get("ties", False))
    cats = (np.random.RandomState(9).randint(0, case["cats"], case["n"])
            if "cats" in case else None)
    sc = None if case.get("no_scores") else scores
    want = _np(jops.nms(_jt(boxes), iou_threshold=case["thr"],
                        scores=None if sc is None else _jt(sc),
                        category_idxs=None if cats is None else _jt(cats),
                        top_k=case.get("top_k")))
    got = pops.nms(torch.from_numpy(boxes), iou_threshold=case["thr"],
                   scores=None if sc is None else torch.from_numpy(sc),
                   category_idxs=None if cats is None
                   else torch.from_numpy(cats), top_k=case.get("top_k"))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < len(want) < case["n"]


# -- PP-YOLOE -----------------------------------------------------------------

def _pair(seed=0, **kw):
    paddle.seed(seed)
    jm = JaxPPYOLOE(**{**SMALL, **kw})
    pm = PPYOLOE(**{**SMALL, **kw}, device="cpu")
    load_jax_state(pm, _state(jm))
    return jm, pm


def _images(b=2, size=64, seed=0):
    return np.random.RandomState(seed).randn(b, 3, size, size).astype(
        np.float32)


def test_configs_match_jax():
    """PP-YOLOE-s's depth at the small width: the JAX model's parameter
    and buffer names and shapes; ``PPYOLOE(num_classes=80)`` and
    ``ppyoloe_s`` hold the JAX model's 8234460 parameters."""
    kw = dict(SMALL, depth=(1, 2, 2, 1))
    want = {k: tuple(v.shape)
            for k, v in JaxPPYOLOE(**kw).state_dict().items()}
    got = PPYOLOE(**kw, device="cpu").state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    for pm in (PPYOLOE(num_classes=80, device="cpu"), ppyoloe_s(device="cpu")):
        assert sum(p.numel() for p in pm.parameters()) == 8234460


def test_conv_flops_counts_any_model_of_conv_and_linear_layers():
    """``conv_flops`` counts 2 a multiply-add of every ``Conv2D`` and
    ``Linear`` from the shapes of one forward, whatever the model: a
    hand-counted stack; a ResNet, as ``resnet_conv_flops`` counts it;
    PP-YOLOE, whose training mode it restores."""
    torch.manual_seed(0)
    stack = torch.nn.Sequential(pnn.Conv2D(3, 8, 3, padding=1),
                                pnn.Conv2D(8, 4, 1, stride=2),
                                torch.nn.Flatten(), pnn.Linear(4 * 8 * 8, 5))
    assert conv_flops(stack, 16, 16) == 2.0 * (
        8 * 16 * 16 * 27 + 4 * 8 * 8 * 8 + 4 * 8 * 8 * 5)
    net = resnet18(device="cpu")
    assert conv_flops(net) == resnet_conv_flops(net)
    det = PPYOLOE(**SMALL, device="cpu")
    assert det.training
    assert conv_flops(det, 64, 64) > 0 and det.training


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_head_outputs_and_decode_match_jax(mode):
    jm, pm = _pair()
    getattr(jm, mode)()
    getattr(pm, mode)()
    x = _images()
    jcls, jreg = jm(_jt(x))
    pcls, preg = pm(torch.from_numpy(x))
    assert [tuple(c.shape) for c in pcls] == [(2, 4, 8, 8), (2, 4, 4, 4),
                                               (2, 4, 2, 2)]
    for g, w in zip(pcls + preg, list(jcls) + list(jreg)):
        _close(g.detach().numpy(), _np(w))
    jb, js = jm.decode((jcls, jreg))
    pb, ps = pm.decode((pcls, preg))
    assert tuple(pb.shape) == (2, 84, 4) and tuple(ps.shape) == (2, 84, 4)
    _close(pb.detach().numpy(), _np(jb))
    _close(ps.detach().numpy(), _np(js))
    if mode == "train":     # the running statistics after one forward
        for k, v in to_jax_state(pm).items():
            _close(v, _state(jm)[k], err_msg=k)


def _head_outputs(seed, size=64):
    """JAX head outputs of a trained-for-nothing model, as numpy."""
    jm, pm = _pair(seed)
    cls, reg = jm(_jt(_images(size=size, seed=seed)))
    return jm, pm, [_np(c) for c in cls], [_np(r) for r in reg]


def _jax_assign(jm, cls_np, reg_np, gtb, gtl, topk=9, alpha=1.0, beta=6.0):
    """``is_pos`` and ``best_gt`` by the lines of the JAX loss
    (``paddle_tpu/vision/models/ppyoloe.py:320-366``), image by image."""
    from paddle_tpu.vision.models.ppyoloe import _grid_points

    b, nc, rmax = cls_np[0].shape[0], jm.num_classes, jm.reg_max
    pts, sts = _grid_points([c.shape[2:] for c in cls_np], jm.STRIDES)
    cls_cat = jnp.transpose(jnp.concatenate(
        [c.reshape(b, nc, -1) for c in cls_np], -1), (0, 2, 1))
    reg_cat = jnp.transpose(jnp.concatenate(
        [r.reshape(b, 4 * (rmax + 1), -1) for r in reg_np], -1),
        (0, 2, 1)).reshape(b, -1, 4, rmax + 1)
    p, s = jnp.asarray(pts), jnp.asarray(sts)
    bins = jnp.arange(rmax + 1, dtype=jnp.float32)
    ltrb = jnp.sum(jax.nn.softmax(reg_cat, -1) * bins, -1)
    pred = jnp.concatenate([p[None] - ltrb[..., :2] * s[None, :, None],
                            p[None] + ltrb[..., 2:] * s[None, :, None]], -1)

    def iou(a, g):
        lt = jnp.maximum(a[:, None, :2], g[None, :, :2])
        rb = jnp.minimum(a[:, None, 2:], g[None, :, 2:])
        wh = jnp.clip(rb - lt, 0)
        inter = wh[..., 0] * wh[..., 1]
        aa = jnp.prod(jnp.clip(a[:, 2:] - a[:, :2], 0), -1)
        ga = jnp.prod(jnp.clip(g[:, 2:] - g[:, :2], 0), -1)
        return inter / jnp.maximum(aa[:, None] + ga[None] - inter, 1e-9)

    out = []
    for bi in range(b):
        g, gl = jnp.asarray(gtb[bi]), jnp.asarray(gtl[bi])
        valid_g = gl >= 0
        scores_d = jax.nn.sigmoid(cls_cat[bi])
        ious = iou(pred[bi], g)
        cls_g = scores_d[:, jnp.clip(gl, 0, nc - 1)]
        metric = (cls_g ** alpha) * (ious ** beta)
        inside = ((p[:, None, 0] >= g[None, :, 0]) &
                  (p[:, None, 0] <= g[None, :, 2]) &
                  (p[:, None, 1] >= g[None, :, 1]) &
                  (p[:, None, 1] <= g[None, :, 3]))
        metric = jnp.where(inside & valid_g[None], metric, -1.0)
        k = min(topk, metric.shape[0])
        thresh = jnp.sort(metric, axis=0)[-k][None]
        cand = (metric >= jnp.maximum(thresh, 0)) & (metric > 0)
        out.append((np.asarray(jnp.any(cand, axis=1)),
                    np.asarray(jnp.argmax(jnp.where(cand, metric, -1),
                                          axis=1))))
    return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_assignment_match_jax(seed):
    """The same head outputs through both losses: the value and its
    gradient on the outputs at 1e-5, the assignment exactly."""
    jm, pm, cls_np, reg_np = _head_outputs(seed)
    jouts = [_jt(a) for a in cls_np + reg_np]
    for t in jouts:
        t.stop_gradient = False
    jloss = JaxPPYOLOELoss(jm)(
        (jouts[:3], jouts[3:]), _jt(GT_BOXES), _jt(GT_LABELS))
    jloss.backward()
    pouts = [torch.from_numpy(a).requires_grad_() for a in cls_np + reg_np]
    crit = PPYOLOELoss(pm)
    ploss = crit((pouts[:3], pouts[3:]), torch.from_numpy(GT_BOXES),
                 torch.from_numpy(GT_LABELS))
    ploss.backward()
    np.testing.assert_allclose(float(ploss), float(_np(jloss)), rtol=1e-5)
    for g, w in zip(pouts, jouts):
        np.testing.assert_allclose(g.grad.numpy(), _np(w.grad), rtol=1e-5,
                                   atol=1e-7)
    cls, reg, p, s = _flat(([torch.from_numpy(a) for a in cls_np],
                            [torch.from_numpy(a) for a in reg_np]), 4, 16)
    got = crit.assign(cls, _boxes(reg, p, s), p, torch.from_numpy(GT_BOXES),
                      torch.from_numpy(GT_LABELS))
    is_pos, best_gt = _jax_assign(jm, cls_np, reg_np, GT_BOXES, GT_LABELS)
    np.testing.assert_array_equal(got["is_pos"].numpy(), is_pos)
    np.testing.assert_array_equal(got["best_gt"].numpy(), best_gt)
    assert is_pos.any()


def test_momentum_steps_match_jax():
    """``bench_ppyoloe``'s recipe for three f32 steps: the port's step
    against the JAX eager tape (forward, ``loss.backward()``,
    ``Momentum.step()``)."""
    jm, pm = _pair(seed=2)
    x = _images(seed=2)
    jopt = paddle.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                                     parameters=jm.parameters(),
                                     weight_decay=5e-4)
    jcrit = JaxPPYOLOELoss(jm)
    want = []
    for _ in range(3):
        loss = jcrit(jm(_jt(x)), _jt(GT_BOXES), _jt(GT_LABELS))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        want.append(float(loss.numpy()))
    step = make_train_step(pm, Momentum(0.01, momentum=0.9, parameters=pm,
                                        weight_decay=5e-4),
                           loss_fn=PPYOLOELoss(pm), num_labels=2)
    got = [float(step(x, GT_BOXES, GT_LABELS)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert step.compile_count == 1
    after = _state(jm)
    for k, v in to_jax_state(pm).items():
        np.testing.assert_allclose(v, after[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_fuse_in_eval_matches_jax():
    jm, pm = _pair(seed=3)
    x = _images(seed=3)
    for m in (jm, pm):          # move the running statistics off 0 / 1
        m(_jt(x) if m is jm else torch.from_numpy(x))
        m.eval()
    ref = [c.detach().numpy() for c in pm(torch.from_numpy(x))[0]]
    jm.fuse()
    pm.fuse()
    jcls, jreg = jm(_jt(x))
    with torch.no_grad():
        pcls, preg = pm(torch.from_numpy(x))
    for g, w in zip(list(pcls) + list(preg), list(jcls) + list(jreg)):
        _close(g.numpy(), _np(w))
    for g, r in zip(pcls, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-3, atol=1e-4)
    assert sorted(to_jax_state(pm)) == sorted(_state(jm))


def test_predict_matches_jax_decode_and_nms():
    jm, pm = _pair(seed=4)
    jm.eval()
    pm.eval()
    x = _images(seed=4)
    iou_thr, max_dets = 0.5, 20
    boxes, scores = jm.decode(jm(_jt(x)))
    # the score threshold halfway between two neighbouring best scores, so
    # three quarters of the points pass and none sits on the threshold
    best_all = np.sort(_np(scores).max(-1).reshape(-1))
    mid = len(best_all) // 4
    thr = float(best_all[mid - 1] + best_all[mid]) / 2
    got = pm.predict(torch.from_numpy(x), score_threshold=thr,
                     nms_threshold=iou_thr, max_dets=max_dets)
    assert len(got) == 2
    for i, (pb, ps) in enumerate(got):
        b, s = _np(boxes)[i], _np(scores)[i]
        best = s.max(-1)
        idx = np.nonzero(best > thr)[0]
        assert len(idx)
        keep = idx[_np(jops.nms(_jt(b[idx]), iou_threshold=iou_thr,
                                scores=_jt(best[idx]), top_k=max_dets))]
        assert 0 < len(keep) <= max_dets
        _close(pb, b[keep])
        _close(ps, s[keep])

"""The port's ``vision.ops`` against the JAX package's, on the CPU.

The same seeded numpy inputs go through both; the JAX side at
``jax_default_matmul_precision`` "highest" (``tests/conftest.py``).

* Float outputs, and the gradients where the JAX op has them (through
  ``loss = sum(out * w)`` with a fixed random ``w``): rtol 1e-5 with an
  absolute floor of 1e-5 of the largest value compared, f32 (the
  convolution-like sums run in another order).  ``yolo_box`` (forward:
  the JAX op records no gradient),
  ``_bilinear_gather``, ``roi_align`` (fixed and adaptive sampling,
  aligned or not, RoIs past the map's edge), ``psroi_pool``,
  ``box_coder`` (encode, decode on each axis, the variance forms),
  ``deform_conv2d`` (with and without the mask, groups, deformable
  groups, stride, padding, dilation; gradients of x, offset, mask,
  weight and bias) and the layers ``DeformConv2D``, ``RoIAlign``,
  ``PSRoIPool``, ``RoIPool``; ``prior_box``, ``roi_pool``,
  ``distribute_fpn_proposals`` and ``generate_proposals`` forward.
* The NMS family (``nms``, ``multiclass_nms``, ``matrix_nms``,
  ``generate_proposals``'s selection) on inputs without tied scores: the
  kept indices exactly, and the rows they keep at 1e-5.
* ``read_file`` and ``decode_jpeg`` byte for byte.
* The public names: every name of ``paddle_tpu.vision``, ``.ops``,
  ``.models`` and ``.transforms`` (``dir()``) exists in the port's
  counterpart, the JAX modules' own imports of ``jax`` aside.

The spec is ``tests/test_vision.py``'s op tests and
``tests/test_vision_ops_extra.py:14-110``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as jpaddle
from paddle_tpu.vision import ops as J

import paddle_tpu_torch as paddle
from paddle_tpu_torch.vision import ops as P
from _torch_cpu_place import cpu_place  # noqa: F401,E402

torch.set_num_threads(2)


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape) *
            scale).astype(np.float32)


def _np(v):
    if isinstance(v, (jpaddle.Tensor, paddle.Tensor)):
        return v.numpy()
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _close(got, want, err_msg=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    floor = 1e-5 * max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=floor,
                               err_msg=err_msg)


def _jt(a, grad=False):
    t = jpaddle.to_tensor(np.asarray(a))
    if grad:
        t.stop_gradient = False
    return t


def _tt(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_(True) if grad else t


def _grads(fn_j, fn_p, arrays, grad_idx, seed=9):
    """Forward of both sides over ``arrays``, then the gradients of
    ``sum(out * w)`` for the inputs in ``grad_idx``."""
    jin = [_jt(a, i in grad_idx) if a is not None else None
           for i, a in enumerate(arrays)]
    pin = [_tt(a, i in grad_idx) if a is not None else None
           for i, a in enumerate(arrays)]
    jout, pout = fn_j(*jin), fn_p(*pin)
    _close(pout, jout, "forward")
    w = _rand(seed, *_np(jout).shape)
    (jout * _jt(w)).sum().backward()
    (pout * torch.from_numpy(w)).sum().backward()
    for i in grad_idx:
        _close(pin[i].grad, jin[i].grad, f"grad {i}")


# -- yolo_box -----------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"clip_bbox": False}, {"scale_x_y": 1.05},
    {"iou_aware": True, "iou_aware_factor": 0.4},
    {"conf_thresh": 0.5}], ids=["plain", "noclip", "scale_xy", "iou_aware",
                                "conf0.5"])
def test_yolo_box_matches_jax(kw):
    kw = dict(kw)
    conf = kw.pop("conf_thresh", 0.01)
    na, cls, h = 3, 4, 5
    ch = na * (5 + cls) + (na if kw.get("iou_aware") else 0)
    x = _rand(0, 2, ch, h, h)
    img = np.array([[160, 160], [120, 200]], "int32")
    anchors = [10, 13, 16, 30, 33, 23]
    jb, js = J.yolo_box(_jt(x), _jt(img), anchors, cls, conf, 32, **kw)
    pb, ps = P.yolo_box(_tt(x), _tt(img), anchors, cls, conf, 32, **kw)
    _close(pb, jb)
    _close(ps, js)
    tb, ts = P.yolo_box(paddle.to_tensor(x), paddle.to_tensor(img), anchors,
                        cls, conf, 32, **kw)
    assert isinstance(tb, paddle.Tensor) and isinstance(ts, paddle.Tensor)


# -- roi_align / psroi_pool ---------------------------------------------------

def test_bilinear_gather_matches_jax():
    feat = _rand(2, 3, 6, 7)
    ys = np.random.RandomState(3).uniform(-2, 8, (5, 4)).astype(np.float32)
    xs = np.random.RandomState(4).uniform(-2, 9, (5, 4)).astype(np.float32)
    want = J._bilinear_gather(jax.numpy.asarray(feat), jax.numpy.asarray(ys),
                              jax.numpy.asarray(xs))
    got = P._bilinear_gather(_tt(feat), _tt(ys), _tt(xs))
    _close(got, np.asarray(want))


BOXES = np.array([[1.0, 2.0, 9.5, 11.0], [0.0, 0.0, 15.0, 15.0],
                  [4.3, 3.7, 7.1, 12.9], [-3.0, 10.0, 5.0, 19.0],
                  [2.2, 1.1, 30.0, 12.0]], np.float32)
BOXES_NUM = np.array([2, 3], np.int32)


@pytest.mark.parametrize("sr,aligned,scale", [
    (2, True, 1.0), (2, False, 0.5), (-1, True, 1.0), (-1, False, 0.5),
    (3, True, 0.75)])
def test_roi_align_matches_jax(sr, aligned, scale):
    x = _rand(5, 2, 3, 16, 16)
    _grads(lambda a, b, n: J.roi_align(a, b, n, (3, 4), scale, sr, aligned),
           lambda a, b, n: P.roi_align(a, b, n, (3, 4), scale, sr, aligned),
           [x, BOXES, BOXES_NUM], (0, 1))


def test_roi_align_on_no_rois_and_its_layer():
    x = _rand(6, 1, 2, 8, 8)
    got = P.roi_align(_tt(x), _tt(np.zeros((0, 4), np.float32)),
                      _tt(np.array([0], np.int32)), 2, sampling_ratio=2)
    assert tuple(got.shape) == (0, 2, 2, 2)
    want = J.RoIAlign(2, 0.5)(_jt(x), _jt(BOXES[:2]),
                              _jt(np.array([2], np.int32)), aligned=False)
    got = P.RoIAlign(2, 0.5)(_tt(x), _tt(BOXES[:2]),
                             _tt(np.array([2], np.int32)), aligned=False)
    _close(got, want)


@pytest.mark.parametrize("size,scale", [(2, 1.0), ((3, 2), 0.5)])
def test_psroi_pool_matches_jax(size, scale):
    ph, pw = (size, size) if isinstance(size, int) else size
    x = _rand(7, 2, 2 * ph * pw, 12, 12)
    _grads(lambda a, b, n: J.psroi_pool(a, b, n, size, scale),
           lambda a, b, n: P.psroi_pool(a, b, n, size, scale),
           [x, BOXES, BOXES_NUM], (0,))
    want = J.PSRoIPool(size, scale)(_jt(x), _jt(BOXES), _jt(BOXES_NUM))
    got = P.PSRoIPool(size, scale)(_tt(x), _tt(BOXES), _tt(BOXES_NUM))
    _close(got, want)


@pytest.mark.parametrize("size,scale", [(2, 1.0), ((3, 2), 0.5)])
def test_roi_pool_matches_jax(size, scale):
    x = _rand(8, 2, 3, 12, 12)
    want = J.roi_pool(_jt(x), _jt(BOXES), _jt(BOXES_NUM), size, scale)
    got = P.roi_pool(_tt(x), _tt(BOXES), _tt(BOXES_NUM), size, scale)
    _close(got, want)
    got = P.RoIPool(size, scale)(paddle.to_tensor(x),
                                 paddle.to_tensor(BOXES),
                                 paddle.to_tensor(BOXES_NUM))
    assert isinstance(got, paddle.Tensor)
    _close(got, want)


# -- box_coder / prior_box ----------------------------------------------------

def _boxes(seed, n, lo=0.0, hi=1.0):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(lo, hi * 0.6, (n, 2))
    wh = rng.uniform(hi * 0.05, hi * 0.4, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("case", ["enc", "enc-var2d", "enc-pixels",
                                  "dec-axis0", "dec-axis1", "dec-var2d-1",
                                  "dec-flat", "dec-novar"])
def test_box_coder_matches_jax(case):
    prior = _boxes(10, 5)
    var = [0.1, 0.1, 0.2, 0.2]
    var2d = np.abs(_rand(11, 5, 4)) * 0.2 + 0.05
    kw = {}
    if case.startswith("enc"):
        target = _boxes(12, 3)
        code = "encode_center_size"
        pv = var2d if case == "enc-var2d" else var
        if case == "enc-pixels":
            prior, target = prior * 50, target * 50
            kw["box_normalized"] = False
    else:
        code = "decode_center_size"
        axis = 1 if case in ("dec-axis1", "dec-var2d-1") else 0
        target = _rand(13, 5, 5, 4, scale=0.3) if case != "dec-flat" \
            else _rand(13, 5, 4, scale=0.3)
        pv = var2d if case == "dec-var2d-1" else (
            None if case == "dec-novar" else var)
        kw["axis"] = axis
    jv = pv if pv is None or isinstance(pv, list) else _jt(pv)
    tv = pv if pv is None or isinstance(pv, list) else _tt(pv)
    _grads(lambda p, t: J.box_coder(p, jv, t, code, **kw),
           lambda p, t: P.box_coder(p, tv, t, code, **kw),
           [prior, target], (0, 1))


@pytest.mark.parametrize("kw", [
    dict(min_sizes=[8.0]),
    dict(min_sizes=[8.0, 16.0], max_sizes=[16.0, 32.0],
         aspect_ratios=[2.0, 3.0], flip=True, clip=True),
    dict(min_sizes=[4.0], max_sizes=[9.0], aspect_ratios=[0.5],
         min_max_aspect_ratios_order=True, steps=(4.0, 5.0), offset=0.3)])
def test_prior_box_matches_jax(kw):
    feat, image = _rand(14, 1, 4, 5, 6), _rand(15, 1, 3, 40, 48)
    jb, jv = J.prior_box(_jt(feat), _jt(image), **kw)
    pb, pv = P.prior_box(_tt(feat), _tt(image), **kw)
    _close(pb, jb)
    _close(pv, jv)


# -- the NMS family -----------------------------------------------------------

def _det_inputs(seed, n=2, m=40, c=4, pixels=False):
    rng = np.random.RandomState(seed)
    boxes = np.stack([_boxes(seed + i, m) for i in range(n)])
    if pixels:
        boxes = boxes * 100
    scores = rng.permutation(n * c * m).reshape(n, c, m).astype(
        np.float32) / (n * c * m)          # distinct: no ties
    return boxes, scores


def test_nms_takes_surface_tensors():
    boxes, scores = _det_inputs(16, n=1)
    want = J.nms(_jt(boxes[0]), 0.4, _jt(scores[0, 1])).numpy()
    got = P.nms(paddle.to_tensor(boxes[0]), 0.4,
                paddle.to_tensor(scores[0, 1]))
    assert isinstance(got, paddle.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw,batched,pixels", [
    ({}, True, False),
    (dict(score_threshold=0.3, keep_top_k=10, nms_threshold=0.5), True,
     False),
    (dict(normalized=False, nms_top_k=12, nms_eta=0.9, nms_threshold=0.7),
     True, True),
    (dict(background_label=-1, keep_top_k=-1, nms_top_k=-1), False, False)])
def test_multiclass_nms_matches_jax(kw, batched, pixels):
    boxes, scores = _det_inputs(17, pixels=pixels)
    if not batched:
        boxes, scores = boxes[0], scores[0]
    jd, ji, jn = J.multiclass_nms(_jt(boxes), _jt(scores), **kw)
    pd, pi, pn = P.multiclass_nms(_tt(boxes), _tt(scores), **kw)
    np.testing.assert_array_equal(_np(pi), _np(ji))
    np.testing.assert_array_equal(_np(pn), _np(jn))
    _close(pd, jd)
    assert len(_np(pi)) > 0


@pytest.mark.parametrize("kw", [
    dict(score_threshold=0.2), dict(score_threshold=0.1, use_gaussian=True,
                                    post_threshold=0.05, keep_top_k=15),
    dict(score_threshold=0.3, normalized=False, nms_top_k=9,
         background_label=-1)])
def test_matrix_nms_matches_jax(kw):
    boxes, scores = _det_inputs(18, pixels=not kw.get("normalized", True))
    jo, jn, ji = J.matrix_nms(_jt(boxes), _jt(scores), return_index=True,
                              **kw)
    po, pn, pi = P.matrix_nms(_tt(boxes), _tt(scores), return_index=True,
                              **kw)
    np.testing.assert_array_equal(_np(pi), _np(ji))
    np.testing.assert_array_equal(_np(pn), _np(jn))
    _close(po, jo)
    only = P.matrix_nms(_tt(boxes), _tt(scores), return_rois_num=False,
                        **kw)
    _close(only, jo)


@pytest.mark.parametrize("with_num", [False, True])
def test_distribute_fpn_proposals_matches_jax(with_num):
    rois = np.concatenate([_boxes(19, 12, hi=400.0),
                           _boxes(20, 9, hi=60.0)]).astype(np.float32)
    num = np.array([13, 8], np.int32) if with_num else None
    kw = dict(min_level=2, max_level=5, refer_level=4, refer_scale=224)
    jr = J.distribute_fpn_proposals(_jt(rois), rois_num=None if num is None
                                    else _jt(num), pixel_offset=with_num,
                                    **kw)
    pr = P.distribute_fpn_proposals(_tt(rois), rois_num=None if num is None
                                    else _tt(num), pixel_offset=with_num,
                                    **kw)
    assert len(pr) == len(jr)
    for g, w in zip(pr[0], jr[0]):
        _close(g, w)
    np.testing.assert_array_equal(_np(pr[1]), _np(jr[1]))
    if with_num:
        for g, w in zip(pr[2], jr[2]):
            np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("kw", [
    dict(pre_nms_top_n=60, post_nms_top_n=20, nms_thresh=0.5),
    dict(pre_nms_top_n=200, post_nms_top_n=50, nms_thresh=0.7,
         min_size=4.0, pixel_offset=True, return_rois_num=True)])
def test_generate_proposals_matches_jax(kw):
    n, a, h, w = 2, 3, 6, 7
    rng = np.random.RandomState(21)
    scores = rng.permutation(n * a * h * w).reshape(n, a, h, w).astype(
        np.float32) / (n * a * h * w)
    deltas = _rand(22, n, 4 * a, h, w, scale=0.2)
    anchors = (_boxes(23, h * w * a) * 64).reshape(h, w, a, 4)
    var = np.full((h, w, a, 4), 1.0, np.float32)
    img = np.array([[60, 70], [64, 50]], np.float32)
    want = J.generate_proposals(_jt(scores), _jt(deltas), _jt(img),
                                _jt(anchors), _jt(var), **kw)
    got = P.generate_proposals(_tt(scores), _tt(deltas), _tt(img),
                               _tt(anchors), _tt(var), **kw)
    assert len(got) == len(want)
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
    _close(got[0], want[0])
    if kw.get("return_rois_num"):
        np.testing.assert_array_equal(_np(got[2]), _np(want[2]))


# -- deform_conv2d ------------------------------------------------------------

DEFORM = {
    "dcn-v1": dict(x=(2, 4, 7, 7), w=(6, 4, 3, 3), kw={}),
    "dcn-v2-pad": dict(x=(1, 4, 6, 6), w=(5, 4, 3, 3), kw=dict(padding=1),
                       mask=True),
    "stride-dil": dict(x=(1, 4, 11, 10), w=(4, 4, 3, 3),
                       kw=dict(stride=2, padding=2, dilation=2), mask=True),
    "groups-dg2": dict(x=(2, 8, 6, 6), w=(6, 4, 3, 2),
                       kw=dict(padding=(1, 0), groups=2,
                               deformable_groups=2), mask=True),
    "1x1-bias": dict(x=(1, 3, 5, 5), w=(4, 3, 1, 1), kw={}, bias=True),
}


@pytest.mark.parametrize("case", list(DEFORM))
def test_deform_conv2d_matches_jax(case):
    spec = DEFORM[case]
    kw = spec["kw"]
    n, c, h, w = spec["x"]
    oc, _, kh, kw_ = spec["w"]
    sh, sw = (kw.get("stride", 1),) * 2
    ph, pw = kw.get("padding", 0) if isinstance(kw.get("padding", 0),
                                                tuple) else \
        (kw.get("padding", 0),) * 2
    dil = kw.get("dilation", 1)
    dg = kw.get("deformable_groups", 1)
    oh = (h + 2 * ph - (dil * (kh - 1) + 1)) // sh + 1
    ow = (w + 2 * pw - (dil * (kw_ - 1) + 1)) // sw + 1
    x = _rand(24, *spec["x"])
    off = _rand(25, n, dg * 2 * kh * kw_, oh, ow, scale=1.5)
    weight = _rand(26, *spec["w"], scale=0.3)
    bias = _rand(27, oc) if spec.get("bias") else None
    mask = np.random.RandomState(28).uniform(
        0, 1, (n, dg * kh * kw_, oh, ow)).astype(np.float32) \
        if spec.get("mask") else None
    arrays = [x, off, weight, bias, mask]
    grad_idx = tuple(i for i, a in enumerate(arrays) if a is not None)
    _grads(lambda a, o, wt, b, m: J.deform_conv2d(a, o, wt, b, mask=m, **kw),
           lambda a, o, wt, b, m: P.deform_conv2d(a, o, wt, b, mask=m, **kw),
           arrays, grad_idx)


def test_deform_conv2d_with_zero_offsets_is_a_plain_conv():
    import paddle_tpu_torch.nn.functional as F
    x, w = _rand(29, 1, 2, 8, 8), _rand(30, 4, 2, 3, 3)
    off = np.zeros((1, 18, 6, 6), np.float32)
    got = P.deform_conv2d(_tt(x), _tt(off), _tt(w))
    np.testing.assert_allclose(got.numpy(), F.conv2d(_tt(x), _tt(w)).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_deform_conv2d_layer_matches_jax():
    jpaddle.seed(3)
    jl = J.DeformConv2D(4, 6, 3, padding=1, deformable_groups=2)
    pl = P.DeformConv2D(4, 6, 3, padding=1, deformable_groups=2)
    assert sorted(pl.state_dict()) == sorted(jl.state_dict())
    pl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})
    x = _rand(31, 2, 4, 5, 5)
    off = _rand(32, 2, 36, 5, 5)
    mask = np.random.RandomState(33).uniform(0, 1, (2, 18, 5, 5)).astype(
        np.float32)
    want = jl(_jt(x), _jt(off), _jt(mask))
    got = pl(paddle.to_tensor(x), paddle.to_tensor(off),
             paddle.to_tensor(mask))
    assert isinstance(got, paddle.Tensor)
    _close(got, want)
    bound = 1.0 / np.sqrt(4 * 9)
    assert np.abs(pl.weight.numpy()).max() <= bound


# -- files, loss and names ----------------------------------------------------

def test_read_file_and_decode_jpeg_match_jax(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    arr = (np.random.RandomState(34).rand(12, 16, 3) * 255).astype("uint8")
    path = tmp_path / "img.jpg"
    Image.fromarray(arr).save(path, format="JPEG")
    jb, pb = J.read_file(str(path)), P.read_file(str(path))
    np.testing.assert_array_equal(pb.numpy(), jb.numpy())
    for mode in ("unchanged", "rgb", "gray"):
        np.testing.assert_array_equal(P.decode_jpeg(pb, mode).numpy(),
                                      J.decode_jpeg(jb, mode).numpy())


def test_every_public_vision_name_exists_in_the_port():
    import paddle_tpu.vision as jv
    import paddle_tpu_torch.vision as pv
    pairs = [(jv, pv), (jv.ops, pv.ops), (jv.models, pv.models),
             (jv.transforms, pv.transforms),
             (jv.transforms.functional, pv.transforms.functional)]
    jax_own = {"jax", "jnp", "apply_op"}
    for j, p in pairs:
        missing = {n for n in dir(j) if not n.startswith("_")} - set(
            dir(p)) - jax_own
        assert not missing, (j.__name__, sorted(missing))
    assert pv.transforms.__name__ == "paddle_tpu_torch.vision.transforms"
    assert pv.models.__name__ == "paddle_tpu_torch.vision.models"

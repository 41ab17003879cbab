"""The rest of vision on the card, against the CPU: ``chip_smoke.py``'s
phases 50-53 at small sizes, with their gates.

Every test here is marked ``cuda`` and skips without a card (decided in a
fixture at run time, so every worker collects the same tests); this file
imports no JAX.  Run on the chip: ``python -m pytest -m cuda
tests/test_torch_*.py``.

* The detection ops (``_op_case``: outputs and gradients within 1e-4 of
  the CPU's largest magnitude, kept indices equal): ``roi_align`` with
  fixed and adaptive sampling, ``deform_conv2d`` with the mask,
  ``generate_proposals``, ``multiclass_nms``, ``matrix_nms``,
  ``yolo_box`` and ``yolo_loss``.
* A model of each zoo family at its smallest input (``_zoo_parity``:
  f32 eval logits and f64 two-step losses within 1e-4 of the CPU's).
* A small YOLOv3 (``width=8``) trains in bf16 with falling losses, and
  three f32 steps agree with the CPU's at 1e-4; ``predict`` gives at
  most 100 finite rows an image.
* Phase 53's pipeline at batch 8 with 2 workers: the first batch equal
  to the host transforms bit for bit, every batch on the card.
"""
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu_torch as paddle


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the chip)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    paddle.set_device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.cuda
def test_detection_ops_on_the_card(cuda):
    from paddle_tpu_torch.vision import ops

    rs = np.random.RandomState(0)
    feat = _t(rs.standard_normal((2, 16, 40, 48)).astype(np.float32))
    xy = rs.uniform(0, 150, (40, 2))
    boxes = _t(np.concatenate([xy, xy + rs.uniform(4, 60, (40, 2))],
                              1).astype(np.float32))
    num = _t(np.array([25, 15], np.int32))
    rows = [chip_smoke._op_case(
        cuda, f"roi_align sr={sr}", lambda x, b, n, sr=sr: ops.roi_align(
            x, b, n, 7, spatial_scale=0.25, sampling_ratio=sr),
        (feat, boxes, num), grad_idx=(0,)) for sr in (2, -1)]
    x = _t(rs.standard_normal((2, 8, 12, 12)).astype(np.float32))
    off = _t(rs.standard_normal((2, 36, 12, 12)).astype(np.float32))
    w = _t((rs.standard_normal((8, 4, 3, 3)) * 0.2).astype(np.float32))
    mask = _t(rs.uniform(0, 1, (2, 18, 12, 12)).astype(np.float32))
    rows.append(chip_smoke._op_case(
        cuda, "deform_conv2d", lambda x, o, w, m: ops.deform_conv2d(
            x, o, w, padding=1, deformable_groups=2, groups=2, mask=m),
        (x, off, w, mask), grad_idx=(0, 1, 2, 3)))
    n, a, h, wd = 1, 3, 8, 10
    scores = _t((rs.permutation(n * a * h * wd).reshape(n, a, h, wd)
                 / (n * a * h * wd)).astype(np.float32))
    deltas = _t((rs.standard_normal((n, 4 * a, h, wd)) * 0.1).astype(
        np.float32))
    anchors = (rs.uniform(0, 100, (h, wd, a, 2)).repeat(2, -1)
               + np.array([0, 0, 24, 24])).astype(np.float32)
    rows.append(chip_smoke._op_case(
        cuda, "generate_proposals", lambda s, d, i, an, v:
        ops.generate_proposals(s, d, i, an, v, pre_nms_top_n=100,
                               post_nms_top_n=30, return_rois_num=True),
        (scores, deltas, _t(np.array([[128, 160]], np.float32)),
         _t(anchors), _t(np.ones_like(anchors))), host=True))
    xy = rs.uniform(0, 100, (2, 60, 2))
    bx = _t(np.concatenate([xy, xy + rs.uniform(4, 40, (2, 60, 2))],
                           -1).astype(np.float32))
    sc = _t((rs.permutation(2 * 5 * 60).reshape(2, 5, 60) / 600).astype(
        np.float32))
    rows.append(chip_smoke._op_case(
        cuda, "multiclass_nms", lambda b, s: ops.multiclass_nms(
            b, s, score_threshold=0.2, normalized=False), (bx, sc),
        host=True))
    rows.append(chip_smoke._op_case(
        cuda, "matrix_nms", lambda b, s: ops.matrix_nms(
            b, s, 0.2, return_index=True), (bx, sc), host=True))
    head = _t(rs.standard_normal((2, 27, 8, 8)).astype(np.float32))
    gtb = _t(np.array([[[0.5, 0.5, 0.3, 0.4], [0, 0, 0, 0]],
                       [[0.2, 0.3, 0.1, 0.2], [0.7, 0.6, 0.2, 0.3]]],
                      np.float32))
    gtl = _t(np.array([[1, -1], [2, 3]], np.int64))
    anchors = [10, 13, 16, 30, 33, 23]
    rows.append(chip_smoke._op_case(
        cuda, "yolo_box", lambda x, i: ops.yolo_box(x, i, anchors, 4, 0.01,
                                                    8),
        (head, _t(np.array([[64, 64], [64, 48]], np.int32)))))
    rows.append(chip_smoke._op_case(
        cuda, "yolo_loss", lambda x, g, lab: ops.yolo_loss(
            x, g, lab, anchors, [0, 1, 2], 4, 0.5, 8),
        (head, gtb, gtl), grad_idx=(0,), host=True))
    assert all(r["rel_err"] <= chip_smoke.OPS_TOL for r in rows)
    assert rows[0]["syncs"] == 0 and rows[2]["syncs"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("fname,size,ch", [
    ("LeNet", 28, 1), ("squeezenet1_1", 64, 3), ("mobilenet_v3_small", 64, 3),
    ("shufflenet_v2_x0_5", 64, 3), ("googlenet", 224, 3)])
def test_zoo_parity_on_the_card(cuda, fname, size, ch):
    row = chip_smoke._zoo_parity(fname, size, ch, cuda, 3)
    assert row["logits_rel_err"] <= chip_smoke.ZOO_TOL
    assert row["two_step_rel_err"] <= chip_smoke.ZOO_TOL


@pytest.mark.cuda
def test_small_yolov3_trains_on_the_card(cuda):
    from paddle_tpu_torch.vision.models import yolov3

    chip_smoke._seed_weights(0)
    model = yolov3(width=8, neck_channel=32, device=cuda)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 3, 128, 128)
                         .astype(np.float32)).to(cuda)
    gtb, gtl = chip_smoke._yolo_gt(1, 2, 128)
    step = chip_smoke._yolo_step(model, 0.001, torch.bfloat16)
    losses = [float(step(x, _t(gtb).to(cuda), _t(gtl).to(cuda)))
              for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    rows = model.predict(x, torch.tensor([[128, 128]] * 2, device=cuda))
    assert len(rows) == 2 and all(
        r.shape[1] == 6 and r.shape[0] <= 100 and np.isfinite(r).all()
        for r in rows)
    px = np.random.RandomState(2).randn(2, 3, 64, 64).astype(np.float32)
    pgb, pgl = chip_smoke._yolo_gt(3, 2, 64)

    def build(where):
        chip_smoke._seed_weights(0)
        return yolov3(width=8, neck_channel=32, device=where)

    def run(m):
        st = chip_smoke._yolo_step(m, 0.001)
        return [float(st(px, pgb, pgl)) for _ in range(3)]

    res = chip_smoke._parity("yolov3 card test", build, run, cuda, 1e-4)
    assert res["max_rel_diff"] <= 1e-4


@pytest.mark.cuda
def test_input_pipeline_on_the_card(cuda, monkeypatch):
    for k, v in dict(PIPE_B=8, PIPE_WORKERS=2, PIPE_WARM=1,
                     PIPE_STEPS=2).items():
        monkeypatch.setattr(chip_smoke, k, v)
    res = chip_smoke.phase_input_pipeline(cuda, "card test", 5)
    assert res["first_batch_bitwise_equal"]
    assert res["batches"] == 3

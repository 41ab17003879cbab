"""Sparse gradients and the sparse package on the card, against the CPU:
``chip_smoke.py``'s phases 48 and 49 at small sizes, with their gates.

Every test here is marked ``cuda`` and skips without a card (decided in a
fixture at run time, so every worker collects the same tests); this file
imports no JAX.  Run on the chip: ``python -m pytest -m cuda
tests/test_torch_*.py``.

* Phase 48 at 26 tables of 2,000 rows, batch 256 (the sweep at 500 rows,
  batch 64): sparse and dense tables after 3 SGD steps (1e-6 relative),
  a clipped step, Adam's lazy update (step 1 against the dense update,
  untouched rows bit for bit, touched rows against the JAX rule at 1e-5),
  the ten optimizers against a CPU copy (1e-5), the train step's dense
  gradients and its operations, the same as the dense net's.
* Phase 49 at a 1/8 KITTI grid, 2 frames of 2,000 voxels: every rulebook
  equal to the CPU's, 8 built and 4 reused, one host sync a forward for
  each strided layer, values and weight gradients against the CPU path
  (1e-4), ``fused_attention`` and the op sweep against the CPU (1e-5).
"""
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


@pytest.mark.cuda
def test_dlrm_sparse_gradients_on_the_card(cuda):
    res = chip_smoke.phase_dlrm(
        cuda, 0, "card test", cfg=dict(tables=26, rows=2000, dim=128,
                                       batch=256),
        sweep=dict(rows=500, batch=64), steps=2)
    assert res["sgd_table_rel_err"] <= chip_smoke.DLRM_SGD_TOL
    assert res["adam_step1_rel_err"] <= chip_smoke.DLRM_SGD_TOL
    assert set(res["sweep"]) == {n for n, _ in chip_smoke.SPARSE_OPTIMIZERS}
    # the lazy update merges each table's rows: a host read a table
    assert res["sparse"]["syncs_a_step"] >= 26
    assert res["dense"]["syncs_a_step"] < res["sparse"]["syncs_a_step"]


@pytest.mark.cuda
def test_second_backbone_and_sparse_ops_on_the_card(cuda):
    res = chip_smoke.phase_second(
        cuda, 0, "card test",
        cfg=dict(spatial=(41, 200, 176), voxels=2000, batch=2, channels=4),
        attn=dict(B=1, H=2, M=128, D=16, band=16, globals=2), steps=2)
    strided = sum(not subm for subm, *_ in chip_smoke.SECOND_LAYERS)
    assert (res["built"], res["reused"]) == (8, 4)
    assert res["syncs_a_forward"] == strided
    assert res["cpu_rel_err"] <= chip_smoke.SECOND_TOL
    assert [r["n_in"] for r in res["layers"]][:2] == [4000, 4000]

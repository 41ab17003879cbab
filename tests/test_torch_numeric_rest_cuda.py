"""Entry 12's second half on the card, against the CPU: ``chip_smoke.py``'s
phase 56 at small sizes, with its gates.

Every test here is marked ``cuda`` and skips without a card (decided in a
fixture at run time, so every worker collects the same tests); this file
imports no JAX.  Run on the chip: ``python -m pytest -m cuda
tests/test_torch_*.py``.

* ``audio``'s four layers on 2 clips of 1 s (1e-4 of the CPU's largest
  magnitude).
* 10^5 draws from each of the fourteen distributions on the card (moments
  within 5 standard errors, the same draws under one seed), their
  ``log_prob`` / ``entropy`` and the eight KL pairs at 1e-5.
* ``incubate.autograd``'s batched ``Jacobian`` and ``Hessian`` at 1e-5.
* ``asp`` on a ``Linear(256, 256)``: the card's mask equal to the CPU's,
  density exactly 0.5 over 3 SGD steps.
* A 1 MiB card Tensor through a spawned consumer and back, bit for bit,
  no segment left in ``/dev/shm``.
* A ``cpp_extension`` op and its gradient on a card Tensor; ``dlpack``
  keeps the card pointer.
"""
import copy

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
    prev = paddle.get_device()
    paddle.set_device("gpu:0")
    yield torch.device("cuda", 0)
    paddle.set_device(prev)


@pytest.mark.cuda
def test_audio_layers_on_the_card(cuda):
    from paddle_tpu_torch import audio

    clips = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (2, 16000)).astype(np.float32))
    kw = dict(sr=16000, n_fft=512, hop_length=160)
    for layer in (audio.Spectrogram(n_fft=512, hop_length=160),
                  audio.MelSpectrogram(**kw),
                  audio.LogMelSpectrogram(top_db=80.0, **kw),
                  audio.MFCC(**kw)):
        pair = {"cuda": layer.to(cuda), "cpu": copy.deepcopy(layer).to("cpu")}
        row = chip_smoke._op_case(cuda, type(layer).__name__,
                                  lambda a: pair[a.device.type](a), (clips,))
        assert row["rel_err"] <= 1e-4 and row["syncs"] == 0


@pytest.mark.cuda
def test_distributions_on_the_card(cuda, monkeypatch):
    monkeypatch.setattr(chip_smoke, "N_DRAWS", 100_000)
    res = chip_smoke._phase56_distributions(cuda, 3)
    assert len(res["rows"]) == 14
    assert all(r["moment_gap_se"] < 5 for r in res["rows"])
    assert res["kl_rel_err"] <= 1e-5


@pytest.mark.cuda
def test_jacobian_and_hessian_on_the_card(cuda):
    res = chip_smoke._phase56_autograd(cuda, 4)
    assert res["jacobian_shape"] == [8, 8, 16]
    assert res["hessian_shape"] == [8, 16, 16]
    assert res["rel_err"] <= 1e-5


@pytest.mark.cuda
def test_asp_on_the_card(cuda, monkeypatch):
    monkeypatch.setattr(chip_smoke, "ASP_N", 256)
    assert chip_smoke._phase56_asp(cuda, 5)["density"] == [0.5] * 3


@pytest.mark.cuda
def test_card_tensor_through_a_spawned_consumer(cuda, monkeypatch):
    monkeypatch.setattr(chip_smoke, "MP_BYTES", 1 << 20)
    res = chip_smoke._phase56_multiprocessing(cuda, 6)
    assert res["bytes"] == 1 << 20


@pytest.mark.cuda
def test_cpp_extension_and_dlpack_on_the_card(cuda):
    assert chip_smoke._phase56_ext(cuda)["dlpack_same_ptr"]

"""The port's BERT / ERNIE against the JAX package, on the CPU (bert-tiny,
f32; the JAX side at ``jax_default_matmul_precision`` "highest", as
``tests/conftest.py`` sets it).  Weights go from the JAX model to the
port's through ``load_jax_state``.

* The configurations and presets equal JAX's.
* The forward: sequence, pooled, MLM and NSP outputs, without a mask
  (the port's flash wrapper, whose plain version runs on CPU tensors)
  and with a padding mask (the plain attention with the additive ``(1 -
  m) * -1e4`` bias, as JAX), to 1e-5 (f32 sums in another order); an
  unmasked call reaches the flash wrapper once a layer on the role views
  of the fused projection, a masked one never.
* ERNIE's task-type embedding (task 0 by default), to 1e-5.
* The criterion with ignored labels, a fully ignored row and all labels
  ignored, with and without NSP labels, to 1e-6.
* Three ``make_train_step`` AdamW steps against the JAX step (losses
  1e-5 relative, parameters to ``test_torch_moe.py``'s step tolerances:
  1e-4 except where the first gradient is f32 noise, all but 1e-3 of each
  tensor's elements 2e-6, the key bias apart).  The JAX step keeps the
  tied table as two entries; the port's one parameter is held to the live
  one, ``cls.decoder_weight``.
* The bench's bf16 recipe (bf16 parameters and AdamW slots, no
  ``compute_dtype``): three steps' losses within rtol 1e-2 of the JAX
  step's (one bf16 rounding, the tolerance of the port's bf16 tests).
* Weights JAX -> port -> JAX exactly, the decoder still tied.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.models import BERT_CONFIGS as JAX_BERT_CONFIGS
from paddle_tpu.models import BertPretrainingCriterion as JaxCriterion
from paddle_tpu.models import bert_config as jax_bert_config
from paddle_tpu.models import build_bert as jax_build_bert
from paddle_tpu.models import build_ernie as jax_build_ernie

from paddle_tpu_torch.distributed import make_train_step
from paddle_tpu_torch.models import (BERT_CONFIGS, BertForPretraining,
                                     BertModel, BertPretrainingCriterion,
                                     ErnieConfig, ErnieForPretraining,
                                     ErnieModel, bert_config, build_bert,
                                     build_ernie, load_jax_state,
                                     to_jax_state)
from paddle_tpu_torch.models.convert import _linear_weights
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(1)

TINY = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
ERNIE_TINY = dict(vocab_size=512, hidden_size=64, num_layers=2,
                  num_attention_heads=2, intermediate_size=128,
                  max_position_embeddings=64, **TINY)
TOL = dict(rtol=1e-5, atol=1e-5)


def _state(jm):
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


def _pair(seed=0, build=(jax_build_bert, build_bert), name="bert-tiny",
          **kw):
    paddle.seed(seed)
    jm = build[0](name, **kw)
    pm = build[1](name, device="cpu", **kw)
    load_jax_state(pm, _state(jm))
    return jm, pm


def _batch(b=2, t=16, vocab=1024, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (b, t)).astype(np.int64)
    labels = rs.randint(0, vocab, (b, t)).astype(np.int64)
    labels[:, ::3] = -100
    return ids, labels, rs.randint(0, 2, (b,)).astype(np.int64)


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else \
        np.asarray(x.numpy(), np.float32)


def test_configs_match_jax():
    assert BERT_CONFIGS == JAX_BERT_CONFIGS
    for name in BERT_CONFIGS:
        assert vars(bert_config(name)) == vars(jax_bert_config(name))
    assert ErnieConfig is type(bert_config("ernie-3.0-base"))
    assert (ErnieModel, ErnieForPretraining) == (BertModel,
                                                 BertForPretraining)
    with pytest.raises(KeyError, match="unknown config"):
        bert_config("bert-huge")
    assert bert_config("bert-base-uncased").layer_norm_epsilon == 1e-12


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
def test_forward_matches_jax(masked):
    jm, pm = _pair(**TINY)
    jm.eval()
    ids, _, _ = _batch()
    mask = None
    if masked:
        mask = np.ones_like(ids)
        mask[1, 11:] = 0
    jkw = {} if mask is None else dict(attention_mask=paddle.to_tensor(mask))
    pkw = {} if mask is None else dict(attention_mask=torch.from_numpy(mask))
    jseq, jpooled = jm.bert(paddle.to_tensor(ids), **jkw)
    jmlm, jnsp = jm(paddle.to_tensor(ids), **jkw)
    with torch.no_grad():
        seq, pooled = pm.bert(torch.from_numpy(ids), **pkw)
        mlm, nsp = pm(torch.from_numpy(ids), **pkw)
    for got, want in ((seq, jseq), (pooled, jpooled), (mlm, jmlm),
                      (nsp, jnsp)):
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_attention_routes_through_the_flash_wrapper_unmasked():
    from paddle_tpu_torch.nn.functional import attention as att

    _, pm = _pair(**TINY)
    seen = []
    inner = att.flash_attention_bthd

    def counted(q, k, v, **kw):
        seen.append((q.is_contiguous(), k.data_ptr() - q.data_ptr(),
                     kw["causal"]))
        return inner(q, k, v, **kw)

    att.flash_attention_bthd = counted
    try:
        ids = torch.from_numpy(_batch()[0])
        with torch.no_grad():
            pm(ids)
            assert len(seen) == 2
            # role views of one [B, T, 3, nh, hd] projection, not causal
            assert seen[0] == (False, 128 * 4, False)
            pm(ids, attention_mask=torch.ones_like(ids))
            assert len(seen) == 2
    finally:
        att.flash_attention_bthd = inner


def test_ernie_task_type_embedding_matches_jax():
    jm, pm = _pair(3, (jax_build_ernie, build_ernie), "ernie-3.0-medium",
                   for_pretraining=False, **ERNIE_TINY)
    jm.eval()
    assert pm.embeddings.task_type_embeddings.weight.shape == (3, 64)
    ids = _batch(2, 8, vocab=512)[0]
    task = np.zeros_like(ids)
    outs = []
    for t in (None, task, task + 1):
        jkw = {} if t is None else dict(task_type_ids=paddle.to_tensor(t))
        pkw = {} if t is None else dict(task_type_ids=torch.from_numpy(t))
        jseq, _ = jm(paddle.to_tensor(ids), **jkw)
        with torch.no_grad():
            seq, _ = pm(torch.from_numpy(ids), **pkw)
        np.testing.assert_allclose(_np(seq), _np(jseq), **TOL)
        outs.append(_np(seq))
    np.testing.assert_array_equal(outs[0], outs[1])     # task 0 by default
    assert np.abs(outs[2] - outs[1]).max() > 1e-4
    assert build_bert("bert-tiny", device="cpu").bert.embeddings \
        .task_type_embeddings is None


def test_criterion_matches_jax():
    rs = np.random.RandomState(4)
    logits = rs.randn(3, 8, 50).astype(np.float32)
    nsp_logits = rs.randn(3, 2).astype(np.float32)
    labels = rs.randint(0, 50, (3, 8)).astype(np.int64)
    labels[0, ::2] = -100
    labels[2] = -100                                # a fully ignored row
    nsp = np.array([0, 1, 1], np.int64)
    jc, pc = JaxCriterion(), BertPretrainingCriterion()
    for lab in (labels, np.full_like(labels, -100)):
        for ns in (nsp, None):
            want = jc(paddle.to_tensor(logits), paddle.to_tensor(nsp_logits),
                      paddle.to_tensor(lab),
                      None if ns is None else paddle.to_tensor(ns))
            got = pc(torch.from_numpy(logits), torch.from_numpy(nsp_logits),
                     torch.from_numpy(lab),
                     None if ns is None else torch.from_numpy(ns))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want.numpy()),
                                       rtol=1e-6)
    # all labels ignored and no NSP: 0 over max(0, 1)
    assert float(pc(torch.from_numpy(logits), None,
                    torch.full((3, 8), -100))) == 0.0


def _steps(jm, pm, batch, n=3, lr=1e-3):
    """n steps of the JAX step and of the port's from the same weights:
    (JAX losses, port losses, the port's first gradients in the JAX
    layout, the JAX step)."""
    jc, pc = JaxCriterion(), BertPretrainingCriterion()
    jstep = jdist.make_train_step(
        jm, paddle.optimizer.AdamW(learning_rate=lr,
                                   parameters=jm.parameters()),
        loss_fn=lambda out, lab, nsp: jc(out[0], out[1], lab, nsp),
        num_labels=2)
    step = make_train_step(
        pm, AdamW(learning_rate=lr, parameters=pm),
        loss_fn=lambda out, lab, nsp: pc(out[0], out[1], lab, nsp),
        num_labels=2)
    want = [float(jstep(*batch)) for _ in range(n)]
    got = [float(step(*batch))]
    linear = _linear_weights(pm)
    first = {k: (p.grad.float().numpy().T if k in linear
                 else p.grad.float().numpy())
             for k, p in pm.named_parameters()}
    got += [float(step(*batch)) for _ in range(n - 1)]
    return want, got, first, jstep


def test_train_steps_match_jax():
    jm, pm = _pair(5, **TINY)
    want, got, first, jstep = _steps(jm, pm, _batch(4, 64, seed=1))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    after = jstep.state_dict()["params"]
    port = to_jax_state(pm)
    names = [n for n, _ in pm.named_parameters()]
    assert "cls.decoder_weight" in names
    assert "bert.embeddings.word_embeddings.weight" not in names
    for k in names:
        diff = np.abs(port[k] - np.asarray(after[k]))
        g = np.abs(first[k])
        assert ((diff <= 1e-4) | (g <= 1e-6 * g.max())).all(), (k,
                                                               diff.max())
        close = diff <= 2e-6
        if k.endswith("qkv_proj.bias"):       # role-major [3, nh, hd]: the
            # key bias's gradient is 0 in exact arithmetic
            close = close.reshape(3, -1)[::2]
        assert np.mean(~close) <= 1e-3, k
    assert pm.cls.decoder_weight is pm.bert.embeddings.word_embeddings.weight


def test_bf16_recipe_losses_match_jax():
    """``bench_bert``'s recipe at bert-tiny: bf16 parameters and AdamW
    slots on both sides, no compute_dtype."""
    paddle.seed(6)
    jm = jax_build_bert("bert-tiny", **TINY)
    state = _state(jm)
    jm.to(dtype="bfloat16")
    pm = build_bert("bert-tiny", device="cpu", **TINY)
    load_jax_state(pm, state)
    pm.to(torch.bfloat16)
    assert pm.cls.decoder_weight is pm.bert.embeddings.word_embeddings.weight
    want, got, _, _ = _steps(jm, pm, _batch(4, 64, seed=2), lr=1e-4)
    assert all(np.isfinite(got)) and got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-2)
    assert all(p.dtype == torch.bfloat16 for p in pm.parameters())


def test_state_round_trip_is_exact_and_keeps_the_tie():
    jm, pm = _pair(7, **TINY)
    state = _state(jm)
    back = to_jax_state(pm)
    assert set(back) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert pm.cls.decoder_weight is pm.bert.embeddings.word_embeddings.weight
    with pytest.raises(KeyError, match="missing"):
        load_jax_state(pm, {k: v for k, v in state.items()
                            if not k.startswith("nsp")})
    # the port's own train state does not carry the tied table twice
    step = make_train_step(pm, AdamW(parameters=pm), loss_fn=lambda o, y: 0)
    sd = step.state_dict()
    assert "cls.decoder_weight" in sd["params"] and sd["buffers"] == {}

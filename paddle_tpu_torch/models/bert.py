"""BERT / ERNIE on the port: the counterpart of ``paddle_tpu/models/bert.py``.

Same configurations, module and parameter names (a JAX state dict loads
by name, ``models/convert.py``), and the same arithmetic:

* the block is post-LN: ``norm1(x + attn(x))``, then ``norm2(x +
  fc1(act(fc0(x))))``; LayerNorm epsilon 1e-12;
* the fused projection's columns are role-major: ``qkv_proj(x)`` views
  as ``[B, T, 3, nh, hd]`` and q, k, v are its strided role views, which
  the separate-operand flash kernel reads in place
  (``F.scaled_dot_product_attention`` -> ``flash_attention_bthd``, not
  causal; its backward through the single-tile kernels for T <= 1024);
* a ``[B, T]`` 1/0 ``attention_mask`` becomes the additive bias ``(1 -
  m) * -1e4`` ``[B, 1, 1, T]``; a masked call, and attention dropout in
  training, take the plain attention, as in JAX;
* the embeddings sum word, position, token-type and (ERNIE,
  ``task_type_vocab_size > 0``) task-type rows, then LayerNorm and
  dropout; the pooler is ``tanh(dense(h[:, 0]))``;
* the MLM head applies its activation *before* its LayerNorm, and its
  decoder is the word embedding itself (tied: one parameter under two
  state-dict names, ``cls.decoder_weight`` and
  ``bert.embeddings.word_embeddings.weight``; ``named_parameters()``
  gives the first) plus a bias of its own;
* :class:`BertPretrainingCriterion` is the summed MLM NLL over ``max(valid
  labels, 1)`` plus the NSP cross entropy's mean.

Hidden, embedding and attention dropout apply in training mode only, with
torch's generator (the JAX draws' distribution, not their bits).
``build_bert`` / ``build_ernie`` build on ``device`` (default ``"cuda"``;
raises without a card) with weights from ``seed`` and parameters in
``dtype``, as ``build_gpt``.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device
from ..nn import LayerNorm
from ..nn import functional as F

__all__ = ["BertConfig", "BERT_CONFIGS", "bert_config", "BertSelfAttention",
           "BertLayer", "BertEmbeddings", "BertPooler", "BertModel",
           "BertLMHead", "BertForPretraining", "BertPretrainingCriterion",
           "ErnieConfig", "ErnieModel", "ErnieForPretraining", "build_bert",
           "build_ernie"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    task_type_vocab_size: int = 0  # >0 = ERNIE task-type embedding
    activation: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    layer_norm_epsilon: float = 1e-12
    initializer_range: float = 0.02
    pad_token_id: int = 0

    def __post_init__(self):
        if self.activation not in F.ACTIVATIONS:
            raise ValueError(f"activation {self.activation!r} is not one of "
                             f"{sorted(F.ACTIVATIONS)}")


BERT_CONFIGS = {
    "bert-tiny": dict(vocab_size=1024, hidden_size=128, num_layers=2,
                      num_attention_heads=2, intermediate_size=512,
                      max_position_embeddings=128),
    "bert-base-uncased": dict(),
    "bert-large-uncased": dict(hidden_size=1024, num_layers=24,
                               num_attention_heads=16,
                               intermediate_size=4096),
    "ernie-3.0-medium": dict(vocab_size=40000, hidden_size=768,
                             num_layers=6, num_attention_heads=12,
                             intermediate_size=3072, task_type_vocab_size=3),
    "ernie-3.0-base": dict(vocab_size=40000, hidden_size=768, num_layers=12,
                           num_attention_heads=12, intermediate_size=3072,
                           task_type_vocab_size=3),
}


def bert_config(name: str, **overrides) -> BertConfig:
    if name not in BERT_CONFIGS:
        raise KeyError(f"unknown config {name!r}; have "
                       f"{sorted(BERT_CONFIGS)}")
    kw = dict(BERT_CONFIGS[name])
    kw.update(overrides)
    return BertConfig(**kw)


class BertSelfAttention(nn.Module):
    """Bidirectional attention over the role-major fused projection."""

    def __init__(self, config: BertConfig):
        super().__init__()
        h, nh = config.hidden_size, config.num_attention_heads
        if h % nh:
            raise ValueError(f"hidden {h} not divisible by heads {nh}")
        self.num_heads = nh
        self.head_dim = h // nh
        self.qkv_proj = nn.Linear(h, 3 * h)
        self.out_proj = nn.Linear(h, h)
        self.attn_dropout_prob = config.attention_dropout_prob

    def forward(self, x, attn_mask=None):
        b, t = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x).view(b, t, 3, self.num_heads, self.head_dim)
        out = F.scaled_dot_product_attention(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], attn_mask=attn_mask,
            dropout_p=self.attn_dropout_prob, is_causal=False,
            training=self.training)
        return self.out_proj(out.reshape(b, t, self.num_heads * self.head_dim))


class BertLayer(nn.Module):
    """Post-LN encoder block (the original BERT arrangement)."""

    def __init__(self, config: BertConfig):
        super().__init__()
        eps = config.layer_norm_epsilon
        h, ffn = config.hidden_size, config.intermediate_size
        self.self_attn = BertSelfAttention(config)
        self.norm1 = LayerNorm(h, epsilon=eps)
        self.fc0 = nn.Linear(h, ffn)
        self.fc1 = nn.Linear(ffn, h)
        self.norm2 = LayerNorm(h, epsilon=eps)
        self.act = getattr(F, config.activation)
        self.dropout1 = nn.Dropout(config.hidden_dropout_prob)
        self.dropout2 = nn.Dropout(config.hidden_dropout_prob)

    def forward(self, x, attn_mask=None):
        y = self.self_attn(x, attn_mask=attn_mask)
        x = self.norm1(x + self.dropout1(y))
        y = self.fc1(self.act(self.fc0(x)))
        return self.norm2(x + self.dropout2(y))


class BertEmbeddings(nn.Module):
    """word + position + token-type (+ ERNIE task-type) rows, LayerNorm,
    dropout."""

    def __init__(self, config: BertConfig):
        super().__init__()
        h = config.hidden_size
        self.max_positions = config.max_position_embeddings
        self.word_embeddings = nn.Embedding(config.vocab_size, h)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, h)
        self.token_type_embeddings = nn.Embedding(
            max(config.type_vocab_size, 1), h)
        self.task_type_embeddings = (
            nn.Embedding(config.task_type_vocab_size, h)
            if config.task_type_vocab_size > 0 else None)
        self.norm = LayerNorm(h, epsilon=config.layer_norm_epsilon)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                task_type_ids=None):
        t = input_ids.shape[1]
        if position_ids is None:
            if t > self.max_positions:
                # the JAX gather clamps such ids; a CUDA lookup would fault
                raise ValueError(f"sequence of {t} tokens past the "
                                 f"{self.max_positions} position embeddings")
            position_ids = torch.arange(t, device=input_ids.device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids) +
             self.position_embeddings(position_ids) +
             self.token_type_embeddings(token_type_ids))
        if self.task_type_embeddings is not None:
            if task_type_ids is None:       # task 0, as the reference
                task_type_ids = torch.zeros_like(input_ids)
            x = x + self.task_type_embeddings(task_type_ids)
        return self.dropout(self.norm(x))


class BertPooler(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.hidden_size)

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


class BertModel(nn.Module):
    """The encoder.  Output: ``(sequence [B, T, H], pooled [B, H])``."""

    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config)
        self.layers = nn.ModuleList([BertLayer(config)
                                     for _ in range(config.num_layers)])
        self.pooler = BertPooler(config)

    @staticmethod
    def _expand_mask(attention_mask):
        """``[B, T]`` 1/0 mask -> additive f32 ``[B, 1, 1, T]`` bias."""
        if attention_mask is None:
            return None
        return (1.0 - attention_mask.float()[:, None, None, :]) * -1e4

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, task_type_ids=None):
        mask = self._expand_mask(attention_mask)
        x = self.embeddings(input_ids, token_type_ids, position_ids,
                            task_type_ids)
        for layer in self.layers:
            x = layer(x, attn_mask=mask)
        return x, self.pooler(x)


class BertLMHead(nn.Module):
    """MLM head: ``norm(act(transform(h))) @ W_word^T + decoder_bias``,
    with ``decoder_weight`` the word embedding's parameter itself."""

    def __init__(self, config: BertConfig, embedding_weight):
        super().__init__()
        h = config.hidden_size
        self.transform = nn.Linear(h, h)
        self.norm = LayerNorm(h, epsilon=config.layer_norm_epsilon)
        self.act = getattr(F, config.activation)
        self.decoder_weight = embedding_weight      # tied [V, H]
        self.decoder_bias = nn.Parameter(torch.zeros(config.vocab_size))

    def forward(self, hidden):
        x = self.norm(self.act(self.transform(hidden)))
        return torch.matmul(x, self.decoder_weight.t()) + self.decoder_bias


class BertForPretraining(nn.Module):
    """MLM + NSP heads over :class:`BertModel`: ``(mlm logits [B, T, V],
    nsp logits [B, 2])``."""

    def __init__(self, config: BertConfig):
        super().__init__()
        bert = BertModel(config)
        # registered before ``bert``, so that ``named_parameters()`` names
        # the tied table ``cls.decoder_weight``, as the JAX model's
        # breadth-first ``named_parameters`` does (and its train step's
        # live entry for the table)
        self.cls = BertLMHead(config, bert.embeddings.word_embeddings.weight)
        self.bert = bert
        self.nsp = nn.Linear(config.hidden_size, 2)

    @property
    def config(self) -> BertConfig:
        return self.bert.config

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, task_type_ids=None):
        seq, pooled = self.bert(input_ids, token_type_ids, position_ids,
                                attention_mask, task_type_ids=task_type_ids)
        return self.cls(seq), self.nsp(pooled)


class BertPretrainingCriterion(nn.Module):
    """Masked-LM + NSP loss: the MLM NLL summed over the labels that are
    not -100, over ``max(their count, 1)``, plus the NSP cross entropy's
    mean when ``next_sentence_labels`` is given; f32."""

    def __init__(self, vocab_size=None):
        super().__init__()
        self.vocab_size = vocab_size

    def forward(self, prediction_logits, nsp_logits, masked_lm_labels,
                next_sentence_labels=None):
        nll = F.fused_nll_loss(prediction_logits, masked_lm_labels,
                               ignore_index=-100)
        valid = (masked_lm_labels != -100).float()
        loss = nll.reshape(-1).sum() / valid.sum().clamp(min=1.0)
        if next_sentence_labels is not None:
            loss = loss + F.cross_entropy(
                nsp_logits, next_sentence_labels.reshape(-1)).mean()
        return loss


ErnieConfig = BertConfig
ErnieModel = BertModel
ErnieForPretraining = BertForPretraining


def _init_weights(model: nn.Module, config: BertConfig, seed: int):
    """Normal(0, initializer_range) weights and embeddings (the residual
    projections ``out_proj`` and ``fc1`` scaled by 1/sqrt(2L)), zero
    biases, unit LayerNorms: the JAX model's recipe, drawn in place from a
    ``torch.Generator`` on the model's device (the values differ from
    JAX's; parity runs load the JAX weights instead)."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    std = config.initializer_range
    out_std = std / math.sqrt(2.0 * config.num_layers)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".norm" in name:
                p.fill_(1.0)
            else:
                s = out_std if ("out_proj" in name or "fc1" in name) else std
                p.normal_(0.0, s, generator=gen)


def build_bert(name_or_config="bert-tiny", for_pretraining=True, device=None,
               seed: int = 0, dtype=None, **overrides):
    """Build BERT (``BertForPretraining``, or ``BertModel`` without
    ``for_pretraining``) on ``device`` (default ``"cuda"``; raises without
    a card) in eval mode, weights from ``seed`` drawn there, floating
    parameters in ``dtype`` (default f32; the bench's bf16 recipe is
    ``dtype=torch.bfloat16``)."""
    dev = resolve_device(device)
    if isinstance(name_or_config, BertConfig):
        cfg = (dataclasses.replace(name_or_config, **overrides)
               if overrides else name_or_config)
    else:
        cfg = bert_config(name_or_config, **overrides)
    with dev:
        model = BertForPretraining(cfg) if for_pretraining else BertModel(cfg)
    if dtype is not None:
        model.to(dtype)
    _init_weights(model, cfg, seed)
    return model.eval()


def build_ernie(name_or_config="ernie-3.0-medium", for_pretraining=True,
                **kwargs):
    return build_bert(name_or_config, for_pretraining, **kwargs)

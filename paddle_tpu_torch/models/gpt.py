"""GPT on the port: the counterpart of ``paddle_tpu/models/gpt.py``.

Same configurations, same module and parameter names (so a JAX state
dict loads by name, ``models/convert.py``), same head-major fused-qkv
column layout ``[nh, 3, hd]`` and the same cache protocol as the JAX
model's serving path:

* no cache: causal self-attention through the fused flash kernel on the
  ``[B, T, nh, 3, hd]`` projection (``F.fused_qkv_attention``, as JAX's
  ``gpt.py:269``) — the training forward, differentiable;
* static prefill: a 3-tuple ``(k_buf, v_buf, 0)`` whose length is the
  Python int 0 — the new keys/values land at the head of the buffers and
  the prompt attends causally through the flash kernel;
* paged: the 4-tuple ``(k_pages, v_pages, lengths[B], page_table[B,
  n_pt])`` and the int8 6-tuple ``(..., k_scale, v_scale)``.  Position
  ``p`` of row ``r`` lives at ``pages[page_table[r, p // P], p % P]``.
  The new keys/values are written into the pools in place, then read
  back through the paged decode kernel.  Either tuple may end in
  :data:`SPARE_PAGE` (the serving engine's form): the pools then hold a
  spare page past the mappable ones, and the write has a fixed shape.

The LayerNorms are the port's ``nn.LayerNorm`` (``F.layer_norm``), so
``kernels.layer_norm.enable_fused_layernorm("full" | "bwd")`` sends them
through the fused LayerNorm kernels, in training and in the cached
(serving) branch alike.  With ``kernels.ln_matmul.enable_ln_matmul(True)``
the no-cache forward takes the fused pre-LN route of JAX's
``GPTDecoderLayer``: ``norm1 -> qkv_proj`` and ``norm2 -> fc0`` each run
as one ``F.fused_ln_linear`` (the ``ln_matmul`` kernel), and only
``final_norm`` stays a separate LayerNorm.  Both are off by default.

Hidden, embedding and attention dropout apply in training mode only, with
torch's generator (the JAX draws' distribution, not their bits).
``GPTPretrainingCriterion`` is the masked next-token loss.

The training recipe's options (``GPTConfig``):

* ``use_recompute``: in training each decoder layer runs under
  ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, as the
  JAX model's ``recompute(layer, x)``.  The layer's parameter values are
  inputs of the checkpointed function, as the JAX ``recompute`` passes the
  layer's state: the train step runs the model over values cast to its
  ``compute_dtype`` (``torch.func.functional_call``) and restores the
  masters before ``backward()``, so a replay that read the layer's
  attributes would recompute with the f32 masters.
* ``scan_layers``: accepted, and the same per-layer loop runs.  The JAX
  form scans one traced body over the stacked layer parameters (compile
  time that does not grow with depth; under recompute, one layer
  rematerialised at a time).  PyTorch compiles nothing, the parameters
  stay per-layer objects in both (the state dict does not change), and
  per-layer checkpointing already recomputes one layer at a time.  (JAX
  falls back to its per-layer loop for a model with experts; here it is
  the one loop anyway.)
* ``fuse_head_loss``: in training ``GPTForPretraining`` returns
  ``FusedHeadOutput(hidden, tied weight)`` and the criterion runs
  ``F.fused_linear_nll_loss`` (the ``[B, T, V]`` logits never exist).  The
  weight is whatever the embedding holds at that moment: the parameter
  itself eagerly (its head gradient reaches the tied table), the cast
  value inside the train step's ``functional_call``.

With a cache, inside the serving engine's
``serving.adapters.adapter_scope``, each row's LoRA delta (gathered from
the engine's adapter banks by the row's bank id) is added to the fused qkv
after the base projection, as in JAX's ``GPTSelfAttention``; the int8
base weights are the engine's own serving copy of the model
(``serving.adapters.weight_quant.quantize_model``).

GPT-MoE (``moe_num_experts > 0``): every ``moe_every_n_layers``-th layer's
MLP is a :class:`GPTMoEMLP`, a ``MoELayer``
(``incubate.distributed.models.moe``) over ``moe_num_experts`` expert MLPs
with the ``moe_gate`` gate ("gshard", "switch" or "naive"), train / eval
capacity factors ``(cf, 2 * cf)`` for the first two.  As in JAX, a MoE
layer takes no fused pre-LN route and runs outside recompute (its gate's
balance loss is read after the forward), and the gates' losses of the last
forward sum to ``GPTModel.moe_aux_loss()``, which
:class:`GPTMoEPretrainingCriterion` adds to the LM loss at
``moe_aux_loss_weight``.  ``fuse_qkv=False`` computes what ``True``
computes: the JAX model reads the flag nowhere either.  ``activation``
is any name of ``nn.functional.ACTIVATIONS`` (JAX's ``getattr(F,
activation)``).

Not ported: growing-concat and dense per-slot caches, and serving a MoE
model (ROADMAP module entry 4).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..incubate.distributed.models.moe import MoELayer
from ..kernels.ln_matmul import ln_matmul_enabled
from ..kernels.paged_attention import SPARE_PAGE, paged_decode_attention
from ..nn import LayerNorm
from ..nn import functional as F
from ..serving.adapters.lora import active as _lora_active
from ..serving.kv_quant import quantize_rows

__all__ = ["GPTConfig", "GPT_CONFIGS", "gpt_config", "GPTSelfAttention",
           "GPTMLP", "GPTMoEMLP", "GPTDecoderLayer", "GPTEmbeddings",
           "GPTModel", "FusedHeadOutput", "GPTForPretraining",
           "GPTPretrainingCriterion", "GPTMoEPretrainingCriterion",
           "build_gpt",
           "gpt_num_params", "gpt_train_flops_per_token",
           "QKV_LAYOUT_HEAD_MAJOR", "SPARE_PAGE"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 0  # 0 -> 4*hidden
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    layer_norm_epsilon: float = 1e-5
    use_recompute: bool = False
    scan_layers: bool = False       # the same per-layer loop (docstring)
    fuse_qkv: bool = True           # False computes the same (docstring)
    activation: str = "gelu"
    # MoE (GPT-MoE / GShard FFN replacement): 0 = dense FFN
    moe_num_experts: int = 0
    moe_top_k: int = 0  # 0 = the gate's own default (gshard 2, switch 1)
    moe_every_n_layers: int = 2  # every n-th block becomes MoE
    moe_capacity_factor: float = 1.2
    moe_aux_loss_weight: float = 0.01
    moe_gate: str = "gshard"
    fuse_head_loss: bool = False

    def __post_init__(self):
        if not self.intermediate_size:
            self.intermediate_size = 4 * self.hidden_size
        if self.activation not in F.ACTIVATIONS:
            raise ValueError(f"activation {self.activation!r} is not one of "
                             f"{sorted(F.ACTIVATIONS)}")


# FleetX / GPT-3 paper ladder (vocab padded to a 128 multiple)
GPT_CONFIGS = {
    "gpt-tiny": dict(vocab_size=1024, hidden_size=128, num_layers=2,
                     num_attention_heads=4, max_position_embeddings=256),
    "gpt2-small-en": dict(hidden_size=768, num_layers=12,
                          num_attention_heads=12),      # 125M
    "gpt2-medium-en": dict(hidden_size=1024, num_layers=24,
                           num_attention_heads=16),     # 345M
    "gpt2-large-en": dict(hidden_size=1536, num_layers=24,
                          num_attention_heads=16),      # 760M
    "gpt3-1.3B-en": dict(hidden_size=2048, num_layers=24,
                         num_attention_heads=16,
                         max_position_embeddings=2048),
    "gpt3-2.7B-en": dict(hidden_size=2560, num_layers=32,
                         num_attention_heads=32,
                         max_position_embeddings=2048),
    "gpt3-6.7B-en": dict(hidden_size=4096, num_layers=32,
                         num_attention_heads=32,
                         max_position_embeddings=2048),
    "gpt3-13B-en": dict(hidden_size=5120, num_layers=40,
                        num_attention_heads=40,
                        max_position_embeddings=2048),
}

# fused-qkv column layout versions: 1 = role-major [3, nh, hd],
# 2 = head-major [nh, 3, hd] (what the model computes with)
QKV_LAYOUT_HEAD_MAJOR = 2


def gpt_config(name: str, **overrides) -> GPTConfig:
    base = dict(GPT_CONFIGS[name])
    base.update(overrides)
    return GPTConfig(**base)


class GPTSelfAttention(nn.Module):
    """Causal self-attention: fused head-major qkv projection, the fused
    flash kernel without a cache, the flash kernel for static prefill, the
    paged kernel for paged-cache reads."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        h, nh = config.hidden_size, config.num_attention_heads
        if h % nh:
            raise ValueError(f"hidden {h} not divisible by heads {nh}")
        self.num_heads = nh
        self.head_dim = h // nh
        self.attn_dropout_prob = config.attention_dropout_prob
        self.qkv_proj = nn.Linear(h, 3 * h)
        self.out_proj = nn.Linear(h, h)
        self.register_buffer(
            "qkv_layout", torch.tensor(QKV_LAYOUT_HEAD_MAJOR,
                                       dtype=torch.int32))

    def forward(self, x, cache=None, pre_norm=None):
        b, t = x.shape[0], x.shape[1]
        if pre_norm is not None:
            # the pre-LN fused into the qkv projection (kernels/ln_matmul.py)
            ln = pre_norm._parameters
            qkv = F.fused_ln_linear(
                x, ln["weight"], ln["bias"], self.qkv_proj.weight.t(),
                self.qkv_proj.bias, eps=pre_norm._epsilon)
        else:
            qkv = self.qkv_proj(x)
        scope = _lora_active() if cache is not None else None
        if scope is not None:
            # the serving engine's batched adapters: each row's low-rank
            # delta, added after the base projection (bank row 0 adds
            # exactly zero, so base rows keep the adapter-free qkv)
            qkv = qkv + scope.delta_qkv(x)
        qkv = qkv.view(b, t, self.num_heads, 3, self.head_dim)
        if cache is None:
            return self.out_proj(F.fused_qkv_attention(
                qkv, dropout_p=self.attn_dropout_prob, is_causal=True,
                training=self.training))
        q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
        if len(cache) == 3:
            k_buf, v_buf, pos0 = cache
            if not (isinstance(pos0, int) and pos0 == 0):
                raise NotImplementedError(
                    "the dense per-slot cache (a 3-tuple with a tensor "
                    "length) is ROADMAP module entry 4; the port "
                    "takes the static prefill form (k_buf, v_buf, 0)")
            # static prefill: no past to attend over, so the prompt keeps
            # the causal flash path; the buffers take the new keys/values
            k_buf[:, :t] = k.to(k_buf.dtype)
            v_buf[:, :t] = v.to(v_buf.dtype)
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            new_cache = (k_buf, v_buf, t)
        elif len(cache) - (cache[-1] is SPARE_PAGE) in (4, 6):
            out, new_cache = self._paged(q, k, v, cache)
        else:
            raise NotImplementedError(
                f"a {len(cache)}-tuple cache: the port takes the static "
                f"prefill 3-tuple and the paged 4/6-tuples, each paged one "
                f"with or without SPARE_PAGE (ROADMAP module entry 4)")
        out = self.out_proj(out.reshape(b, t, self.num_heads * self.head_dim))
        return out, new_cache

    @staticmethod
    def _paged(q, k, v, cache):
        """Write the span's keys/values through the page table, then read
        the row's pages with the paged decode kernel.

        With :data:`SPARE_PAGE` at the end of the cache tuple the pools
        hold one page past those a table may map: every span position is
        written by one fixed-shape ``index_put_`` (no host sync, so the
        step can be captured in a CUDA graph), and sentinel, off-table and
        parked positions land on the spare page, which no table maps and
        the read never sees (it reads the pools without it).  Without the
        marker every page is mappable, and those positions are dropped by
        a boolean filter, which syncs the host."""
        spare = cache[-1] is SPARE_PAGE
        if spare:
            cache = cache[:-1]
        k_pages, v_pages, start, pt = cache[:4]
        quant = len(cache) == 6
        if not torch.is_tensor(start) or start.dim() != 1:
            raise ValueError("the paged cache takes per-slot [B] lengths")
        t = q.shape[1]
        n_pages = k_pages.shape[0] - int(spare)     # pages a table maps
        psz = k_pages.shape[1]
        n_pt = pt.shape[1]
        cols = start.long()[:, None] + torch.arange(t, device=q.device)[None]
        pslot = (cols // psz).clamp(0, n_pt - 1)
        pid = torch.where(cols < n_pt * psz, pt.long().gather(1, pslot),
                          torch.full_like(cols, n_pages))
        off = cols % psz
        if spare:
            # sentinel (>= num_pages) and off-the-end positions go to the
            # spare page: never clamped onto a real page
            idx = (pid.clamp(max=n_pages).flatten(), off.flatten())

            def sel(x):
                return x.flatten(0, 1)
        else:
            # ... or are dropped
            keep = pid < n_pages
            idx = (pid[keep], off[keep])

            def sel(x):
                return x[keep]
        # the pools are updated in place, as the JAX engine's donated
        # buffers are: no pool-sized copy per layer per step
        if quant:
            k_scale, v_scale = cache[4], cache[5]
            kq, ksc = quantize_rows(k)
            vq, vsc = quantize_rows(v)
            k_pages.index_put_(idx, sel(kq))
            v_pages.index_put_(idx, sel(vq))
            k_scale.index_put_(idx, sel(ksc))
            v_scale.index_put_(idx, sel(vsc))
        else:
            k_scale = v_scale = None
            k_pages.index_put_(idx, sel(k).to(k_pages.dtype))
            v_pages.index_put_(idx, sel(v).to(v_pages.dtype))
        read = [k_pages, v_pages, k_scale, v_scale]
        if spare:
            read = [None if x is None else x[:n_pages] for x in read]
        out = paged_decode_attention(q, read[0], read[1], pt, start,
                                     k_scale=read[2], v_scale=read[3])
        new_cache = (k_pages, v_pages, start + t, pt)
        if quant:
            new_cache = new_cache + (k_scale, v_scale)
        if spare:
            new_cache = new_cache + (SPARE_PAGE,)
        return out, new_cache


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.fc0 = nn.Linear(config.hidden_size, config.intermediate_size)
        self.fc1 = nn.Linear(config.intermediate_size, config.hidden_size)
        self.act = getattr(F, config.activation)

    def forward(self, x, pre_norm=None):
        if pre_norm is not None:
            ln = pre_norm._parameters
            h = F.fused_ln_linear(x, ln["weight"], ln["bias"],
                                  self.fc0.weight.t(), self.fc0.bias,
                                  eps=pre_norm._epsilon)
        else:
            h = self.fc0(x)
        return self.fc1(self.act(h))


class GPTMoEMLP(nn.Module):
    """The GShard-style FFN: a ``MoELayer`` over ``moe_num_experts``
    :class:`GPTMLP` experts.  The gate's balance loss of the last forward
    is ``last_aux_loss`` (None for the naive gate)."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        cf = config.moe_capacity_factor
        gate = {"type": config.moe_gate}
        fixed_k = {"gshard": 2, "switch": 1}.get(config.moe_gate)
        if fixed_k is None:
            gate["top_k"] = config.moe_top_k or 2
        elif config.moe_top_k not in (0, fixed_k):
            raise ValueError(
                f"moe_gate={config.moe_gate!r} requires moe_top_k={fixed_k} "
                f"(got {config.moe_top_k}); use moe_gate='naive' for other k")
        if config.moe_gate in ("gshard", "switch"):
            gate["capacity"] = (cf, 2 * cf)  # train/eval caps the gate uses
        self.moe = MoELayer(
            config.hidden_size,
            [GPTMLP(config) for _ in range(config.moe_num_experts)],
            gate=gate, capacity_factor=cf)
        self.last_aux_loss = None

    def forward(self, x):
        out = self.moe(x)
        self.last_aux_loss = self.moe.gate.get_loss()
        return out


class GPTDecoderLayer(nn.Module):
    """Pre-LN transformer block; its MLP is a :class:`GPTMoEMLP` with
    ``use_moe``."""

    def __init__(self, config: GPTConfig, use_moe: bool = False):
        super().__init__()
        eps = config.layer_norm_epsilon
        self.norm1 = LayerNorm(config.hidden_size, epsilon=eps)
        self.self_attn = GPTSelfAttention(config)
        self.norm2 = LayerNorm(config.hidden_size, epsilon=eps)
        self.mlp = GPTMoEMLP(config) if use_moe else GPTMLP(config)
        self.dropout1 = nn.Dropout(config.hidden_dropout_prob)
        self.dropout2 = nn.Dropout(config.hidden_dropout_prob)

    def _fuse_ln_proj(self):
        """Route the pre-LNs into their projections (one ``ln_matmul``
        each) when the opt-in kernel is on and the MLP is dense.  JAX's
        other conditions (no model parallelism, no mesh) always hold in
        the port; the caller checks that there is no cache."""
        return ln_matmul_enabled() and not isinstance(self.mlp, GPTMoEMLP)

    def forward(self, x, cache=None):
        if cache is None and self._fuse_ln_proj():
            x = x + self.dropout1(self.self_attn(x, pre_norm=self.norm1))
            return x + self.dropout2(self.mlp(x, pre_norm=self.norm2))
        y = self.self_attn(self.norm1(x), cache=cache)
        if cache is not None:
            y, new_cache = y
        x = x + self.dropout1(y)
        x = x + self.dropout2(self.mlp(self.norm2(x)))
        return x if cache is None else (x, new_cache)


class GPTEmbeddings(nn.Module):
    """Word + learned position embeddings."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(config.vocab_size,
                                            config.hidden_size)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, config.hidden_size)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, position_ids):
        return self.dropout(self.word_embeddings(input_ids) +
                            self.position_embeddings(position_ids))


class GPTModel(nn.Module):
    """The transformer stack.  Output: hidden states ``[B, T, H]`` (and
    the new caches when ``caches`` is given)."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        self.config = config
        self.embeddings = GPTEmbeddings(config)
        self.layers = nn.ModuleList(
            [GPTDecoderLayer(
                config,
                use_moe=(config.moe_num_experts > 0 and
                         (i + 1) % max(config.moe_every_n_layers, 1) == 0))
             for i in range(config.num_layers)])
        self.final_norm = LayerNorm(config.hidden_size,
                                    epsilon=config.layer_norm_epsilon)

    def _positions(self, input_ids, caches):
        t = input_ids.shape[1]
        ar = torch.arange(t, device=input_ids.device)
        if caches is None:
            pos = ar[None]
        else:
            past = caches[0][2]
            if torch.is_tensor(past) and past.dim() == 1:
                pos = past.long()[:, None] + ar[None]  # per-slot lengths
            else:
                pos = (ar + int(past))[None]
        # parked rows sit at n_pt*P, so past + j can run off the table;
        # the JAX gather clamps such ids, a CUDA embedding would fault
        return pos.clamp(max=self.config.max_position_embeddings - 1)

    def forward(self, input_ids, position_ids=None, caches=None):
        if position_ids is None:
            position_ids = self._positions(input_ids, caches)
        else:
            position_ids = position_ids.clamp(
                max=self.config.max_position_embeddings - 1)
        x = self.embeddings(input_ids, position_ids)
        new_caches = [] if caches is not None else None
        recompute = self.config.use_recompute and self.training
        scope = _lora_active() if caches is not None else None
        for i, layer in enumerate(self.layers):
            if caches is not None:
                if scope is not None:
                    scope.layer = i        # each layer gathers its bank slice
                x, c = layer(x, cache=caches[i])
                new_caches.append(c)
            elif recompute and not isinstance(layer.mlp, GPTMoEMLP):
                # (a MoE layer runs outside recompute, as in JAX: its
                # gate's loss is read after the forward)
                # the values the layer holds now (the train step's cast
                # ones inside its functional_call) ride as inputs, so the
                # replay in backward() computes with them
                names, values = zip(*layer.named_parameters())
                x = checkpoint(_call_layer, layer, names, x, *values,
                               use_reentrant=False)
            else:
                x = layer(x)
        x = self.final_norm(x)
        return x if caches is None else (x, new_caches)

    def moe_aux_loss(self):
        """The sum of the gates' balance losses of the last forward (None
        for a model without a gate that records one)."""
        total = None
        for layer in self.layers:
            aux = getattr(layer.mlp, "last_aux_loss", None)
            if aux is not None:
                total = aux if total is None else total + aux
        return total


def _call_layer(layer, names, x, *values):
    return torch.func.functional_call(layer, dict(zip(names, values)), (x,))


class FusedHeadOutput(tuple):
    """``(hidden, head_weight)``: what ``GPTForPretraining`` returns in
    training with ``config.fuse_head_loss``, for the criterion's
    ``F.fused_linear_nll_loss``."""

    def __new__(cls, hidden, weight):
        return super().__new__(cls, (hidden, weight))


class GPTForPretraining(nn.Module):
    """GPT with the LM head tied to the word embedding."""

    def __init__(self, gpt: GPTModel):
        super().__init__()
        self.gpt = gpt

    @property
    def config(self) -> GPTConfig:
        return self.gpt.config

    def forward(self, input_ids, position_ids=None, caches=None):
        if caches is not None:
            x, new_caches = self.gpt(input_ids, position_ids, caches=caches)
            return self.lm_head(x), new_caches
        x = self.gpt(input_ids, position_ids)
        if self.config.fuse_head_loss and self.training:
            # the embedding's current value: the parameter eagerly, the
            # cast value inside the train step's functional_call
            return FusedHeadOutput(
                x, self.gpt.embeddings.word_embeddings.weight)
        return self.lm_head(x)

    def lm_head(self, hidden_states):
        return torch.matmul(hidden_states,
                            self.gpt.embeddings.word_embeddings.weight.t())


class GPTPretrainingCriterion(nn.Module):
    """Masked next-token cross entropy (FleetX pretraining loss): the mean
    of :func:`F.fused_nll_loss` over the positions, or its
    ``loss_mask``-weighted mean.  Single device: a ``topo`` with model
    parallelism raises (the vocab-parallel loss is ROADMAP module item
    11)."""

    def __init__(self, topo=None, ignore_index=-100):
        super().__init__()
        if getattr(topo, "mp_degree", 1) > 1:
            raise NotImplementedError(
                "model-parallel GPTPretrainingCriterion (ParallelCrossEntropy)"
                " is ROADMAP module item 11")
        self.ignore_index = ignore_index

    def forward(self, prediction_scores, masked_lm_labels, loss_mask=None):
        if isinstance(prediction_scores, FusedHeadOutput):
            hidden, w = prediction_scores
            loss = F.fused_linear_nll_loss(hidden, w, masked_lm_labels,
                                           ignore_index=self.ignore_index)
        else:
            loss = F.fused_nll_loss(prediction_scores, masked_lm_labels,
                                    ignore_index=self.ignore_index)
        loss = loss.reshape(-1).float()
        if loss_mask is not None:
            m = loss_mask.reshape(-1).float()
            return (loss * m).sum() / m.sum().clamp(min=1.0)
        return loss.mean()


class GPTMoEPretrainingCriterion(nn.Module):
    """The LM loss plus ``aux_loss_weight`` (default: the config's
    ``moe_aux_loss_weight``) times ``model``'s :meth:`GPTModel.moe_aux_loss`
    of the same forward.  It holds the model without registering it, so it
    owns none of the model's parameters."""

    def __init__(self, model, aux_loss_weight=None, ignore_index=-100):
        super().__init__()
        gpt = getattr(model, "gpt", model)
        object.__setattr__(self, "_gpt", gpt)
        w = aux_loss_weight
        if w is None:
            cfg = getattr(gpt, "config", None)
            w = cfg.moe_aux_loss_weight if cfg is not None else 0.01
        self.aux_weight = w
        self.lm = GPTPretrainingCriterion(ignore_index=ignore_index)

    def forward(self, prediction_scores, masked_lm_labels, loss_mask=None):
        loss = self.lm(prediction_scores, masked_lm_labels, loss_mask)
        aux = self._gpt.moe_aux_loss()
        if aux is not None:
            loss = loss + self.aux_weight * aux
        return loss


def gpt_num_params(cfg: GPTConfig) -> int:
    h, L, V, T = (cfg.hidden_size, cfg.num_layers, cfg.vocab_size,
                  cfg.max_position_embeddings)
    per_layer = 4 * h * h + 4 * h + 2 * h * cfg.intermediate_size \
        + cfg.intermediate_size + h + 4 * h  # attn + mlp + 2 LN
    return V * h + T * h + L * per_layer + 2 * h


def gpt_train_flops_per_token(cfg: GPTConfig, seq_len: int) -> float:
    """6*N + 12*L*h*s — the standard train-MFU accounting (fwd+bwd = 3x
    fwd; fwd matmuls = 2*N per token; the 12*L*h*s attention term already
    carries the 3x and the QK^T+AV pair)."""
    return (6.0 * gpt_num_params(cfg) +
            12.0 * cfg.num_layers * cfg.hidden_size * seq_len)


def _init_weights(model: nn.Module, config: GPTConfig, seed: int):
    """Normal(0, initializer_range) weights (residual-path projections
    scaled by 1/sqrt(2L)), zero biases, unit LayerNorms — the JAX
    model's init recipe, drawn in place from a ``torch.Generator`` on the
    model's device (the values differ from JAX's; parity runs load the JAX
    weights instead)."""
    dev = next(nn.Module.parameters(model)).device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    std = config.initializer_range
    out_std = std / math.sqrt(2.0 * config.num_layers)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".norm" in name or "final_norm" in name:
                p.fill_(1.0)
            else:
                s = out_std if ("out_proj" in name or "fc1" in name) else std
                p.normal_(0.0, s, generator=gen)


def build_gpt(name_or_config="gpt-tiny", for_pretraining=True, device=None,
              seed: int = 0, dtype=None, **overrides):
    """Build a GPT on ``device`` (default ``"cuda"``; raises without a
    card) in eval mode, with weights from ``seed`` drawn there, its
    floating parameters in ``dtype`` (default f32; the JAX recipe's
    ``set_default_dtype("bfloat16")`` is ``dtype=torch.bfloat16``)."""
    dev = resolve_device(device)
    if isinstance(name_or_config, GPTConfig):
        if "hidden_size" in overrides and "intermediate_size" not in overrides:
            overrides["intermediate_size"] = 0
        cfg = (dataclasses.replace(name_or_config, **overrides)
               if overrides else name_or_config)
    else:
        cfg = gpt_config(name_or_config, **overrides)
    with dev:
        model = GPTModel(cfg)
        if for_pretraining:
            model = GPTForPretraining(model)
    if dtype is not None:
        model.to(dtype)
    _init_weights(model, cfg, seed)
    return model.eval()

"""The fused transformer layers (``paddle_tpu.incubate.nn.layer.
fused_transformer`` counterparts): ``FusedBiasDropoutResidualLayerNorm``,
``FusedMultiHeadAttention``, ``FusedFeedForward``,
``FusedTransformerEncoderLayer``, ``FusedMoELayer`` and
``FusedMultiTransformer``.

They are the JAX layers' op sequences over the port's ``nn`` Layers,
with the JAX layers' sublayers, parameters and state-dict names, so a
JAX state dict loads with ``set_state_dict``.  ``FusedMultiHeadAttention``
projects q, k and v in one ``Linear`` (columns role-major: ``[3, nh,
hd]``) and attends through ``F.scaled_dot_product_attention`` on the
role views: with no mask and no attention dropout in training that
launches the flash forward and backward (rows 1-4) on the card.  It is
self-attention only: ``key``, ``value`` or a ``cache`` raise, as in the
JAX layer.  ``FusedMoELayer`` is LayerNorm, then the port's
``MoELayer`` over ``Linear -> GELU -> Linear`` experts, plus the
residual; ``top_k`` 2 takes the GShard gate, 1 the Switch gate, any other
the naive top-k gate, and weight injection or ``mp_group`` raise.
``FusedMultiTransformer`` stacks ``num_layers`` (default 1) encoder
layers.
"""
from __future__ import annotations

from ....nn import functional as F
from ....nn.layer.activation import GELU
from ....nn.layer.common import Dropout, Linear
from ....nn.layer.container import LayerList, Sequential
from ....nn.layer.norm import LayerNorm
from ....nn.layer_base import Layer, param

__all__ = ["FusedBiasDropoutResidualLayerNorm", "FusedMultiHeadAttention",
           "FusedFeedForward", "FusedTransformerEncoderLayer",
           "FusedMoELayer", "FusedMultiTransformer"]


class FusedBiasDropoutResidualLayerNorm(Layer):
    """``layer_norm(residual + dropout(x + bias))``."""

    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-5, name=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.linear_bias = self.create_parameter(
            shape=[embed_dim], attr=bias_attr, dtype=self._dtype,
            is_bias=True)
        self.dropout = Dropout(dropout_rate)
        self.norm = LayerNorm(embed_dim, epsilon=epsilon,
                              weight_attr=weight_attr)

    def forward(self, x, residual):
        return self.norm(residual + self.dropout(
            x + param(self, "linear_bias")))


class FusedMultiHeadAttention(Layer):
    """Pre- or post-LN multi-head self-attention with the residual."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None,
                 epsilon=1e-5, nranks=1, ring_id=-1, name=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.qkv_proj = Linear(embed_dim, 3 * embed_dim,
                               weight_attr=qkv_weight_attr,
                               bias_attr=qkv_bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim,
                               weight_attr=linear_weight_attr,
                               bias_attr=linear_bias_attr)
        self.pre_ln = LayerNorm(embed_dim, epsilon=epsilon,
                                weight_attr=pre_ln_scale_attr,
                                bias_attr=pre_ln_bias_attr)
        self.ln = LayerNorm(embed_dim, epsilon=epsilon,
                            weight_attr=ln_scale_attr, bias_attr=ln_bias_attr)
        self.attn_dropout_rate = attn_dropout_rate
        self.dropout = Dropout(dropout_rate)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        if key is not None or value is not None:
            raise NotImplementedError(
                "FusedMultiHeadAttention is self-attention only (fused qkv "
                "GEMM); pass query alone, or use nn.MultiHeadAttention for "
                "cross-attention")
        if cache is not None:
            raise NotImplementedError(
                "incremental decode cache is not supported by "
                "FusedMultiHeadAttention yet; use nn.MultiHeadAttention")
        residual = query
        x = self.pre_ln(query) if self.normalize_before else query
        b, t = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x).view(b, t, 3, self.num_heads, self.head_dim)
        out = F.scaled_dot_product_attention(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], attn_mask=attn_mask,
            dropout_p=self.attn_dropout_rate, training=self.training)
        out = self.out_proj(out.reshape(b, t, self.embed_dim))
        out = residual + self.dropout(out)
        if not self.normalize_before:
            out = self.ln(out)
        return out


class FusedFeedForward(Layer):
    """``linear -> activation -> dropout -> linear``, then dropout, the
    residual and the LayerNorm (before with ``normalize_before``)."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None, ln2_bias_attr=None,
                 nranks=1, ring_id=-1, name=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.linear1 = Linear(d_model, dim_feedforward,
                              weight_attr=linear1_weight_attr,
                              bias_attr=linear1_bias_attr)
        self.linear2 = Linear(dim_feedforward, d_model,
                              weight_attr=linear2_weight_attr,
                              bias_attr=linear2_bias_attr)
        self.pre_ln = LayerNorm(d_model, epsilon=epsilon,
                                weight_attr=ln1_scale_attr,
                                bias_attr=ln1_bias_attr)
        self.ln = LayerNorm(d_model, epsilon=epsilon,
                            weight_attr=ln2_scale_attr,
                            bias_attr=ln2_bias_attr)
        self.activation = activation
        self.act_dropout = Dropout(dropout_rate if act_dropout_rate is None
                                   else act_dropout_rate)
        self.dropout = Dropout(dropout_rate)

    def forward(self, src):
        residual = src
        x = self.pre_ln(src) if self.normalize_before else src
        x = self.act_dropout(getattr(F, self.activation)(self.linear1(x)))
        out = residual + self.dropout(self.linear2(x))
        if not self.normalize_before:
            out = self.ln(out)
        return out


class FusedTransformerEncoderLayer(Layer):
    """``FusedMultiHeadAttention`` then ``FusedFeedForward``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=(dropout_rate if attn_dropout_rate is None
                               else attn_dropout_rate),
            normalize_before=normalize_before)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before)

    def forward(self, src, src_mask=None, cache=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask,
                                        cache=cache))


class FusedMoELayer(Layer):
    """``x + MoE(LayerNorm(x))`` with ``num_expert`` experts of width
    ``dim_feedforward``."""

    def __init__(self, d_model, dim_feedforward, num_expert, top_k=2,
                 approximate=True, moe_group=None, mp_group=None,
                 ln_scale=None, ln_bias=None, gate_weight=None,
                 gate_bias=None, linear1_weights=None, linear1_biases=None,
                 linear2_weights=None, linear2_biases=None):
        super().__init__()
        from ...distributed.models.moe import MoELayer

        injected = [ln_scale, ln_bias, gate_weight, gate_bias,
                    linear1_weights, linear1_biases, linear2_weights,
                    linear2_biases]
        if any(v is not None for v in injected) or mp_group is not None:
            raise NotImplementedError(
                "FusedMoELayer weight injection / mp_group are not "
                "supported; build the layer then set_state_dict the "
                "converted weights")

        def expert():
            return Sequential(Linear(d_model, dim_feedforward),
                              GELU(approximate=approximate),
                              Linear(dim_feedforward, d_model))

        self.norm = LayerNorm(d_model)
        if top_k == 2:
            gate = {"type": "gshard"}
        elif top_k == 1:
            gate = {"type": "switch"}
        else:
            gate = {"type": "naive", "top_k": top_k}
        self.moe = MoELayer(d_model, [expert() for _ in range(num_expert)],
                            gate=gate, moe_group=moe_group)

    def forward(self, x):
        return x + self.moe(self.norm(x))


class FusedMultiTransformer(Layer):
    """``num_layers`` (default 1) ``FusedTransformerEncoderLayer`` s."""

    def __init__(self, embed_dim, num_heads, dim_feedforward, dropout_rate=0.0,
                 activation="gelu", normalize_before=True, ln_scale_attrs=None,
                 ln_bias_attrs=None, num_layers=-1, nranks=1, ring_id=-1,
                 name=None, **kwargs):
        super().__init__()
        if num_layers < 0:
            num_layers = 1
        self.layers = LayerList([
            FusedTransformerEncoderLayer(
                embed_dim, num_heads, dim_feedforward,
                dropout_rate=dropout_rate, activation=activation,
                normalize_before=normalize_before)
            for _ in range(num_layers)])

    def forward(self, src, attn_mask=None, caches=None, **kwargs):
        x = src
        for layer in self.layers:
            x = layer(x, src_mask=attn_mask)
        return x

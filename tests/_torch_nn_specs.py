"""The spec table of the ``nn`` Layer classes, and one run of a spec.

Each spec builds one Layer from a package (``paddle_tpu`` or
``paddle_tpu_torch``: the same call on either), its inputs (numpy arrays
seeded by the spec's name; the float inputs marked differentiable are
leaves that require grad) and the call's keyword arguments.  The table
covers every Layer class of the ported ``nn/layer/{common,activation,
norm,loss,transformer,conv,pooling}.py``; the containers are run through
``Sequential``.  ``CARD_SPECS`` replaces the attention specs on the card
(head size 16, the flash kernels' smallest; a CUDA tensor launches the
kernel or raises).  :func:`build`, :func:`batch` and :func:`train` are
the slice's training script.  This file imports no JAX, so the card
tests can use it.

:func:`run` calls a built layer on a package's surface Tensors and
returns its outputs, the gradients of a fixed random projection of the
float outputs with respect to the differentiable inputs and to every
parameter (by state-dict name), and its state after the call (batch
norm's running statistics) as numpy.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Callable

import numpy as np


@dataclass
class Spec:
    make: Callable          # package -> layer
    inputs: Callable        # RandomState -> [(array, differentiable)]
    kwargs: dict = field(default_factory=dict)
    train: bool = False     # call in training mode (else eval)


def _f(*shape, scale=1.0):
    return lambda rs: (rs.standard_normal(shape) * scale).astype(np.float32)


def _x(*shape):
    """One differentiable float input."""
    return lambda rs: [(_f(*shape)(rs), True)]


def _label(rs, shape, n, ignore=None):
    lab = rs.randint(0, n, shape).astype(np.int64)
    if ignore is not None:
        lab.reshape(-1)[0] = ignore
    return lab


def _soft(rs, shape):
    p = rs.rand(*shape).astype(np.float32) + 0.1
    return p / p.sum(-1, keepdims=True)


def _pm1(rs, shape):
    return np.where(rs.rand(*shape) > 0.5, 1.0, -1.0).astype(np.float32)


def _act(name, *args, shape=(3, 8), **kw):
    return Spec(lambda P: getattr(P.nn, name)(*args, **kw), _x(*shape))


SPECS: dict[str, Spec] = {
    # -- common ------------------------------------------------------------
    "Linear": Spec(lambda P: P.nn.Linear(6, 5), _x(3, 6)),
    "Linear-no-bias": Spec(lambda P: P.nn.Linear(6, 5, bias_attr=False),
                           _x(2, 4, 6)),
    "Identity": Spec(lambda P: P.nn.Identity(), _x(3, 4)),
    "Dropout-eval": Spec(lambda P: P.nn.Dropout(0.5), _x(3, 4)),
    "Dropout-downscale-eval": Spec(lambda P: P.nn.Dropout(
        0.3, mode="downscale_in_infer"), _x(3, 4)),
    "Dropout2D-eval": Spec(lambda P: P.nn.Dropout2D(0.5), _x(2, 3, 4, 4)),
    "Dropout3D-eval": Spec(lambda P: P.nn.Dropout3D(0.5),
                           _x(2, 3, 2, 2, 2)),
    "AlphaDropout-eval": Spec(lambda P: P.nn.AlphaDropout(0.5), _x(3, 4)),
    "Embedding": Spec(lambda P: P.nn.Embedding(10, 4, padding_idx=0),
                      lambda rs: [(_label(rs, (2, 5), 10, ignore=0), False)]),
    "Flatten": Spec(lambda P: P.nn.Flatten(), _x(2, 3, 4, 5)),
    "Flatten-1-2": Spec(lambda P: P.nn.Flatten(1, 2), _x(2, 3, 4, 5)),
    "Unflatten": Spec(lambda P: P.nn.Unflatten(1, [2, 3]), _x(4, 6, 5)),
    "Upsample-nearest": Spec(lambda P: P.nn.Upsample(scale_factor=2),
                             _x(1, 2, 3, 4)),
    "Upsample-bilinear": Spec(lambda P: P.nn.Upsample(
        size=[5, 7], mode="bilinear"), _x(1, 2, 3, 4)),
    "UpsamplingBilinear2D": Spec(lambda P: P.nn.UpsamplingBilinear2D(
        scale_factor=2), _x(1, 2, 3, 3)),
    "UpsamplingNearest2D": Spec(lambda P: P.nn.UpsamplingNearest2D(
        size=[6, 8]), _x(1, 2, 3, 4)),
    "PixelShuffle": Spec(lambda P: P.nn.PixelShuffle(2), _x(1, 8, 3, 3)),
    "PixelShuffle-NHWC": Spec(lambda P: P.nn.PixelShuffle(2, "NHWC"),
                              _x(1, 3, 3, 8)),
    "PixelUnshuffle": Spec(lambda P: P.nn.PixelUnshuffle(2),
                           _x(1, 2, 4, 6)),
    "ChannelShuffle": Spec(lambda P: P.nn.ChannelShuffle(2),
                           _x(1, 4, 3, 3)),
    "CosineSimilarity": Spec(lambda P: P.nn.CosineSimilarity(axis=1),
                             lambda rs: [(_f(3, 6)(rs), True),
                                         (_f(3, 6)(rs), True)]),
    "Bilinear": Spec(lambda P: P.nn.Bilinear(4, 3, 5),
                     lambda rs: [(_f(2, 4)(rs), True),
                                 (_f(2, 3)(rs), True)]),
    "Pad1D-reflect": Spec(lambda P: P.nn.Pad1D([1, 2], mode="reflect"),
                          _x(2, 3, 6)),
    "Pad2D-constant": Spec(lambda P: P.nn.Pad2D([1, 0, 2, 1], value=0.5),
                           _x(1, 2, 3, 4)),
    "Pad3D-replicate": Spec(lambda P: P.nn.Pad3D(
        [1, 0, 2, 1, 0, 1], mode="replicate"), _x(1, 2, 3, 3, 3)),
    "Pad3D-int": Spec(lambda P: P.nn.Pad3D(1, mode="replicate"),
                      _x(1, 2, 3, 3, 3)),
    "ZeroPad2D": Spec(lambda P: P.nn.ZeroPad2D([1, 1, 0, 2]),
                      _x(1, 2, 3, 4)),
    "Sequential": Spec(lambda P: P.nn.Sequential(
        P.nn.Linear(4, 8), P.nn.ReLU(), P.nn.Linear(8, 3)), _x(5, 4)),
    # -- activation ----------------------------------------------------------
    "ReLU": _act("ReLU"), "ReLU6": _act("ReLU6"), "ELU": _act("ELU", 0.5),
    "SELU": _act("SELU"), "CELU": _act("CELU", 1.5), "GELU": _act("GELU"),
    "GELU-tanh": _act("GELU", True), "Sigmoid": _act("Sigmoid"),
    "LogSigmoid": _act("LogSigmoid"), "Hardsigmoid": _act("Hardsigmoid"),
    "Hardswish": _act("Hardswish"), "Hardtanh": _act("Hardtanh", -0.5, 0.5),
    "Hardshrink": _act("Hardshrink", 0.3),
    "Softshrink": _act("Softshrink", 0.3), "Tanhshrink": _act("Tanhshrink"),
    "LeakyReLU": _act("LeakyReLU", 0.2), "Softplus": _act("Softplus", 2.0),
    "Softsign": _act("Softsign"), "Silu": _act("Silu"), "Swish": _act("Swish"),
    "Mish": _act("Mish"), "Tanh": _act("Tanh"), "Softmax": _act("Softmax", 0),
    "LogSoftmax": _act("LogSoftmax"),
    "Maxout": _act("Maxout", 2, shape=(2, 8, 3)),
    "GLU": _act("GLU"), "RReLU": _act("RReLU"),
    "PReLU": Spec(lambda P: P.nn.PReLU(4, 0.1), _x(2, 4, 3)),
    "PReLU-shared": Spec(lambda P: P.nn.PReLU(), _x(2, 4, 3)),
    # -- norm ----------------------------------------------------------------
    "LayerNorm": Spec(lambda P: P.nn.LayerNorm(8), _x(2, 5, 8)),
    "LayerNorm-2d": Spec(lambda P: P.nn.LayerNorm([4, 8], epsilon=1e-3),
                         _x(2, 4, 8)),
    "BatchNorm1D-train": Spec(lambda P: P.nn.BatchNorm1D(4), _x(6, 4),
                              train=True),
    "BatchNorm2D-train": Spec(lambda P: P.nn.BatchNorm2D(3),
                              _x(4, 3, 5, 5), train=True),
    "BatchNorm2D-eval": Spec(lambda P: P.nn.BatchNorm2D(3, momentum=0.8),
                             _x(4, 3, 5, 5)),
    "BatchNorm3D-train": Spec(lambda P: P.nn.BatchNorm3D(2),
                              _x(2, 2, 3, 3, 3), train=True),
    "BatchNorm-train": Spec(lambda P: P.nn.BatchNorm(3), _x(4, 3, 5),
                            train=True),
    "SyncBatchNorm-train": Spec(lambda P: P.nn.SyncBatchNorm(3),
                                _x(4, 3, 2, 2), train=True),
    "GroupNorm": Spec(lambda P: P.nn.GroupNorm(2, 4), _x(2, 4, 3, 3)),
    "InstanceNorm1D": Spec(lambda P: P.nn.InstanceNorm1D(3), _x(2, 3, 7)),
    "InstanceNorm2D": Spec(lambda P: P.nn.InstanceNorm2D(3),
                           _x(2, 3, 4, 4)),
    "InstanceNorm3D": Spec(lambda P: P.nn.InstanceNorm3D(2),
                           _x(1, 2, 3, 3, 3)),
    "LocalResponseNorm": Spec(lambda P: P.nn.LocalResponseNorm(3),
                              _x(2, 6, 4, 4)),
    "SpectralNorm": Spec(lambda P: P.nn.SpectralNorm([6, 4], power_iters=2),
                         _x(6, 4)),
    # -- loss ----------------------------------------------------------------
    "CrossEntropyLoss": Spec(lambda P: P.nn.CrossEntropyLoss(),
                             lambda rs: [(_f(4, 7)(rs), True),
                                         (_label(rs, (4,), 7, -100), False)]),
    "CrossEntropyLoss-soft": Spec(
        lambda P: P.nn.CrossEntropyLoss(soft_label=True),
        lambda rs: [(_f(4, 7)(rs), True), (_soft(rs, (4, 7)), False)]),
    "CrossEntropyLoss-smooth-axis": Spec(
        lambda P: P.nn.CrossEntropyLoss(label_smoothing=0.1, axis=1),
        lambda rs: [(_f(2, 5, 3)(rs), True),
                    (_label(rs, (2, 3), 5), False)]),
    "CrossEntropyLoss-weight-sum": Spec(
        lambda P: P.nn.CrossEntropyLoss(
            weight=P.to_tensor(np.linspace(0.5, 1.5, 7).astype(np.float32)),
            reduction="sum"),
        lambda rs: [(_f(4, 7)(rs), True), (_label(rs, (4,), 7), False)]),
    "CrossEntropyLoss-weight-mean": Spec(
        lambda P: P.nn.CrossEntropyLoss(
            weight=P.to_tensor(np.linspace(0.5, 1.5, 7).astype(np.float32))),
        lambda rs: [(_f(4, 7)(rs), True),
                    (_label(rs, (4,), 7, -100), False)]),
    "CrossEntropyLoss-probs": Spec(
        lambda P: P.nn.CrossEntropyLoss(use_softmax=False,
                                        reduction="none"),
        lambda rs: [(_soft(rs, (4, 7)), True), (_label(rs, (4,), 7), False)]),
    "MSELoss": Spec(lambda P: P.nn.MSELoss(),
                    lambda rs: [(_f(3, 4)(rs), True), (_f(3, 4)(rs), False)]),
    "L1Loss-sum": Spec(lambda P: P.nn.L1Loss("sum"),
                       lambda rs: [(_f(3, 4)(rs), True),
                                   (_f(3, 4)(rs), False)]),
    "NLLLoss": Spec(lambda P: P.nn.NLLLoss(),
                    lambda rs: [(_f(4, 5)(rs), True),
                                (_label(rs, (4,), 5, -100), False)]),
    "NLLLoss-weight": Spec(
        lambda P: P.nn.NLLLoss(weight=P.to_tensor(
            np.linspace(0.5, 2.0, 5).astype(np.float32))),
        lambda rs: [(_f(4, 5)(rs), True), (_label(rs, (4,), 5), False)]),
    "BCELoss": Spec(lambda P: P.nn.BCELoss(),
                    lambda rs: [(rs.uniform(0.05, 0.95, (3, 4)).astype(
                        np.float32), True),
                        ((rs.rand(3, 4) > 0.5).astype(np.float32), False)]),
    "BCEWithLogitsLoss": Spec(
        lambda P: P.nn.BCEWithLogitsLoss(pos_weight=P.to_tensor(
            np.full(4, 1.5, np.float32))),
        lambda rs: [(_f(3, 4)(rs), True),
                    ((rs.rand(3, 4) > 0.5).astype(np.float32), False)]),
    "KLDivLoss-batchmean": Spec(
        lambda P: P.nn.KLDivLoss("batchmean"),
        lambda rs: [(np.log(_soft(rs, (3, 5))), True),
                    (_soft(rs, (3, 5)), False)]),
    "SmoothL1Loss": Spec(lambda P: P.nn.SmoothL1Loss(delta=0.5),
                         lambda rs: [(_f(3, 4)(rs), True),
                                     (_f(3, 4)(rs), False)]),
    "MarginRankingLoss": Spec(
        lambda P: P.nn.MarginRankingLoss(margin=0.1),
        lambda rs: [(_f(5)(rs), True), (_f(5)(rs), True),
                    (_pm1(rs, (5,)), False)]),
    "HingeEmbeddingLoss": Spec(
        lambda P: P.nn.HingeEmbeddingLoss(margin=0.5),
        lambda rs: [(_f(6)(rs), True), (_pm1(rs, (6,)), False)]),
    "CosineEmbeddingLoss": Spec(
        lambda P: P.nn.CosineEmbeddingLoss(margin=0.2),
        lambda rs: [(_f(4, 5)(rs), True), (_f(4, 5)(rs), True),
                    (_pm1(rs, (4,)), False)]),
    "TripletMarginLoss": Spec(
        lambda P: P.nn.TripletMarginLoss(swap=True),
        lambda rs: [(_f(4, 5)(rs), True), (_f(4, 5)(rs), True),
                    (_f(4, 5)(rs), True)]),
    "CTCLoss": Spec(
        lambda P: P.nn.CTCLoss(),
        lambda rs: [(_f(8, 2, 5)(rs), True),
                    (rs.randint(1, 5, (2, 3)).astype(np.int64), False),
                    (np.array([8, 7], np.int64), False),
                    (np.array([3, 2], np.int64), False)]),
    # -- transformer ---------------------------------------------------------
    "MultiHeadAttention": Spec(lambda P: P.nn.MultiHeadAttention(16, 4),
                               _x(2, 5, 16)),
    "MultiHeadAttention-weights": Spec(
        lambda P: P.nn.MultiHeadAttention(16, 4, need_weights=True),
        _x(2, 5, 16)),
    "MultiHeadAttention-kvdim": Spec(
        lambda P: P.nn.MultiHeadAttention(16, 4, kdim=12, vdim=8),
        lambda rs: [(_f(2, 5, 16)(rs), True), (_f(2, 6, 12)(rs), True),
                    (_f(2, 6, 8)(rs), True)]),
    "TransformerEncoderLayer": Spec(
        lambda P: P.nn.TransformerEncoderLayer(16, 4, 32, dropout=0.0),
        _x(2, 5, 16)),
    "TransformerEncoderLayer-pre-gelu-mask": Spec(
        lambda P: P.nn.TransformerEncoderLayer(
            16, 4, 32, dropout=0.0, activation="gelu",
            normalize_before=True),
        lambda rs: [(_f(2, 5, 16)(rs), True),
                    (np.triu(np.full((5, 5), -1e9, np.float32), 1), False)]),
    "TransformerEncoder": Spec(
        lambda P: P.nn.TransformerEncoder(P.nn.TransformerEncoderLayer(
            16, 4, 32, dropout=0.0), 2, P.nn.LayerNorm(16)), _x(2, 5, 16)),
    "TransformerDecoderLayer": Spec(
        lambda P: P.nn.TransformerDecoderLayer(16, 4, 32, dropout=0.0),
        lambda rs: [(_f(2, 3, 16)(rs), True), (_f(2, 5, 16)(rs), True)]),
    "TransformerDecoder": Spec(
        lambda P: P.nn.TransformerDecoder(P.nn.TransformerDecoderLayer(
            16, 4, 32, dropout=0.0, normalize_before=True), 2),
        lambda rs: [(_f(2, 3, 16)(rs), True), (_f(2, 5, 16)(rs), True)]),
    "Transformer": Spec(
        lambda P: P.nn.Transformer(16, 4, 1, 1, 32, dropout=0.0),
        lambda rs: [(_f(2, 5, 16)(rs), True), (_f(2, 3, 16)(rs), True)]),
    # -- conv ----------------------------------------------------------------
    "Conv1D": Spec(lambda P: P.nn.Conv1D(4, 6, 3, padding=1), _x(2, 4, 9)),
    "Conv2D": Spec(lambda P: P.nn.Conv2D(4, 6, 3, stride=2, padding=1,
                                         groups=2), _x(2, 4, 8, 8)),
    "Conv2D-NHWC-same": Spec(lambda P: P.nn.Conv2D(
        3, 4, 3, padding="SAME", data_format="NHWC"), _x(1, 6, 5, 3)),
    "Conv3D": Spec(lambda P: P.nn.Conv3D(3, 4, 3, padding=1),
                   _x(1, 3, 5, 5, 5)),
    "Conv1DTranspose": Spec(lambda P: P.nn.Conv1DTranspose(
        4, 3, 3, stride=2, padding=1, output_padding=1), _x(2, 4, 7)),
    "Conv2DTranspose": Spec(lambda P: P.nn.Conv2DTranspose(
        3, 6, 4, stride=2, padding=1), _x(1, 3, 8, 8)),
    "Conv3DTranspose": Spec(lambda P: P.nn.Conv3DTranspose(2, 3, 3, stride=2),
                            _x(1, 2, 4, 4, 4)),
    # -- pooling -------------------------------------------------------------
    "MaxPool1D": Spec(lambda P: P.nn.MaxPool1D(3, 2, 1), _x(2, 3, 9)),
    "MaxPool2D-mask": Spec(lambda P: P.nn.MaxPool2D(3, 2, 1,
                                                    return_mask=True),
                           _x(2, 3, 9, 8)),
    "MaxPool2D-ceil": Spec(lambda P: P.nn.MaxPool2D(2, ceil_mode=True),
                           _x(2, 3, 7, 7)),
    "MaxPool3D": Spec(lambda P: P.nn.MaxPool3D(2), _x(1, 2, 4, 6, 4)),
    "AvgPool1D": Spec(lambda P: P.nn.AvgPool1D(3, 2, 1), _x(2, 3, 9)),
    "AvgPool2D-inclusive": Spec(lambda P: P.nn.AvgPool2D(
        3, 2, 1, exclusive=False), _x(2, 3, 8, 8)),
    "AvgPool2D-ceil": Spec(lambda P: P.nn.AvgPool2D(2, ceil_mode=True),
                           _x(2, 3, 7, 7)),
    "AvgPool3D": Spec(lambda P: P.nn.AvgPool3D(2, 2), _x(1, 2, 4, 4, 6)),
    "AdaptiveAvgPool1D": Spec(lambda P: P.nn.AdaptiveAvgPool1D(4),
                              _x(2, 3, 10)),
    "AdaptiveAvgPool2D": Spec(lambda P: P.nn.AdaptiveAvgPool2D((3, 5)),
                              _x(2, 3, 7, 9)),
    "AdaptiveAvgPool3D": Spec(lambda P: P.nn.AdaptiveAvgPool3D(2),
                              _x(1, 2, 4, 5, 4)),
    "AdaptiveMaxPool1D": Spec(lambda P: P.nn.AdaptiveMaxPool1D(3),
                              _x(2, 3, 10)),
    "AdaptiveMaxPool2D": Spec(lambda P: P.nn.AdaptiveMaxPool2D(3),
                              _x(2, 3, 7, 9)),
    "AdaptiveMaxPool3D": Spec(lambda P: P.nn.AdaptiveMaxPool3D(2),
                              _x(1, 2, 4, 4, 4)),
}


# the attention specs on the card: head size 16 (the flash kernels' smallest)
CARD_SPECS = {
    "MultiHeadAttention": Spec(lambda P: P.nn.MultiHeadAttention(32, 2),
                               _x(2, 5, 32)),
    "MultiHeadAttention-weights": Spec(
        lambda P: P.nn.MultiHeadAttention(32, 2, need_weights=True),
        _x(2, 5, 32)),
    "MultiHeadAttention-kvdim": Spec(
        lambda P: P.nn.MultiHeadAttention(32, 2, kdim=12, vdim=8),
        lambda rs: [(_f(2, 5, 32)(rs), True), (_f(2, 6, 12)(rs), True),
                    (_f(2, 6, 8)(rs), True)]),
    "TransformerEncoderLayer": Spec(
        lambda P: P.nn.TransformerEncoderLayer(32, 2, 48, dropout=0.0),
        _x(2, 5, 32)),
    "TransformerEncoderLayer-pre-gelu-mask": Spec(
        lambda P: P.nn.TransformerEncoderLayer(
            32, 2, 48, dropout=0.0, activation="gelu",
            normalize_before=True),
        lambda rs: [(_f(2, 5, 32)(rs), True),
                    (np.triu(np.full((5, 5), -1e9, np.float32), 1), False)]),
    "TransformerEncoder": Spec(
        lambda P: P.nn.TransformerEncoder(P.nn.TransformerEncoderLayer(
            32, 2, 48, dropout=0.0), 2, P.nn.LayerNorm(32)), _x(2, 5, 32)),
    "TransformerDecoderLayer": Spec(
        lambda P: P.nn.TransformerDecoderLayer(32, 2, 48, dropout=0.0),
        lambda rs: [(_f(2, 3, 32)(rs), True), (_f(2, 5, 32)(rs), True)]),
    "TransformerDecoder": Spec(
        lambda P: P.nn.TransformerDecoder(P.nn.TransformerDecoderLayer(
            32, 2, 48, dropout=0.0, normalize_before=True), 2),
        lambda rs: [(_f(2, 3, 32)(rs), True), (_f(2, 5, 32)(rs), True)]),
    "Transformer": Spec(
        lambda P: P.nn.Transformer(32, 2, 1, 1, 48, dropout=0.0),
        lambda rs: [(_f(2, 5, 32)(rs), True), (_f(2, 3, 32)(rs), True)]),
}


# -- the slice's training script (phase 40 cut to size) -----------------------

V, T, D, H, FFN, LAYERS, B = 97, 16, 64, 4, 128, 2, 4


def build(P, dropout=0.0):
    """The phase-40 encoder of ``tests/test_torch_nn_train.py``, written
    once for either package."""
    nn = P.nn

    class Encoder(nn.Layer):
        def __init__(self):
            super().__init__()
            self.word = nn.Embedding(V, D)
            self.pos = nn.Embedding(T, D)
            self.norm = nn.LayerNorm(D)
            self.encoder = nn.TransformerEncoder(nn.TransformerEncoderLayer(
                D, H, FFN, dropout=dropout, activation="gelu",
                attn_dropout=0.0), LAYERS)
            self.shift = self.create_parameter([D], is_bias=True)
            self.head = nn.Linear(D, V, weight_attr=P.ParamAttr(
                initializer=nn.initializer.Normal(0.0, 0.02)))
            self.loss = nn.CrossEntropyLoss()

        def forward(self, ids, pos, labels):
            h = self.norm(self.word(ids) + self.pos(pos))
            logits = self.head(self.encoder(h) + self.shift)
            return self.loss(logits, labels)

    return Encoder()


def batch(seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, V, (B, T)).astype(np.int64)
    pos = np.tile(np.arange(T, dtype=np.int64), (B, 1))
    return ids, pos, np.roll(ids, -1, axis=1)


def train(P, net, steps, batch, epsilon=1e-8):
    opt = P.optimizer.AdamW(learning_rate=1e-3, epsilon=epsilon,
                            parameters=net.parameters(),
                            grad_clip=P.nn.ClipGradByGlobalNorm(1.0))
    args = [P.to_tensor(a) for a in batch]   # on the current place
    losses = []
    for _ in range(steps):
        loss = net(*args)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return losses



def inputs(name, specs=None):
    """The spec's ``[(array, differentiable)]``, seeded by its name."""
    return (specs or SPECS)[name].inputs(np.random.RandomState(zlib.crc32(
        name.encode())))


def state(layer) -> dict:
    """``{name: numpy array}`` of a layer's state dict."""
    return {k: np.array(v.numpy()) for k, v in layer.state_dict().items()}


def run(P, layer, name, specs=None):
    """``(outputs, input grads, parameter grads, state after)`` of one
    call, as numpy: the cotangent of each float output is a fixed random
    array (seeded by the spec's name), ints (max-pool masks) are outputs
    only."""
    spec = (specs or SPECS)[name]
    layer.train() if spec.train else layer.eval()
    args = [P.to_tensor(a, stop_gradient=not (diff and a.dtype.kind == "f"))
            for a, diff in inputs(name, specs)]
    out = layer(*args, **spec.kwargs)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    rs = np.random.RandomState(zlib.crc32(name.encode()) + 1)
    loss = None
    for o in outs:
        if "float" in str(o.dtype):
            c = P.to_tensor(rs.standard_normal(o.shape).astype(np.float32))
            term = (o * c).sum()
            loss = term if loss is None else loss + term
    if loss is not None and not loss.stop_gradient:
        loss.backward()
    x_grads = [None if t.stop_gradient or t.grad is None
               else t.grad.numpy() for t in args]
    p_grads = {k: p.grad.numpy() for k, p in layer.named_parameters()
               if p.grad is not None}
    return ([np.array(o.numpy()) for o in outs], x_grads, p_grads,
            state(layer))

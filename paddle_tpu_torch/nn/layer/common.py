"""Common layers (``paddle_tpu.nn.layer.common`` counterparts).

``Linear`` is paddle's: its weight is ``[in, out]`` (Xavier-uniform over
those fans) and its bias ``[out]`` (zeros), the forward ``F.linear``
(``x @ W + b``).  ``weight_attr`` / ``bias_attr`` take every ``ParamAttr``
form; ``bias_attr=False`` drops the bias.  It is not a
``torch.nn.Linear``, so ``models.convert`` carries its weight as it is.

``Embedding`` zeroes its ``padding_idx`` row at construction and its
output rows for that index (``F.embedding``); ``sparse=True`` is accepted
and computes the dense gradient (the JAX package's selected-rows gradient
waits for ``core/selected_rows.py``).  ``Upsample`` calls
``F.interpolate`` with its settings; the dropouts draw from the port's
generators and are the identity outside training.
"""
from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer, param
from ..layout import resolve_data_format

__all__ = ["Linear", "Identity", "Dropout", "Dropout2D", "Dropout3D",
           "AlphaDropout", "Embedding", "Flatten", "Unflatten", "Upsample",
           "UpsamplingBilinear2D", "UpsamplingNearest2D", "PixelShuffle",
           "PixelUnshuffle", "ChannelShuffle", "CosineSimilarity", "Bilinear",
           "Pad1D", "Pad2D", "Pad3D", "ZeroPad2D"]


class Linear(Layer):
    """y = x W + b with W: [in_features, out_features] (paddle's
    layout)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        self.weight = self.create_parameter(
            (in_features, out_features), attr=weight_attr,
            default_initializer=I.XavierUniform())
        self.bias = self.create_parameter((out_features,), attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        p = self._parameters
        return F.linear(x, param(self, "weight"), p.get("bias"))

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = resolve_data_format(data_format)

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = resolve_data_format(data_format)

    def forward(self, x):
        return F.dropout3d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training)


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = None if padding_idx is None else (
            padding_idx if padding_idx >= 0 else num_embeddings + padding_idx)
        self._sparse = bool(sparse)
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), attr=weight_attr,
            default_initializer=I.XavierUniform())
        if self._padding_idx is not None:
            self.weight[self._padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, param(self, "weight"),
                           padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return x.flatten(self.start_axis, self.stop_axis)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis = axis
        self.shape = shape

    def forward(self, x):
        axis = self.axis % x.dim()
        return x.reshape(tuple(x.shape[:axis]) + tuple(self.shape)
                         + tuple(x.shape[axis + 1:]))


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = resolve_data_format(data_format)

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0,
                         data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = resolve_data_format(data_format)

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = resolve_data_format(data_format)

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups
        self.data_format = resolve_data_format(data_format)

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class Bilinear(Layer):
    """``out[b, o] = x1[b] W[o] x2[b] + bias``; W ``[out, in1, in2]``
    (Xavier-uniform), bias ``[1, out]``."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            (out_features, in1_features, in2_features), attr=weight_attr)
        self.bias = self.create_parameter((1, out_features), attr=bias_attr,
                                          is_bias=True)

    def forward(self, x1, x2):
        p = self._parameters
        return F.bilinear(x1, x2, param(self, "weight"), p.get("bias"))


class _PadNd(Layer):
    def __init__(self, padding, mode, value, data_format):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = resolve_data_format(data_format)

    def forward(self, x):
        return F.pad(x, self.padding, mode=self.mode, value=self.value,
                     data_format=self.data_format)


class Pad1D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL",
                 name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)

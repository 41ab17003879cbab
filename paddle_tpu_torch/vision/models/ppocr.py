"""PP-OCRv3's recognizer (``paddle_tpu.vision.models.ppocr`` counterpart):
``SVTRRec``, an SVTR-class text recognizer, and ``ppocrv3_rec``.

A conv stem (two stride-2 ``_ConvBNAct``: Swish) patch-embeds the line,
``AdaptiveAvgPool2D((1, None))`` collapses its height, and the ``[N, C,
W]`` map becomes the sequence ``[N, T, C]`` (T = W / 4).  ``blocks`` (a
``LayerList``, the JAX names) mixes it: ``LocalMixBlock`` (a depthwise
3x3 conv over the 1 x T lattice and an MLP, both residual) in the first
stage and at even positions of the later ones, ``GlobalMixBlock``
(``nn.MultiHeadAttention`` over the width and an MLP) at odd ones, with a
``Linear`` where the width changes.  Then ``norm`` and the CTC ``head``:
logits ``[N, T, num_classes]``, class 0 the blank.

At the JAX defaults (``dims=(64, 128, 256)``, ``num_heads=8``) the global
blocks attend at head size 16 (stage 2) and 32 (stage 3), with no mask:
on the card each launches flash rows 1 and 2 (``flash_attention_bthd``
and its three backward kernels).  Train with ``CTCHeadLoss``
(re-exported here, as in the JAX module).
"""
from __future__ import annotations

from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from .crnn import CTCHeadLoss  # noqa: F401  (re-export, as the JAX module)

__all__ = ["LocalMixBlock", "GlobalMixBlock", "SVTRRec", "ppocrv3_rec",
           "CTCHeadLoss"]


class _ConvBNAct(tnn.Module):
    def __init__(self, cin, cout, k=3, stride=1, groups=1):
        super().__init__()
        self.conv = nn.Conv2D(cin, cout, k, stride=stride,
                              padding=(k - 1) // 2, groups=groups,
                              bias_attr=False)
        self.bn = nn.BatchNorm2D(cout)
        self.act = nn.Swish()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class LocalMixBlock(tnn.Module):
    """Depthwise 3x3 neighbourhood mixing, then a channel MLP, both
    residual; ``x`` is ``[N, T, C]`` over a 1 x T lattice."""

    def __init__(self, dim, mlp_ratio=2.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.dw = nn.Conv2D(dim, dim, 3, padding=1, groups=dim)
        self.norm2 = nn.LayerNorm(dim)
        hidden = int(dim * mlp_ratio)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        n, t, c = x.shape
        y = self.norm1(x).transpose(1, 2).reshape(n, c, 1, t)
        x = x + self.dw(y).reshape(n, c, t).transpose(1, 2)
        return x + self.fc2(nn.functional.gelu(self.fc1(self.norm2(x))))


class GlobalMixBlock(tnn.Module):
    """Multi-head self-attention over the width, then an MLP."""

    def __init__(self, dim, num_heads=8, mlp_ratio=2.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = nn.MultiHeadAttention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim)
        hidden = int(dim * mlp_ratio)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        y = self.norm1(x)
        x = x + self.attn(y, y, y)
        return x + self.fc2(nn.functional.gelu(self.fc1(self.norm2(x))))


class SVTRRec(tnn.Module):
    """``[N, C, H, W]`` text lines -> CTC logits ``[N, W / 4,
    num_classes]``."""

    def __init__(self, num_classes, in_channels=3, dims=(64, 128, 256),
                 depths=(3, 6, 3), num_heads=8, max_width=320, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.stem = nn.Sequential(
            _ConvBNAct(in_channels, dims[0] // 2, 3, stride=2),
            _ConvBNAct(dims[0] // 2, dims[0], 3, stride=2))
        self.pool_h = nn.AdaptiveAvgPool2D((1, None))
        blocks = []
        dim = dims[0]
        for si, (d, depth) in enumerate(zip(dims, depths)):
            if d != dim:
                blocks.append(nn.Linear(dim, d))
                dim = d
            for bi in range(depth):
                if si == 0 or bi % 2 == 0:
                    blocks.append(LocalMixBlock(d))
                else:
                    blocks.append(GlobalMixBlock(d, num_heads))
        self.blocks = nn.LayerList(blocks)
        self.norm = nn.LayerNorm(dims[-1])
        self.head = nn.Linear(dims[-1], num_classes)
        self.to(dev)

    def forward(self, x):
        f = self.pool_h(self.stem(x))                # [N, C, 1, W / 4]
        n, c, _, w = f.shape
        seq = f.reshape(n, c, w).transpose(1, 2)     # [N, T, C]
        for blk in self.blocks:
            seq = blk(seq)
        return self.head(self.norm(seq))


def ppocrv3_rec(num_classes, **kw):
    """PP-OCRv3's recognition configuration (SVTR class)."""
    return SVTRRec(num_classes, **kw)

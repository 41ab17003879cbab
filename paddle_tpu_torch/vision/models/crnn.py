"""CRNN (``paddle_tpu.vision.models.crnn`` counterpart): a conv feature
extractor, a bidirectional LSTM over the width and a CTC head.

``CRNN`` takes ``[N, C, img_h, W]`` lines and returns CTC logits ``[N,
W / 4, num_classes]`` (class 0 is the blank), with the JAX model's layers
and state-dict names: ``convs`` (three conv / batch norm / ReLU / max-pool
groups, the last pool 2 x 1), ``lstm`` (``nn.LSTM``, ``direction=
"bidirect"``, cuDNN on the card) and ``fc``.  ``CTCHeadLoss`` is
``F.ctc_loss`` with full-length defaults over batch-first logits, which
``ctc_loss``'s layout rule reads as batch-first (and so T == N too).
Its default lengths are host values, so a step waits for the device
nowhere.  ``ctc_greedy_decode`` takes the argmax on the logits' device and
collapses repeats, then drops blanks, on the host.
"""
from __future__ import annotations

from torch import nn as tnn

from ... import nn
from ...device import resolve_device

__all__ = ["CRNN", "CTCHeadLoss", "crnn", "ctc_greedy_decode"]


class CRNN(tnn.Module):
    def __init__(self, num_classes, in_channels=1, hidden_size=96,
                 channels=(32, 64, 128), img_h=32, device=None):
        super().__init__()
        if img_h % 8 != 0:
            raise ValueError("img_h must be divisible by 8")
        dev = resolve_device(device)
        with dev:   # the Layers create their parameters there
            c1, c2, c3 = channels
            self.convs = nn.Sequential(
                nn.Conv2D(in_channels, c1, 3, padding=1), nn.BatchNorm2D(c1),
                nn.ReLU(), nn.MaxPool2D(2, 2),
                nn.Conv2D(c1, c2, 3, padding=1), nn.BatchNorm2D(c2),
                nn.ReLU(), nn.MaxPool2D(2, 2),
                nn.Conv2D(c2, c3, 3, padding=1), nn.BatchNorm2D(c3),
                nn.ReLU(), nn.MaxPool2D(kernel_size=(2, 1), stride=(2, 1)))
            self.img_h = img_h
            self.lstm = nn.LSTM(c3 * (img_h // 8), hidden_size,
                                direction="bidirect")
            self.fc = nn.Linear(2 * hidden_size, num_classes)
        self.to(dev)

    def forward(self, x):
        if x.shape[2] != self.img_h:
            raise ValueError(f"CRNN built for input height {self.img_h}, "
                             f"got {x.shape[2]}")
        f = self.convs(x)                               # [N, C, H', W']
        n, c, h, w = f.shape
        f = f.permute(0, 3, 1, 2).reshape(n, w, c * h)  # [N, T, C * H']
        out, _ = self.lstm(f)
        return self.fc(out)                             # [N, T, classes]


class CTCHeadLoss(tnn.Module):
    """CTC loss over batch-first logits ``[N, T, C]`` (blank 0)."""

    def __init__(self, blank=0):
        super().__init__()
        self.blank = blank

    def forward(self, logits, labels, input_lengths=None,
                label_lengths=None):
        n, t, _ = logits.shape
        if input_lengths is None:
            input_lengths = [t] * n
        if label_lengths is None:
            label_lengths = [labels.shape[1]] * n
        return nn.functional.ctc_loss(logits, labels, input_lengths,
                                      label_lengths, blank=self.blank,
                                      reduction="mean")


def crnn(num_classes, pretrained=False, **kwargs):
    if pretrained:
        raise ValueError("pretrained weights are not bundled; load a local "
                         "state dict with models.load_jax_state instead")
    return CRNN(num_classes, **kwargs)


def ctc_greedy_decode(logits, blank=0):
    """Collapse repeats, then drop blanks: one list of ids a row."""
    ids = logits.argmax(-1).cpu().numpy()      # [N, T]
    results = []
    for row in ids:
        out, prev = [], -1
        for tok in row:
            if tok != prev and tok != blank:
                out.append(int(tok))
            prev = tok
        results.append(out)
    return results

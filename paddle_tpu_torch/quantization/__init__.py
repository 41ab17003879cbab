"""paddle.quantization of the port (``paddle_tpu.quantization``
counterpart; reference: python/paddle/static/quantization post-training +
QAT passes, and the paddle.quantization QAT config API).

Simulated int8 quantization, as in the JAX package: QAT inserts fake
quant (quantize-dequantize with a straight-through estimator) on the
weights and activations of ``Linear`` / ``Conv2D``; PTQ observes the
activations' ranges on calibration batches (whatever the train/eval
mode); ``convert`` bakes the weights onto the int8 grid and freezes the
observers, leaving the quant/dequant ops in the model with the
calibrated scales.  Compute stays in float on the quantized values.

Where the port differs in form, not in result:

* ``_fake_quant``'s ``custom_vjp`` is a ``torch.autograd.Function`` with
  the same straight-through rule: the gradient passes where ``|x| <=
  scale`` and is 0 outside, and the scale's gradient is 0; the weight
  wrapper's STE is ``w + (qdq(w) - w).detach()``.  Both run through
  ``core.op.apply_op`` as ``fake_quantize_dequantize`` and
  ``weight_quantize``, the JAX package's op names (``amp`` decides by
  them); torch tensors in give torch tensors out, surface Tensors in give
  Tensors out.
* The layer walk goes over ``named_children()`` and swaps with
  ``setattr``, so a model of plain ``torch.nn.Module``s holding paddle
  ``nn.Conv2D`` / ``nn.Linear`` (the port's ResNet) is quantized too.
  ``convert`` writes the int8-grid weights into the parameters in place.
* The abs-max observer keeps its moving average on the device: an
  observed forward does not wait for the device.  ``HistObserver`` reads
  each batch's abs-max on the host (its range decision, one scalar) and
  bins ``|x|`` where ``x`` lies: the counts are computed on the device
  with numpy's ``histogram`` arithmetic (``_histogram``: the same float64
  bin index, the same float32 edges and their corrections, so the counts
  equal ``np.histogram``'s), and only the ``bins`` counts come to the
  host, where the range folding, the running histogram and the threshold
  search (``cal_kl_threshold``, percentile, mse) stay numpy, as in JAX.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from ..core.op import apply_op
from ..nn.layer_base import Layer, param

__all__ = ["QuantConfig", "QAT", "PTQ", "FakeQuanterWithAbsMaxObserver",
           "adaround_weight",
           "HistObserver", "cal_kl_threshold", "quant_dequant",
           "QuantedLinear", "QuantedConv2D"]


# -- fake quant with straight-through estimator ------------------------------

def _qdq(x, scale, qmax):
    """The one quantize-dequantize formula (scalar or per-channel scale)."""
    q = torch.clamp(torch.round(x / scale * qmax), -qmax, qmax)
    return q * scale / qmax


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, qmax):
        ctx.save_for_backward(x, scale)
        return _qdq(x, scale, qmax)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        # STE: pass gradients through inside the clip range, zero outside
        inside = (x.abs() <= scale).to(g.dtype)
        return g * inside, torch.zeros_like(scale), None


def quant_dequant(x, scale, bits=8):
    """Simulated quantization op (fake_quantize_dequantize_abs_max)."""
    qmax = float(2 ** (bits - 1) - 1)

    def raw(v, s):
        s = torch.as_tensor(s, device=v.device)
        return _FakeQuant.apply(v, torch.clamp(s, min=1e-8), qmax)

    return apply_op(raw, "fake_quantize_dequantize", (x, scale), {})


class FakeQuanterWithAbsMaxObserver(Layer):
    """QAT quanter: tracks a running abs-max and fake-quants through it
    (reference FakeQuanterWithAbsMaxObserverLayer).  Observation is gated by
    `observing`, NOT the train/eval flag, so the standard PTQ flow
    (net.eval() before calibration) still collects statistics; convert()
    freezes it."""

    def __init__(self, moving_rate=0.9, bit_length=8, name=None):
        super().__init__()
        self.moving_rate = moving_rate
        self.bit_length = bit_length
        self.register_buffer("scale", torch.ones((), dtype=torch.float32))
        self._seen = False
        self.observing = True

    def forward(self, x):
        if self.observing:
            self._observe_value(x.detach())
        return quant_dequant(x, self._buffers["scale"], bits=self.bit_length)

    def _set_scale(self, value):
        """Rebind the scale buffer (a new tensor: a forward's saved scale
        keeps its value for the backward)."""
        self._buffers["scale"] = torch.as_tensor(
            value, dtype=torch.float32, device=self._buffers["scale"].device)

    def _observe_value(self, xv):
        """EMA of batch abs-maxes, kept entirely on the device: the abs-max
        reduce, the blend and the stored scale are device values, so an
        observed forward does not wait for the device.  Subclasses that
        need the full distribution (HistObserver) override this."""
        cur = (xv.abs().max().float() if xv.numel()
               else torch.zeros((), dtype=torch.float32, device=xv.device))
        new = cur if not self._seen else \
            self.moving_rate * self._buffers["scale"] + \
            (1 - self.moving_rate) * cur
        self._set_scale(new)
        self._seen = True


class _QuantedWrapper(Layer):
    """Wraps a Linear/Conv2D: fake-quant activation + weight, then run the
    original layer with the quantized weight."""

    def __init__(self, inner, a_quanter=None, w_bits=8, w_per_channel=False):
        super().__init__()
        self.inner = inner
        if a_quanter is not None:       # the observer lives with the layer
            a_quanter.to(inner._parameters["weight"].device)
        self.activation_quanter = a_quanter
        self.w_bits = w_bits
        self.w_per_channel = w_per_channel
        # set to [] by PTQ(weight_rounding="adaround"): calibration inputs
        # stashed for the convert()-time rounding optimization
        self._stash = None

    def _wq(self):
        w = param(self.inner, "weight")
        qmax = float(2 ** (self.w_bits - 1) - 1)
        per_channel = self.w_per_channel
        axis = _channel_axis(self.inner)

        # STE at the wrapper level: quantization is identity for grads
        def raw_ste(wv):
            with torch.no_grad():
                step = _qdq(wv, _weight_scales(wv, per_channel, axis),
                            qmax) - wv
            return wv + step

        return apply_op(raw_ste, "weight_quantize", (w,), {})

    def forward(self, x):
        if self._stash is not None and len(self._stash) < 4:
            # PRE-quant input: adaround re-applies the activation quanter
            # at convert() time, when its scale is FINALIZED — the interim
            # running scale here would mis-train the rounding
            self._stash.append(x.detach())
        if self.activation_quanter is not None:
            x = self.activation_quanter(x)
        w = self._wq()
        return self._call_with_weight(x, w)


class QuantedLinear(_QuantedWrapper):
    def _call_with_weight(self, x, w):
        from ..nn import functional as F
        return F.linear(x, w, param(self.inner, "bias"))


class QuantedConv2D(_QuantedWrapper):
    def _call_with_weight(self, x, w):
        from ..nn import functional as F
        i = self.inner
        return F.conv2d(x, w, param(i, "bias"), i._stride, i._padding,
                        i._dilation, i._groups, i._data_format)


class QuantConfig:
    """paddle.quantization.QuantConfig parity (subset: global activation /
    weight quanter factories)."""

    def __init__(self, activation=None, weight=None, activation_bits=8,
                 weight_bits=8, weight_quantize_type="abs_max"):
        self.activation = activation
        if weight is not None:
            raise NotImplementedError(
                "custom weight quanters are not supported; weights use "
                "abs-max fake quant at weight_bits precision")
        if weight_quantize_type not in ("abs_max", "channel_wise_abs_max"):
            raise ValueError(
                f"unknown weight_quantize_type {weight_quantize_type!r}")
        self.activation_bits = activation_bits
        self.weight_bits = weight_bits
        self.weight_quantize_type = weight_quantize_type

    def add_layer_config(self, *a, **kw):
        pass  # per-layer overrides not needed for the subset

    def _make_act_quanter(self):
        if self.activation is None:
            return FakeQuanterWithAbsMaxObserver(
                bit_length=self.activation_bits)
        if isinstance(self.activation, type):
            return self.activation()
        # instance template: each wrapped layer needs its OWN observer
        return copy.deepcopy(self.activation)


def _modules(model):
    """Every module of ``model``, itself first (a list, taken before any
    swap)."""
    return list(torch.nn.Module.modules(model))


def _swap_layers(model, factory):
    """Replace Linear/Conv2D children via `factory(layer)` (in place), in
    any module of the tree: paddle Layers and plain torch modules."""
    from ..nn.layer.common import Linear
    from ..nn.layer.conv import Conv2D

    for parent in _modules(model):
        if isinstance(parent, _QuantedWrapper):
            continue
        for name, sub in list(parent.named_children()):
            if isinstance(sub, (Linear, Conv2D)):
                setattr(parent, name, factory(sub))
    return model


class QAT:
    """Quantization-aware training (reference QAT class)."""

    def __init__(self, config: QuantConfig | None = None):
        self.config = config or QuantConfig()

    def quantize(self, model, inplace=True):
        from ..nn.layer.common import Linear

        if not inplace:
            model = copy.deepcopy(model)

        def factory(sub):
            cls = QuantedLinear if isinstance(sub, Linear) else QuantedConv2D
            return cls(sub, self.config._make_act_quanter(),
                       w_bits=self.config.weight_bits,
                       w_per_channel=(self.config.weight_quantize_type ==
                                      "channel_wise_abs_max"))

        return _swap_layers(model, factory)

    @torch.no_grad()
    def convert(self, model, inplace=True):
        """Freeze for inference: bake weight quantization into the stored
        weights and STOP observing — the quant/dequant ops stay in the graph
        with the calibrated activation scales (reference converted-program
        semantics)."""
        if not inplace:
            model = copy.deepcopy(model)
        # pass 1: finalize + freeze every observer FIRST, so the learned
        # rounding below sees the final activation scales, not the interim
        # running abs-max used during calibration
        for layer in _modules(model):
            if isinstance(layer, HistObserver):
                layer.finalize()      # histogram -> calibrated threshold
            if isinstance(layer, FakeQuanterWithAbsMaxObserver):
                layer.observing = False
        for layer in _modules(model):
            if isinstance(layer, _QuantedWrapper):
                w = layer.inner._parameters["weight"]
                stash, layer._stash = layer._stash, None  # stop stashing
                if stash:
                    # learned rounding on stashed calibration inputs
                    with torch.enable_grad():
                        wa = adaround_weight(layer, stash)
                    w.copy_(wa)
                    continue
                qmax = float(2 ** (layer.w_bits - 1) - 1)
                s = _weight_scales(w, layer.w_per_channel,
                                   _channel_axis(layer.inner))
                w.copy_(_qdq(w, s, qmax))
        return model


class PTQ(QAT):
    """Post-training quantization: quantize(), run calibration batches (any
    train/eval mode — observers watch until convert), then convert().

    `algo` selects the activation calibrator (reference
    post_training_quantization.py): 'kl' (default; cal_kl_threshold),
    'hist' (percentile), 'mse', 'avg', 'abs_max'.  `weight_quantize_type`
    'channel_wise_abs_max' enables per-output-channel weight scales."""

    _DEFAULT_CAL = ("kl", 2048, 0.99999, "channel_wise_abs_max")

    def __init__(self, config: QuantConfig | None = None, algo="kl",
                 bins=2048, percent=0.99999,
                 weight_quantize_type="channel_wise_abs_max",
                 weight_rounding="nearest"):
        if weight_rounding not in ("nearest", "adaround"):
            raise ValueError(
                f"unknown weight_rounding {weight_rounding!r}")
        self.weight_rounding = weight_rounding
        if config is not None:
            if (algo, bins, percent, weight_quantize_type) != \
                    self._DEFAULT_CAL:
                raise ValueError(
                    "pass EITHER an explicit QuantConfig or calibration "
                    "kwargs (algo/bins/percent/weight_quantize_type), not "
                    "both — the config would silently win")
        else:
            # every algo incl. abs_max goes through HistObserver: PTQ
            # abs_max means the GLOBAL max over calibration (reference
            # semantics), not the QAT moving average
            act = HistObserver(algo=algo, bins=bins, percent=percent)
            config = QuantConfig(
                activation=act, weight_quantize_type=weight_quantize_type)
        super().__init__(config)

    def quantize(self, model, inplace=True):
        model = super().quantize(model, inplace=inplace)
        if self.weight_rounding == "adaround":
            for layer in _modules(model):
                if isinstance(layer, _QuantedWrapper):
                    layer._stash = []
        return model


# -- PTQ calibration depth (reference slim/quantization:
# post_training_quantization.py algos {KL, hist, mse, avg, abs_max} +
# cal_kl_threshold.py, channel-wise weight quantization) ----------------------

def cal_kl_threshold(hist, bin_width, bits=8):
    """TensorRT-style KL calibration (reference cal_kl_threshold.py:75):
    pick the clip threshold whose 2^(bits-1)-1-level quantized distribution
    has minimum KL divergence from the clipped reference distribution.
    `hist` bins |x| from 0 with width `bin_width`; returns the threshold."""
    hist = np.asarray(hist, np.float64).copy()
    nbins = len(hist)
    levels = 2 ** (bits - 1) - 1
    # drop the zero bin (TensorRT/MXNet detail): exact zeros — half of any
    # post-ReLU tensor — quantize losslessly at EVERY threshold, but left
    # in the histogram their spike dominates the divergence and rewards
    # clipping away real mass
    hist[0] = 0.0
    # search from `levels` bins upward (TensorRT's original start): the
    # reference starts at nbins/2, which can never clip below half the
    # histogram range and so fails exactly when outliers inflate the range
    csum = np.concatenate([[0.0], np.cumsum(hist)])
    nzsum = np.concatenate([[0], np.cumsum(hist > 0)])
    total = csum[-1]
    best_i, best_kl = nbins, np.inf
    for i in range(levels, nbins + 1):
        tail = total - csum[i]
        if hist[i - 1] == 0 and tail != 0:
            # clipped mass would fold onto an EMPTY edge bin: no quantizer
            # level represents it, so the divergence is infinite
            continue
        if hist[i - 1] == 0 and tail == 0:
            continue
        p = hist[:i].copy()
        p[i - 1] += tail                    # fold outliers into the edge
        # quantize the first i bins down to `levels` merged bins, then
        # expand back, spreading each merged mass over its NONZERO source
        # bins (all vectorized: cumsum differences + searchsorted)
        edges = (np.arange(levels + 1) * i) // levels   # strictly increasing
        merged = csum[edges[1:]] - csum[edges[:-1]]
        nnz_per = (nzsum[edges[1:]] - nzsum[edges[:-1]]).astype(np.float64)
        k_of_j = np.searchsorted(edges, np.arange(i), side="right") - 1
        fill = np.divide(merged[k_of_j], nnz_per[k_of_j],
                         out=np.zeros(i), where=nnz_per[k_of_j] > 0)
        q = np.where(hist[:i] > 0, fill, 0.0)
        psum, qsum = p.sum(), q.sum()
        if psum == 0 or qsum == 0:
            continue
        p /= psum
        q /= qsum
        mask = (p > 0) & (q > 0)
        kl = float(np.sum(p[mask] * np.log(p[mask] / q[mask])))
        if kl < best_kl:
            best_kl, best_i = kl, i
    return best_i * bin_width


def _histogram(av, bins, hi):
    """``np.histogram(av, bins, range=(0.0, hi))[0]`` of a 1-D float32
    tensor of non-negative values, computed where ``av`` lies with numpy's
    arithmetic (numpy 2's uniform-bin path: the bin index from the float64
    quotient, corrected against the float32 edges, the last bin closed);
    values outside ``[0, hi]`` and NaNs are dropped.  Returns the counts
    as an int64 numpy array (the only copy to the host)."""
    edges = torch.from_numpy(np.linspace(0.0, hi, bins + 1,
                                         dtype=np.float32)).to(av.device)
    keep = (av >= 0.0) & (av <= hi)
    av = torch.where(keep, av, 0.0)
    idx = (av.double() / hi * bins).long()
    idx = torch.where(idx == bins, bins - 1, idx)
    idx = idx - (av < edges[idx]).long()
    idx = idx + ((av >= edges[idx + 1]) & (idx != bins - 1)).long()
    idx = torch.where(keep, idx, bins)          # dropped: an overflow bin
    return torch.bincount(idx, minlength=bins + 1)[:bins].cpu().numpy()


class HistObserver(FakeQuanterWithAbsMaxObserver):
    """Histogram-calibrated activation observer
    (reference post_training_quantization.py algo= 'KL' | 'hist' | 'mse' |
    'avg' | 'abs_max').  Accumulates an adaptive-range histogram of |x|
    over calibration batches; ``finalize()`` (called by convert()) turns it
    into the clip threshold:

    * kl    — min-KL threshold (cal_kl_threshold)
    * hist  — `percent` quantile of the histogram mass (reference 'hist')
    * mse   — threshold minimizing simulated-quant MSE over the histogram
    * avg   — mean of the per-batch abs-max values
    * abs_max — global abs-max (same as the base observer)
    """

    def __init__(self, algo="kl", bins=2048, percent=0.99999, bit_length=8,
                 name=None):
        super().__init__(bit_length=bit_length)
        if algo not in ("kl", "hist", "mse", "avg", "abs_max"):
            raise ValueError(f"unknown PTQ algo {algo!r}")
        self.algo = algo
        self.bins = int(bins)
        self.percent = float(percent)
        self._hist = np.zeros(self.bins, np.float64)
        self._range = 0.0
        self._batch_maxes: list[float] = []
        self._finalized = False

    def _observe_value(self, xv):
        # histogram calibration needs the |x| distribution: binned where
        # x lies, the counts come to the host
        self._observe(xv.abs().float().reshape(-1))

    def _observe(self, av):
        cur = float(av.max()) if av.numel() else 0.0
        self._batch_maxes.append(cur)
        if cur == 0.0:
            return
        if cur > self._range:
            # grow the range: fold existing counts into coarser bins
            if self._range > 0.0:
                factor = int(np.ceil(cur / self._range))
                folded = np.zeros(self.bins, np.float64)
                idx = np.arange(self.bins) // factor
                np.add.at(folded, idx, self._hist)
                self._hist = folded
                self._range *= factor
            else:
                self._range = cur
        self._hist += _histogram(av, self.bins, self._range)
        # running abs-max keeps fake-quant sane DURING calibration
        self._set_scale(max(self._batch_maxes))
        self._seen = True

    # forward comes from the base class; only the observe hook differs

    def finalize(self):
        """Compute the calibrated threshold and write it into `scale`."""
        if self._finalized or not self._batch_maxes:
            return
        bw = self._range / self.bins if self._range else 1.0
        if self.algo == "kl":
            t = cal_kl_threshold(self._hist, bw, self.bit_length)
        elif self.algo == "hist":
            c = np.cumsum(self._hist)
            total = c[-1] if c[-1] > 0 else 1.0
            t = (np.searchsorted(c, self.percent * total) + 1) * bw
        elif self.algo == "mse":
            qmax = 2 ** (self.bit_length - 1) - 1
            centers = (np.arange(self.bins) + 0.5) * bw
            best_t, best_mse = self._range, np.inf
            for i in range(max(1, self.bins // 256), self.bins + 1,
                           max(1, self.bins // 256)):
                t_c = i * bw
                # quantize-with-clip: centers beyond t_c saturate at t_c,
                # so the clipping error is part of the same expression
                q = np.clip(np.round(centers / t_c * qmax), -qmax, qmax) \
                    * t_c / qmax
                mse = float(np.sum(self._hist * (q - centers) ** 2))
                if mse < best_mse:
                    best_mse, best_t = mse, t_c
            t = best_t
        elif self.algo == "avg":
            t = float(np.mean(self._batch_maxes))
        else:                     # abs_max
            t = float(np.max(self._batch_maxes))
        self._set_scale(max(t, 1e-8))
        self._finalized = True


def _channel_axis(layer):
    from ..nn.layer.common import Linear
    return 1 if isinstance(layer, Linear) else 0   # conv: [out, in, kh, kw]


def _weight_scales(wv, per_channel, axis):
    if not per_channel:
        return torch.clamp(wv.abs().max(), min=1e-8)
    red = tuple(d for d in range(wv.dim()) if d != axis)
    s = torch.clamp(wv.abs().amax(dim=red), min=1e-8)
    shape = [1] * wv.dim()
    shape[axis] = -1
    return s.reshape(shape)


# -- AdaRound (reference slim/quantization/adaround.py): learned weight
# rounding — optimize a per-element soft rounding mask so the QUANTIZED
# layer's outputs match the float layer on calibration data, instead of
# rounding to nearest ---------------------------------------------------------

_ADAROUND_GAMMA, _ADAROUND_ZETA = -0.1, 1.1


def _soft_round(alpha):
    z, g = _ADAROUND_ZETA, _ADAROUND_GAMMA
    return torch.clamp(torch.sigmoid(alpha) * (z - g) + g, 0.0, 1.0)


def adaround_weight(wrapper, inputs, iters=200, reg=0.01, lr=1e-2,
                    warm_start=0.2, beta_range=(20.0, 2.0)):
    """Optimize the rounding of `wrapper.inner.weight` on calibration
    `inputs` (list of tensors) and return the adarounded weight values.

    Loss = ||layer(x; W_q) - layer(x; W)||^2 + reg * sum(1 - |2h-1|^beta)
    with h the rectified-sigmoid mask, beta annealed high->low and the
    regularizer off during the warm-start fraction (reference
    AdaRoundLoss.compute_round_loss / compute_beta)."""
    from ..optimizer import Adam

    inner = wrapper.inner
    w = inner._parameters["weight"].detach()
    qmax = float(2 ** (wrapper.w_bits - 1) - 1)
    s = _weight_scales(w, wrapper.w_per_channel, _channel_axis(inner)) / qmax
    floor_w = torch.floor(w / s)
    rest = w / s - floor_w                       # in [0, 1)
    z, g = _ADAROUND_ZETA, _ADAROUND_GAMMA
    # init so _soft_round(alpha) == rest
    p = torch.clamp((rest - g) / (z - g), 1e-4, 1 - 1e-4)
    alpha = torch.log(p / (1 - p)).requires_grad_(True)
    opt = Adam(learning_rate=lr, parameters=[alpha])

    with torch.no_grad():
        if wrapper.activation_quanter is not None:
            # stashed inputs are PRE-quant; quantize with the FINAL scale
            inputs = [wrapper.activation_quanter(x) for x in inputs]
        fp_outs = [wrapper._call_with_weight(x, w) for x in inputs]
    for it in range(iters):
        frac = it / max(iters - 1, 1)
        h = torch.clamp(torch.sigmoid(alpha) * (z - g) + g, 0.0, 1.0)
        wq = torch.clamp(floor_w + h, -qmax, qmax) * s
        recon = None
        for x, fp in zip(inputs, fp_outs):
            d = ((wrapper._call_with_weight(x, wq) - fp) ** 2).mean()
            recon = d if recon is None else recon + d
        loss = recon
        if frac >= warm_start:
            b_hi, b_lo = beta_range
            t = (frac - warm_start) / max(1 - warm_start, 1e-9)
            beta = b_lo + 0.5 * (b_hi - b_lo) * (1 + np.cos(t * np.pi))
            round_loss = (1.0 - ((2 * h - 1).abs() ** beta)).sum()
            loss = loss + reg * round_loss
        loss.backward()
        opt.step()
        opt.clear_grad()
    h_final = (_soft_round(alpha.detach()) >= 0.5).to(w.dtype)
    return torch.clamp(floor_w + h_final, -qmax, qmax) * s

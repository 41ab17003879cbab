"""paddle.nn.quant — quantization layer namespace (reference
nn/quant/quant_layers.py FakeQuant*/QuantizedLinear wrappers).  The
working QAT/PTQ machinery lives in paddle_tpu_torch.quantization; this
module re-exports its layer-facing surface under the reference path."""
from ..quantization import *  # noqa: F401,F403

"""``paddle_tpu.incubate.nn`` counterpart: the fused transformer family
(``layer.fused_transformer``) and its functional forms (``functional``).
The reference backs them with monolithic CUDA kernels; here they are the
JAX layers' op sequences, and their attention core runs the port's flash
kernels."""
from . import functional  # noqa: F401
from .layer.fused_transformer import (  # noqa: F401
    FusedBiasDropoutResidualLayerNorm,
    FusedFeedForward,
    FusedMoELayer,
    FusedMultiHeadAttention,
    FusedMultiTransformer,
    FusedTransformerEncoderLayer,
)

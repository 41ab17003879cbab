"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``csrc/`` holds the sources; ``_build`` compiles them lazily)."""
from .flash_attention import flash_attention_bthd, flash_attention_plain
from .paged_attention import (paged_decode_attention,
                              paged_decode_attention_plain)

__all__ = ["flash_attention_bthd", "flash_attention_plain",
           "paged_decode_attention", "paged_decode_attention_plain"]

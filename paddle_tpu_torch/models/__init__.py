"""Models of the port (``paddle_tpu.models`` counterparts)."""
from .convert import load_jax_state, to_jax_state
from .gpt import (GPT_CONFIGS, GPTConfig, GPTDecoderLayer, GPTEmbeddings,
                  GPTForPretraining, GPTMLP, GPTModel, GPTSelfAttention,
                  build_gpt, gpt_config)

__all__ = ["GPTConfig", "GPT_CONFIGS", "gpt_config", "GPTSelfAttention",
           "GPTMLP", "GPTDecoderLayer", "GPTEmbeddings", "GPTModel",
           "GPTForPretraining", "build_gpt", "load_jax_state",
           "to_jax_state"]

"""Models of the port (``paddle_tpu.models`` counterparts)."""
from .convert import load_jax_state, to_jax_state
from .gpt import (GPT_CONFIGS, GPTConfig, GPTDecoderLayer, GPTEmbeddings,
                  GPTForPretraining, GPTMLP, GPTModel,
                  GPTPretrainingCriterion, GPTSelfAttention, build_gpt,
                  gpt_config, gpt_num_params, gpt_train_flops_per_token)

__all__ = ["GPTConfig", "GPT_CONFIGS", "gpt_config", "GPTSelfAttention",
           "GPTMLP", "GPTDecoderLayer", "GPTEmbeddings", "GPTModel",
           "GPTForPretraining", "GPTPretrainingCriterion", "build_gpt",
           "gpt_num_params", "gpt_train_flops_per_token", "load_jax_state",
           "to_jax_state"]

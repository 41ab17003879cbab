"""Models of the port (``paddle_tpu.models`` counterparts)."""
from .bert import (BERT_CONFIGS, BertConfig, BertForPretraining, BertModel,
                   BertPretrainingCriterion, ErnieConfig,
                   ErnieForPretraining, ErnieModel, bert_config, build_bert,
                   build_ernie)
from .convert import (load_jax_state, load_jax_train_state, to_jax_state,
                      to_jax_train_state)
from .gpt import (GPT_CONFIGS, FusedHeadOutput, GPTConfig, GPTDecoderLayer,
                  GPTEmbeddings, GPTForPretraining, GPTMLP, GPTModel,
                  GPTMoEMLP, GPTMoEPretrainingCriterion,
                  GPTPretrainingCriterion, GPTSelfAttention, build_gpt,
                  gpt_config, gpt_num_params, gpt_train_flops_per_token)

__all__ = ["GPTConfig", "GPT_CONFIGS", "gpt_config", "GPTSelfAttention",
           "GPTMLP", "GPTMoEMLP", "GPTDecoderLayer", "GPTEmbeddings",
           "GPTModel", "FusedHeadOutput", "GPTForPretraining",
           "GPTPretrainingCriterion", "GPTMoEPretrainingCriterion",
           "build_gpt", "gpt_num_params", "gpt_train_flops_per_token",
           "BertConfig", "BERT_CONFIGS", "bert_config", "BertModel",
           "BertForPretraining", "BertPretrainingCriterion", "ErnieConfig",
           "ErnieModel", "ErnieForPretraining", "build_bert", "build_ernie",
           "load_jax_state", "to_jax_state", "load_jax_train_state",
           "to_jax_train_state"]

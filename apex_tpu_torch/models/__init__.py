from apex_tpu_torch.models.bert import (
    BertConfig,
    BertEncoder,
    BertForPreTraining,
    BertLayer,
    BertSelfAttention,
    bert_base,
    bert_large,
)
from apex_tpu_torch.models.bert import params_from_jax as bert_params_from_jax
from apex_tpu_torch.models.gpt import (
    GPTBlock,
    GPTConfig,
    GPTLMHeadModel,
    GPTSelfAttention,
    gpt_medium,
    gpt_small,
    lm_loss,
    params_from_jax,
)

__all__ = ["BertConfig", "BertEncoder", "BertForPreTraining", "BertLayer",
           "BertSelfAttention", "GPTBlock", "GPTConfig", "GPTLMHeadModel",
           "GPTSelfAttention", "bert_base", "bert_large",
           "bert_params_from_jax", "gpt_medium", "gpt_small", "lm_loss",
           "params_from_jax"]

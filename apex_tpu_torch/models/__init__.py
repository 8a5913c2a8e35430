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

__all__ = ["GPTBlock", "GPTConfig", "GPTLMHeadModel", "GPTSelfAttention",
           "gpt_medium", "gpt_small", "lm_loss", "params_from_jax"]

from apex_tpu_torch.ops.decode_attention import (
    cached_attention,
    chunk_cached_attention,
)
from apex_tpu_torch.ops.flash_attention import (
    bias_to_kv_mask,
    dropout_params,
    flash_attention,
    keep_from_seed,
    make_flash_attention,
    seed_array,
)
from apex_tpu_torch.ops.flatten import (
    FlatSpec,
    flatten,
    flatten_grouped,
    flatten_like,
    unflatten,
)
from apex_tpu_torch.ops.kv_quant import INT8_QMAX, dequantize_kv, quantize_kv
from apex_tpu_torch.ops.multi_tensor import (
    multi_tensor_axpby,
    multi_tensor_l2norm,
    multi_tensor_scale,
    multi_tensor_unscale,
    tree_any_nonfinite,
)
from apex_tpu_torch.ops.sampling import (
    SamplingParams,
    finite_rows,
    greedy_argmax,
    processed_logits,
    sample_tokens,
    sample_tokens_host,
    sampling_noise,
)
from apex_tpu_torch.ops.vocab_parallel import vocab_parallel_lm_loss, \
    vocab_parallel_lm_loss_shard

__all__ = ["FlatSpec", "INT8_QMAX", "SamplingParams", "bias_to_kv_mask",
           "cached_attention",
           "chunk_cached_attention", "dequantize_kv", "dropout_params",
           "finite_rows", "flash_attention", "flatten", "flatten_grouped",
           "flatten_like",
           "greedy_argmax", "keep_from_seed", "make_flash_attention",
           "multi_tensor_axpby", "multi_tensor_l2norm",
           "multi_tensor_scale", "multi_tensor_unscale", "processed_logits",
           "quantize_kv", "sample_tokens", "sample_tokens_host",
           "sampling_noise", "seed_array", "tree_any_nonfinite", "unflatten",
           "vocab_parallel_lm_loss", "vocab_parallel_lm_loss_shard"]

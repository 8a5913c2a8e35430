from apex_tpu_torch.ops.decode_attention import (
    cached_attention,
    chunk_cached_attention,
)
from apex_tpu_torch.ops.flash_attention import (
    bias_to_kv_mask,
    flash_attention,
    make_flash_attention,
)
from apex_tpu_torch.ops.sampling import finite_rows, greedy_argmax

__all__ = ["bias_to_kv_mask", "cached_attention", "chunk_cached_attention",
           "finite_rows", "flash_attention", "greedy_argmax",
           "make_flash_attention"]

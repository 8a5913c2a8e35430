"""The precision-policy data: which ops run half, fp32, or promote.

Twin of ``apex_tpu/amp/lists.py`` (the reference's op lists,
``apex/amp/lists/functional_overrides.py``, ``torch_overrides.py``,
``tensor_overrides.py``), copied as it is: the data that drives O1.
``amp.patch`` applies it by patching the ``torch`` namespaces, as the
reference does (``amp.py:90-148``); ``FP32_MODULE_PATTERNS`` feeds the
norm layers ``AmpModel`` keeps fp32; ``half_function``,
``float_function`` and ``promote_function`` (``functional.py``) extend it
to a user's own functions.

``policy_for(op_name)`` answers "what would apex O1 do for this op".
"""

from __future__ import annotations

# MXU-bound ops: run in the half dtype (reference FP16_FUNCS,
# torch_overrides.py:84-104 — conv*/linear/matmul/BLAS family).
FP16_OPS = frozenset({
    "conv", "conv_general_dilated", "conv_transpose", "dense", "linear",
    "matmul", "dot", "dot_general", "einsum", "bmm", "mm", "mv",
    "addmm", "addbmm", "baddbmm", "conv1d", "conv2d", "conv3d",
    "conv_transpose1d", "conv_transpose2d", "conv_transpose3d",
    "prelu", "rnn_matmul",
})

# Numerically-sensitive ops: run in fp32 (reference FP32_FUNCS,
# functional_overrides.py:29-65, torch_overrides.py:106-138 — losses,
# softmax family, norms, pointwise transcendentals, reductions).
FP32_OPS = frozenset({
    "softmax", "log_softmax", "softmin", "cross_entropy", "nll_loss",
    "l1_loss", "mse_loss", "smooth_l1_loss", "kl_div",
    "binary_cross_entropy_with_logits", "softmax_cross_entropy",
    "softmax_cross_entropy_with_integer_labels",
    "sigmoid_binary_cross_entropy", "cosine_embedding_loss",
    "layer_norm", "group_norm", "batch_norm", "instance_norm",
    "local_response_norm", "normalize", "rms_norm",
    "exp", "expm1", "log", "log10", "log1p", "log2", "pow", "erf",
    "erfc", "erfinv", "acos", "asin", "atan", "cosh", "sinh", "tan",
    "logsumexp", "cumprod", "cumsum", "dist", "mean", "norm", "prod",
    "std", "sum", "var", "renorm",
})

# Dtype-agreement ops: promote mixed inputs to the widest float dtype
# (reference CASTS, torch_overrides.py:152-173).
PROMOTE_OPS = frozenset({
    "add", "addcdiv", "addcmul", "atan2", "cross", "div", "mul",
    "bilinear", "dot_elementwise", "eq", "ge", "gt", "le", "lt", "ne",
    "equal", "sub", "where", "minimum", "maximum",
})

# Sequence ops promoting across a list of tensors (reference
# SEQUENCE_CASTS, torch_overrides.py:177-180).
SEQUENCE_PROMOTE_OPS = frozenset({"cat", "concatenate", "stack"})

# Banned under amp: fp16 output range makes them unsafe; the reference
# raises and points at the *_with_logits form
# (functional_overrides.py:67-77).
BANNED_OPS = frozenset({"binary_cross_entropy"})

# Module-name patterns whose params stay fp32 under O1/O2 policies;
# re-exported into model.NORM_PATTERNS / BATCHNORM_PATTERNS.
FP32_MODULE_PATTERNS = (
    r"BatchNorm", r"SyncBatchNorm", r"LayerNorm", r"GroupNorm", r"RMSNorm",
)


def policy_for(op_name: str) -> str:
    """Return the O1 policy for ``op_name``: one of 'half', 'fp32',
    'promote', 'sequence_promote', 'banned', or 'passthrough'."""
    name = op_name.lower().rsplit(".", 1)[-1]
    if name in BANNED_OPS:
        return "banned"
    if name in FP16_OPS:
        return "half"
    if name in FP32_OPS:
        return "fp32"
    if name in PROMOTE_OPS:
        return "promote"
    if name in SEQUENCE_PROMOTE_OPS:
        return "sequence_promote"
    return "passthrough"


def banned_message(op_name: str) -> str:
    """The single source of the banned-op remediation text (shared by
    :func:`check_banned` and ``amp.banned_function``)."""
    return (
        f"amp does not work out-of-the-box with `{op_name}` — the fp16 "
        "range makes it unsafe. Use the *_with_logits / "
        "sigmoid_binary_cross_entropy form instead, or wrap the call "
        "site in apex_tpu_torch.amp.disable_casts to compute it outside "
        "amp's policy.")


def check_banned(op_name: str) -> None:
    """Raise (like the reference's banned-function wrapper,
    ``amp.py:164-171``) if ``op_name`` must not be used under amp."""
    if policy_for(op_name) == "banned":
        raise RuntimeError(banned_message(op_name))

"""torchvision ResNet and HuggingFace BERT checkpoints for the port's models.

Twin of ``apex_tpu/utils/torch_interop.py``.  :func:`load_torch_resnet`:
a torchvision-format ``state_dict`` (``conv1``, ``bn1``,
``layer{s}.{i}.conv{c}``/``bn{c}``, ``downsample.0``/``.1``, ``fc``)
renamed onto ``models.ResNet``'s flax names (``stem_conv``,
``stem_bn``, ``BasicBlock_k``/``Bottleneck_k`` numbered across the
stages, ``Conv_i``, ``BatchNorm_i``, ``downsample_conv``,
``downsample_bn``).  The port's convs are OIHW like torchvision's and
its fc is (out, in), so no tensor is transposed; the space-to-depth
stems take the 7x7 stem folded by ``models.resnet.stem_to_s2d``.

Returns ``{"params": {name: tensor}, "batch_stats": {name: tensor}}``:
the parameters and the running-statistics buffers, fp32 on the CPU, for
``load_state_dict`` of the union.

:func:`load_hf_bert`: a HuggingFace ``BertForPreTraining`` ``state_dict``
renamed onto the port's ``models.BertForPreTraining`` (the JAX package's
flax names, dotted); both keep ``nn.Linear``'s (out, in) weights, so no
tensor is transposed or reshaped.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from apex_tpu_torch.models.resnet import stem_to_s2d

_ARCH = {
    "resnet18": ("BasicBlock", [2, 2, 2, 2], 2),
    "resnet34": ("BasicBlock", [3, 4, 6, 3], 2),
    "resnet50": ("Bottleneck", [3, 4, 6, 3], 3),
    "resnet101": ("Bottleneck", [3, 4, 23, 3], 3),
    "resnet152": ("Bottleneck", [3, 8, 36, 3], 3),
}

# the port names every block norm BatchNorm_i, whatever its class
_NORM_NAMES = ("BatchNorm", "SyncBatchNorm")


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).contiguous()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _strip_module_prefix(state_dict):
    """DDP-wrapped models save ``module.``-prefixed keys (the reference's
    own ImageNet script does): strip a prefix every key has."""
    if state_dict and all(k.startswith("module.") for k in state_dict):
        return {k[len("module."):]: v for k, v in state_dict.items()}
    return state_dict


def load_torch_resnet(state_dict: Mapping[str, Any],
                      arch: str = "resnet50",
                      norm_name: str = "BatchNorm",
                      stem: str = "conv") -> Dict[str, Dict[str, torch.Tensor]]:
    """Convert a torchvision-format ResNet ``state_dict`` (tensors or
    numpy arrays) into ``{"params": ..., "batch_stats": ...}`` of the
    port's ``models.ResNetXX`` (see the module docstring).

    ``norm_name`` is the block norms' class name in the JAX model
    (``"SyncBatchNorm"`` under ``--sync_bn``); the port names them
    ``BatchNorm_i`` either way.  ``stem`` ``"s2d"``/``"s2d_pre"`` folds
    the stem kernel for the space-to-depth stems.  A key the arch does
    not read (other than ``num_batches_tracked``), a key it needs and
    misses, an unknown arch and an unknown stem raise ``ValueError``."""
    if arch not in _ARCH:
        raise ValueError(f"unknown arch {arch!r}; have {sorted(_ARCH)}")
    if norm_name not in _NORM_NAMES:
        raise ValueError(f"norm_name must be one of {_NORM_NAMES}; got "
                         f"{norm_name!r}")
    if stem not in ("conv", "s2d", "s2d_pre"):
        raise ValueError(f"stem must be 'conv', 's2d' or 's2d_pre', "
                         f"got {stem!r}")
    block_name, stage_sizes, convs_per_block = _ARCH[arch]
    state_dict = _strip_module_prefix(state_dict)
    consumed = set()

    def take(key: str) -> torch.Tensor:
        consumed.add(key)
        try:
            return _tensor(state_dict[key])
        except KeyError:
            raise ValueError(
                f"state_dict is missing {key!r}, required by "
                f"arch={arch!r} — wrong arch for this checkpoint?") from None

    params: Dict[str, torch.Tensor] = {}
    stats: Dict[str, torch.Tensor] = {}

    def bn(src: str, dst: str) -> None:
        params[f"{dst}.weight"] = take(f"{src}.weight")
        params[f"{dst}.bias"] = take(f"{src}.bias")
        stats[f"{dst}.running_mean"] = take(f"{src}.running_mean")
        stats[f"{dst}.running_var"] = take(f"{src}.running_var")

    if stem == "conv":
        params["stem_conv.weight"] = take("conv1.weight")
    else:
        params["stem_conv_s2d.weight"] = stem_to_s2d(take("conv1.weight"))
    bn("bn1", "stem_bn")
    k = 0
    for s, n_blocks in enumerate(stage_sizes, start=1):
        for i in range(n_blocks):
            src, dst = f"layer{s}.{i}", f"{block_name}_{k}"
            for c in range(convs_per_block):
                params[f"{dst}.Conv_{c}.weight"] = take(
                    f"{src}.conv{c + 1}.weight")
                bn(f"{src}.bn{c + 1}", f"{dst}.BatchNorm_{c}")
            if f"{src}.downsample.0.weight" in state_dict:
                params[f"{dst}.downsample_conv.weight"] = take(
                    f"{src}.downsample.0.weight")
                bn(f"{src}.downsample.1", f"{dst}.downsample_bn")
            k += 1
    params["fc.weight"] = take("fc.weight")
    params["fc.bias"] = take("fc.bias")

    # a deeper checkpoint would convert key-complete but truncated
    leftovers = [key for key in state_dict if key not in consumed
                 and not key.endswith("num_batches_tracked")]
    if leftovers:
        raise ValueError(
            f"state_dict has {len(leftovers)} keys not consumed by "
            f"arch={arch!r} (e.g. {sorted(leftovers)[:4]}); wrong arch?")
    return {"params": params, "batch_stats": stats}


def load_hf_bert(state_dict: Mapping[str, Any], num_hidden_layers: int,
                 num_attention_heads: int) -> Dict[str, Dict[str, torch.Tensor]]:
    """Convert a HuggingFace ``BertForPreTraining`` ``state_dict``
    (tensors or numpy arrays; a ``module.`` prefix is stripped) into
    ``{"params": {name: tensor}}`` of the port's
    ``models.BertForPreTraining``, fp32 on the CPU, for
    ``load_state_dict``:

    - ``bert.embeddings.*`` -> ``encoder.{word,position,token_type}_
      embeddings`` and ``encoder.embeddings_ln``;
    - ``bert.encoder.layer.<i>.attention.self.{query,key,value}`` ->
      ``encoder.layer_<i>.attention.*``, ``attention.output.dense`` ->
      ``attention.output``, its LayerNorm -> ``attention_ln``; the
      ``intermediate`` and ``output`` denses 1:1, the output LayerNorm ->
      ``output_ln``;
    - ``cls.predictions.transform`` -> ``mlm_transform``/``mlm_ln``,
      ``cls.predictions.decoder`` (with the tied
      ``cls.predictions.bias``) -> ``mlm_decoder``,
      ``cls.seq_relationship`` -> ``nsp_classifier``,
      ``bert.pooler.dense`` -> ``pooler``.

    A missing key and a key left over (other than ``position_ids``, a
    buffer of some transformers versions) raise ``ValueError`` with the
    JAX package's messages: a checkpoint of another depth than
    ``num_hidden_layers`` is refused either way.  ``num_attention_heads``
    is the JAX signature's; the port's projections need no head
    split."""
    del num_attention_heads
    raw = _strip_module_prefix(dict(state_dict))
    consumed = set()

    def get(key: str) -> torch.Tensor:
        consumed.add(key)
        try:
            return _tensor(raw[key])
        except KeyError:
            raise ValueError(
                f"state_dict is missing {key!r} — not a HuggingFace "
                "BertForPreTraining checkpoint, or wrong "
                "num_hidden_layers?") from None

    params: Dict[str, torch.Tensor] = {}

    def copy(src: str, dst: str, names=(("weight", "weight"),
                                       ("bias", "bias"))) -> None:
        for a, b in names:
            params[f"{dst}.{b}"] = get(f"{src}.{a}")

    ln = (("weight", "scale"), ("bias", "bias"))
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        copy(f"bert.embeddings.{name}", f"encoder.{name}", (("weight",
                                                            "weight"),))
    copy("bert.embeddings.LayerNorm", "encoder.embeddings_ln", ln)
    for i in range(num_hidden_layers):
        src, dst = f"bert.encoder.layer.{i}", f"encoder.layer_{i}"
        for name in ("query", "key", "value"):
            copy(f"{src}.attention.self.{name}", f"{dst}.attention.{name}")
        copy(f"{src}.attention.output.dense", f"{dst}.attention.output")
        copy(f"{src}.attention.output.LayerNorm", f"{dst}.attention_ln", ln)
        copy(f"{src}.intermediate.dense", f"{dst}.intermediate")
        copy(f"{src}.output.dense", f"{dst}.output")
        copy(f"{src}.output.LayerNorm", f"{dst}.output_ln", ln)

    if "cls.predictions.decoder.bias" in raw:
        params["mlm_decoder.bias"] = get("cls.predictions.decoder.bias")
        consumed.add("cls.predictions.bias")  # tied duplicate, if present
    else:
        params["mlm_decoder.bias"] = get("cls.predictions.bias")
    copy("bert.pooler.dense", "pooler")
    copy("cls.predictions.transform.dense", "mlm_transform")
    copy("cls.predictions.transform.LayerNorm", "mlm_ln", ln)
    params["mlm_decoder.weight"] = get("cls.predictions.decoder.weight")
    copy("cls.seq_relationship", "nsp_classifier")

    leftovers = [k for k in raw if k not in consumed
                 and not k.endswith("position_ids")]
    if leftovers:
        raise ValueError(
            f"state_dict has {len(leftovers)} keys not consumed with "
            f"num_hidden_layers={num_hidden_layers} "
            f"(e.g. {sorted(leftovers)[:4]}); wrong layer count?")
    return {"params": params}

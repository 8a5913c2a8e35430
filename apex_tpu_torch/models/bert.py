"""BERT encoder for pretraining — the FusedLayerNorm + FusedLAMB workload.

Twin of ``apex_tpu/models/bert.py`` (``BertForPreTraining`` and what it
is built from): a post-LN transformer encoder on :class:`FusedLayerNorm`
(eps 1e-12), exact-erf ``gelu``, an untied MLM decoder with bias, a
``[CLS]`` tanh pooler and the NSP head.  One tensor per JAX leaf, named
as the flax modules are (``encoder.layer_0.attention.query.bias``,
``encoder.layer_0.attention_ln.scale``, ...): LAMB's trust ratio is per
tensor and the BERT recipe's ``(bias|_ln)`` regex picks the no-decay
leaves by name, so a fused or renamed leaf would change the update.
Projections are plain ``nn.Linear`` (the JAX package leaves them to
XLA).

Attention runs through ``attention_fn(q, k, v, bias, dropout_fn)``
(default :func:`dot_product_attention`; ``make_flash_attention()`` for
the fused kernels).  Dropout draws from flax's ``dropout`` rng stream as
the JAX model does: ``forward(..., deterministic=False,
dropout_key=key)`` takes the key that the JAX model takes as
``rngs={"dropout": key}`` (two uint32, e.g. ``threefry.PRNGKey(seed)``
or ``np.asarray(jax.random.PRNGKey(seed))``), and every draw is keyed
by its flax module path and call count (``ops/threefry.py``), so the
same key drops the same positions in both packages:

- hidden dropout (the embeddings' ``Dropout_0`` after their LN, and
  each layer's one ``Dropout_0``, called on the attention output and
  then on the MLP output, its count advancing between the two):
  :class:`~apex_tpu_torch.ops.threefry.Dropout` (flax's ``nn.Dropout``
  bit for bit, the ``threefry_dropout`` kernel on the card);
- attention dropout: with a custom ``attention_fn``, each layer's int32
  seed ``randint(make_rng("dropout"), (), 0, int32 max)`` at the
  attention's scope, handed over as ``dropout_fn.rate`` /
  ``.seed`` for the flash kernels (dropout inside the kernel); the
  encoder draws all layers' seeds on the host and moves them to the
  card in one ``non_blocking`` copy from pinned memory; the default
  attention applies ``dropout_fn`` (the attention's ``Dropout_0``) to
  its materialized probs.

The keys depend only on the step key, the paths and the counts, so
they are computed on the host: nothing syncs.

``BertConfig.remat`` rematerialises each encoder layer in the backward
(``models/_remat.py``: ``torch.utils.checkpoint``, non-reentrant), as
``nn.remat`` does in the JAX model; the recompute draws the forward's
dropout keys, so the gradients equal those without remat bit for bit.

Sequence parallelism (``BertForPreTraining(cfg, attention_fn, sp=<sp
group>)`` with ``parallel.make_ring_attention`` or
``make_ulysses_attention``): each rank holds its S/sp tokens through the
whole model.  Its embeddings take positions ``sp_rank * S_local +
arange(S_local)``, its ``attention_mask`` is its shard's (the ring
carries it with its K/V, Ulysses gathers it), the hidden dropouts draw
its window of the dense activation's threefry stream
(``threefry.window``), and the heads give its (B, S_local, V) MLM
logits; the NSP logits are the pooled ``[CLS]`` token's only on sequence
rank 0, where that token lives (the caller takes the NSP term there
alone).

Not here: ``PipelinedBert``, MoE layers and the
``BertEmbeddings``/``BertStage``/``BertHeads`` split.  HuggingFace
checkpoints load through ``utils.load_hf_bert``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.models._remat import remat as remat_layer
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops import threefry


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    # rematerialize each encoder layer in the backward (training only)
    remat: bool = False


def bert_base() -> BertConfig:
    return BertConfig()


def bert_large() -> BertConfig:
    return BertConfig(hidden_size=1024, num_hidden_layers=24,
                      num_attention_heads=16, intermediate_size=4096)


def _scope(dropout_key) -> threefry.RngScope:
    """The flax scope of the ``dropout`` stream a module draws from: the
    root scope of a key, or the scope its parent hands down."""
    if dropout_key is None:
        raise ValueError("dropout (deterministic=False) needs a threefry "
                         "key: pass dropout_key=")
    return threefry.RngScope.of(dropout_key)


def dot_product_attention(q, k, v, bias=None, dropout_fn=None):
    """(B, S, H, D) q/k/v -> (B, S, H, D); softmax in fp32, then the
    probs in q's dtype through ``dropout_fn`` when one is given."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    scores = scores.float()
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if dropout_fn is not None:
        probs = dropout_fn(probs)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention_dropout_fn(dropout, scope, fused: bool, attention_seed,
                         device):
    """The ``dropout_fn`` an attention hands its ``attention_fn``: its
    ``Dropout_0`` (``dropout``, a ``threefry.Dropout``) on the probs,
    keyed from the attention's ``scope``.  A ``fused`` adapter cannot
    call a probs -> probs closure (the probs are never materialized):
    it consumes ``.rate`` and ``.seed``, the scope's per-call seed
    (``attention_seed`` when the caller drew it already), drawn on the
    host and put on ``device`` by a copy that does not sync."""
    drop = scope.push("Dropout_0")

    def dropout_fn(p):
        return dropout(p, drop.make_rng())

    if fused:
        if attention_seed is None:
            attention_seed = threefry.attention_seeds([scope], device)[0]
        dropout_fn.rate = dropout.rate
        dropout_fn.seed = attention_seed
    return dropout_fn


def _linear(n_in, n_out, dev, dtype):
    return nn.Linear(n_in, n_out, device=dev, dtype=dtype)


def _layer_norm(cfg, dev, dtype):
    return FusedLayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                          device=dev, dtype=dtype)


class BertSelfAttention(nn.Module):
    """q/k/v projections (one ``nn.Linear`` each, as the JAX leaves
    are), attention, output projection.  ``dropout_key`` is the
    attention's flax scope (or a key for a standalone call);
    ``attention_seed``, when given, is its already drawn per-call seed
    (a 0-d int32 tensor on the model's device)."""

    def __init__(self, cfg: BertConfig,
                 attention_fn: Optional[Callable] = None, *, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dev = resolve_device(device)
        h = cfg.hidden_size
        self.cfg = cfg
        self.attention_fn = attention_fn
        self.query = _linear(h, h, dev, dtype)
        self.key = _linear(h, h, dev, dtype)
        self.value = _linear(h, h, dev, dtype)
        self.output = _linear(h, h, dev, dtype)
        self.dropout = threefry.Dropout(cfg.attention_probs_dropout_prob)

    def forward(self, x, attn_bias, deterministic: bool = True,
                dropout_key=None, attention_seed=None):
        cfg = self.cfg
        b, s, h = x.shape
        nh = cfg.num_attention_heads
        q, k, v = (proj(x).view(b, s, nh, h // nh)
                   for proj in (self.query, self.key, self.value))
        dropout_fn = None
        if cfg.attention_probs_dropout_prob > 0 and not deterministic:
            dropout_fn = attention_dropout_fn(
                self.dropout, _scope(dropout_key),
                self.attention_fn is not None, attention_seed, x.device)
        attn = self.attention_fn or dot_product_attention
        ctx = attn(q, k, v, bias=attn_bias, dropout_fn=dropout_fn)
        return self.output(ctx.reshape(b, s, h))


def _dropout_scope(cfg, deterministic, dropout_key):
    """The scope a module's dropouts draw from, None when none is
    active (flax then draws nothing and needs no key)."""
    if deterministic or (cfg.hidden_dropout_prob == 0.0
                         and cfg.attention_probs_dropout_prob == 0.0):
        return None
    return _scope(dropout_key)


def _drop(module, x, scope, window=None):
    """``module`` (a ``threefry.Dropout``) on x, keyed by the next draw
    of ``scope``'s ``Dropout_0``; x as it is without a scope or at rate
    0 (flax draws nothing then).  ``window``: x is a sequence-parallel
    rank's slice of the dense activation (``threefry.window``)."""
    if scope is None or module.rate == 0.0:
        return x
    key = scope.push("Dropout_0").make_rng()
    return module(x, key) if window is None else module(x, key, window)


class BertLayer(nn.Module):
    """Post-LN: LN(x + drop(Attn(x))); LN(x + drop(MLP(x))), ``drop``
    one module (flax's ``Dropout_0`` of the layer) called twice."""

    def __init__(self, cfg: BertConfig,
                 attention_fn: Optional[Callable] = None, *, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.attention = BertSelfAttention(cfg, attention_fn, device=dev,
                                           dtype=dtype)
        self.attention_ln = _layer_norm(cfg, dev, dtype)
        self.intermediate = _linear(cfg.hidden_size, cfg.intermediate_size,
                                    dev, dtype)
        self.output = _linear(cfg.intermediate_size, cfg.hidden_size, dev,
                              dtype)
        self.output_ln = _layer_norm(cfg, dev, dtype)
        self.drop = threefry.Dropout(cfg.hidden_dropout_prob)

    def forward(self, x, attn_bias, deterministic: bool = True,
                dropout_key=None, attention_seed=None, drop_window=None):
        """``drop_window``: x is a sequence-parallel rank's slice of the
        dense activation (``threefry.window``)."""
        scope = _dropout_scope(self.cfg, deterministic, dropout_key)
        attn_out = self.attention(
            x, attn_bias, deterministic,
            None if scope is None else scope.push("attention"),
            attention_seed)
        x = self.attention_ln(x + _drop(self.drop, attn_out, scope,
                                        drop_window))
        y = self.output(F.gelu(self.intermediate(x)))   # exact erf gelu
        return self.output_ln(x + _drop(self.drop, y, scope, drop_window))


class BertEncoder(nn.Module):
    """input_ids/token_type_ids (B, S) int, attention_mask (B, S) {0,1}
    -> sequence output (B, S, H).  Embedding sum + LN + dropout
    (``_embed_block``), then the layers, named ``layer_<i>``.  ``sp``
    (a sequence group): the inputs are this rank's S_local tokens
    (module docstring)."""

    def __init__(self, cfg: BertConfig,
                 attention_fn: Optional[Callable] = None, *, device="cuda",
                 dtype: torch.dtype = torch.float32, sp=None):
        super().__init__()
        dev = resolve_device(device)
        h = cfg.hidden_size
        self.cfg = cfg
        if sp is not None and attention_fn is None:
            raise ValueError("a sequence-parallel BERT takes a "
                             "sequence-parallel attention_fn "
                             "(parallel.make_ring_attention or "
                             "make_ulysses_attention)")
        self.sp = sp
        self.attention_fn = attention_fn
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h, device=dev,
                                            dtype=dtype)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, h, device=dev, dtype=dtype)
        self.token_type_embeddings = nn.Embedding(
            cfg.type_vocab_size, h, device=dev, dtype=dtype)
        self.embeddings_ln = _layer_norm(cfg, dev, dtype)
        self.embeddings_dropout = threefry.Dropout(cfg.hidden_dropout_prob)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer_{i}", BertLayer(
                cfg, attention_fn, device=dev, dtype=dtype))

    def _embed_block(self, input_ids, token_type_ids, scope, offset=0,
                     window=None):
        s = input_ids.shape[1]
        pos = offset + torch.arange(s, device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        # the type rows as a one-hot product, not a gather: every token of
        # a type adds into one row, and the gather's backward on the card
        # sums such a row in no fixed order (two runs differ in the last
        # bits); the product's backward is a GEMM, the same bits each run
        types = self.token_type_embeddings.weight
        x = self.embeddings_ln(self.word_embeddings(input_ids)
                               + self.position_embeddings(pos)
                               + F.one_hot(token_type_ids.long(),
                                           types.shape[0]).to(types.dtype)
                               @ types)
        return _drop(self.embeddings_dropout, x, scope, window)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                deterministic: bool = True, dropout_key=None):
        cfg = self.cfg
        n = cfg.num_hidden_layers
        scope = _dropout_scope(cfg, deterministic, dropout_key)
        offset, window = 0, None
        if self.sp is not None and dist.is_initialized():
            b, s = input_ids.shape
            offset = self.sp.rank() * s
            window = threefry.window((b, s * self.sp.size(),
                                      cfg.hidden_size), 1, offset, s)
        x = self._embed_block(input_ids, token_type_ids, scope, offset,
                              window)
        attn_bias = None
        if attention_mask is not None:
            attn_bias = torch.where(attention_mask[:, None, None, :] > 0,
                                    0.0, -1e9).float()
        scopes = [None if scope is None else scope.push(f"layer_{i}")
                  for i in range(n)]
        seeds = [None] * n
        if scope is not None and self.attention_fn is not None \
                and cfg.attention_probs_dropout_prob > 0:
            # every layer's attention seed in one copy to the device
            seeds = threefry.attention_seeds(
                [sc.push("attention") for sc in scopes], x.device)
        remat = cfg.remat and torch.is_grad_enabled()
        for i in range(n):
            layer = getattr(self, f"layer_{i}")
            if remat:
                x = remat_layer(layer, scopes[i], x, attn_bias,
                                deterministic, attention_seed=seeds[i],
                                drop_window=window)
            else:
                x = layer(x, attn_bias, deterministic, scopes[i], seeds[i],
                          drop_window=window)
        return x


class BertForPreTraining(nn.Module):
    """Encoder + MLM head (transform, gelu, LN, untied decoder) + NSP
    head (tanh pooler over ``[CLS]``); returns fp32 ``(mlm_logits,
    nsp_logits)``.

    ``device`` defaults to ``"cuda"`` and raises without CUDA unless
    ``device="cpu"`` is passed.  ``seed`` initialises the weights with
    the JAX model's distributions (normal(initializer_range) for
    embeddings and kernels, zero biases, unit LN scales) from a CPU
    ``torch.Generator``, the same weights on any device; ``seed=None``
    leaves PyTorch's init for callers that load a state dict.  ``sp``
    (a sequence group) builds a sequence-parallel rank's model (module
    docstring)."""

    def __init__(self, cfg: BertConfig,
                 attention_fn: Optional[Callable] = None, *, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 seed: Optional[int] = 0, sp=None):
        super().__init__()
        dev = resolve_device(device)
        h = cfg.hidden_size
        self.cfg = cfg
        self.encoder = BertEncoder(cfg, attention_fn, device=dev,
                                   dtype=dtype, sp=sp)
        self.mlm_transform = _linear(h, h, dev, dtype)
        self.mlm_ln = _layer_norm(cfg, dev, dtype)
        self.mlm_decoder = _linear(h, cfg.vocab_size, dev, dtype)
        self.pooler = _linear(h, h, dev, dtype)
        self.nsp_classifier = _linear(h, 2, dev, dtype)
        if seed is not None:
            self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(int(seed))
        std = self.cfg.initializer_range
        for name, p in self.named_parameters():
            if name.endswith("_ln.scale"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.copy_(torch.empty(p.shape, dtype=torch.float32)
                        .normal_(0.0, std, generator=gen))

    def _pretraining_heads(self, seq):
        h = self.mlm_ln(F.gelu(self.mlm_transform(seq)))
        mlm_logits = self.mlm_decoder(h).float()
        cls = torch.tanh(self.pooler(seq[:, 0]))
        nsp_logits = self.nsp_classifier(cls).float()
        return mlm_logits, nsp_logits

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                deterministic: bool = True, dropout_key=None):
        """``dropout_key``: the key the JAX model takes as
        ``rngs={"dropout": key}``; needed when ``deterministic`` is False
        and a dropout rate is above 0."""
        scope = _dropout_scope(self.cfg, deterministic, dropout_key)
        seq = self.encoder(input_ids, attention_mask, token_type_ids,
                           deterministic,
                           None if scope is None else scope.push("encoder"))
        return self._pretraining_heads(seq)


def params_from_jax(params: Mapping, cfg: BertConfig
                    ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``BertForPreTraining`` param tree
    (``{"params": ...}`` or its inner dict, leaves as arrays) as this
    model's ``state_dict`` — and equally a gradient tree of the same
    shape.  DenseGeneral q/k/v kernels (h, nh, hd) and the output kernel
    (nh, hd, h) flatten to (h, h) and transpose into ``nn.Linear``'s
    (out, in) layout; Dense kernels (in, out) transpose; embeddings and
    LN scale/bias carry over as they are."""
    p = params.get("params", params)
    h = cfg.hidden_size

    def t(a, shape=None):
        a = np.array(a)  # a writable copy
        if shape is not None:
            a = a.reshape(shape)
        return torch.from_numpy(np.ascontiguousarray(a))

    def dense(sd, name, leaf):
        sd[f"{name}.weight"] = t(np.asarray(leaf["kernel"]).T)
        sd[f"{name}.bias"] = t(leaf["bias"])

    def ln(sd, name, leaf):
        sd[f"{name}.scale"] = t(leaf["scale"])
        sd[f"{name}.bias"] = t(leaf["bias"])

    enc = p["encoder"]
    sd = {}
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        sd[f"encoder.{name}.weight"] = t(enc[name]["embedding"])
    ln(sd, "encoder.embeddings_ln", enc["embeddings_ln"])
    for i in range(cfg.num_hidden_layers):
        lay, pre = enc[f"layer_{i}"], f"encoder.layer_{i}."
        att = lay["attention"]
        for name in ("query", "key", "value"):
            sd[f"{pre}attention.{name}.weight"] = t(
                np.asarray(att[name]["kernel"]).reshape(h, h).T)
            sd[f"{pre}attention.{name}.bias"] = t(att[name]["bias"], (h,))
        sd[f"{pre}attention.output.weight"] = t(
            np.asarray(att["output"]["kernel"]).reshape(h, h).T)
        sd[f"{pre}attention.output.bias"] = t(att["output"]["bias"])
        ln(sd, f"{pre}attention_ln", lay["attention_ln"])
        dense(sd, f"{pre}intermediate", lay["intermediate"])
        dense(sd, f"{pre}output", lay["output"])
        ln(sd, f"{pre}output_ln", lay["output_ln"])
    for name in ("mlm_transform", "mlm_decoder", "pooler", "nsp_classifier"):
        dense(sd, name, p[name])
    ln(sd, "mlm_ln", p["mlm_ln"])
    return sd

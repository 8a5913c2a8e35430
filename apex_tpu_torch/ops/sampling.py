"""On-device sampling primitives for the serving engine.

Twin of ``apex_tpu/ops/sampling.py`` (the vocab-parallel samplers of
``ops/vocab_parallel.py`` come with tensor-parallel serving):

- the GREEDY primitives (:func:`greedy_argmax` / :func:`finite_rows`),
  bit for bit the host's ``np.argmax`` (lowest id among ties);
- the STOCHASTIC suite (:class:`SamplingParams` / :func:`sample_tokens`):
  temperature, top-k and top-p with per-request counter-keyed noise.

The token sampled at sequence position ``i`` of a request is a pure
function of ``(seed, i, logits)``: the key is
``fold_in(fold_in(PRNGKey(seed), i), SALT_SAMPLE)`` on JAX's threefry
stream (``ops.threefry``'s row-batched functions) and the draw is
Gumbel-max over the processed logits.  So a replay, a
preempted-then-resumed request and the same request in another batch
sample the same tokens.  The uniform bits equal ``jax.random``'s; the
Gumbel transform's two logs may round an ulp apart from XLA's, so
against the JAX package a token can differ only where the top two of
``processed_logits + noise`` are that close.

Plain PyTorch, as the reference's sampler is plain ``jnp``; it does no
matmul, so TF32 never touches it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.ops import threefry

__all__ = ["SALT_SAMPLE", "SamplingParams", "finite_rows", "greedy_argmax",
           "processed_logits", "sample_tokens", "sample_tokens_host",
           "sampling_noise"]

# counter-key salt of the categorical draw (the reference's)
SALT_SAMPLE = 0

# the temperature floor substituted on GREEDY rows only, so the
# stochastic lane's division never makes inf/NaN; greedy rows discard it
_TEMP_FLOOR = 1e-6


def greedy_argmax(logits: torch.Tensor) -> torch.Tensor:
    """(…, V) logits -> (…,) int32 argmax token ids, on the logits'
    device.

    The FIRST maximum wins (``np.argmax``'s rule), by construction:
    max, then equality, then the minimum index among the maxima — the
    reference's decomposition, which does not depend on how a backend's
    fused argmax breaks ties.  A row whose max is NaN matches nothing and
    clamps to the last id; :func:`finite_rows` flags such rows."""
    v = logits.shape[-1]
    m = logits.amax(dim=-1, keepdim=True)
    iota = torch.arange(v, device=logits.device, dtype=torch.int32)
    idx = torch.where(logits == m, iota, torch.full_like(iota, v))
    return idx.amin(dim=-1).clamp_max(v - 1).to(torch.int32)


def finite_rows(logits: torch.Tensor) -> torch.Tensor:
    """(…, V) logits -> (…,) bool: True where every entry of the row is
    finite."""
    return torch.isfinite(logits).all(dim=-1)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs.  The default instance is GREEDY:
    bit for bit the argmax path.

    Args:
      temperature: softmax temperature; ``0.0`` (default) is greedy
        argmax, whatever ``top_k``/``top_p`` say.
      top_k: keep the ``top_k`` highest tokens (None = no filter); ties
        at the k-th value are all kept (a value threshold).
      top_p: nucleus: keep the smallest set of highest tokens whose
        cumulative probability reaches ``top_p`` (the crossing token is
        kept, and ties at its value); ``1.0`` (default) keeps all.
        Applied to the temperature-scaled distribution, intersected with
        ``top_k``'s set.
      seed: the per-request seed; position ``i``'s token is a pure
        function of ``(seed, i, logits)``.  Requests that want distinct
        streams carry distinct seeds.

    Raises :class:`ValueError` for ``temperature < 0``, ``top_k < 1``
    or ``top_p`` outside ``(0, 1]``, with the reference's messages.
    """

    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(
                f"temperature must be >= 0 (0 = greedy argmax), got "
                f"{self.temperature}")
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(
                f"top_k must be >= 1 (or None to disable), got "
                f"{self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(
                f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def is_greedy(self) -> bool:
        """True when this request takes the argmax path
        (``temperature == 0``)."""
        return self.temperature == 0.0

    @property
    def klass(self) -> str:
        """The traffic class for ``stats()["sampling"]``: ``greedy`` /
        ``temperature`` / ``top_k`` / ``top_p`` / ``top_k_top_p``."""
        if self.is_greedy:
            return "greedy"
        k, p = self.top_k is not None, self.top_p < 1.0
        if k and p:
            return "top_k_top_p"
        if k:
            return "top_k"
        if p:
            return "top_p"
        return "temperature"


def sampling_noise(seeds: torch.Tensor, positions: torch.Tensor,
                   vocab: int) -> torch.Tensor:
    """The per-position Gumbel noise: ``(…,)`` seeds and positions ->
    ``(…, vocab)`` float32 Gumbel(0, 1) draws, each row keyed
    ``fold_in(fold_in(PRNGKey(seed), position), SALT_SAMPLE)``; one
    call draws every row."""
    shape = tuple(seeds.shape)
    keys = threefry.key_rows(seeds.reshape(-1))
    keys = threefry.fold_in_rows(keys, positions.reshape(-1))
    keys = threefry.fold_in_rows(keys, SALT_SAMPLE)
    return threefry.gumbel_rows(keys, vocab).reshape(shape + (vocab,))


def processed_logits(logits: torch.Tensor, temperature: torch.Tensor,
                     top_k: torch.Tensor,
                     top_p: torch.Tensor) -> torch.Tensor:
    """Temperature-scale, then top-k/top-p-mask: ``(…, V)`` logits and
    ``(…,)`` params -> ``(…, V)`` float32, dropped tokens at ``-inf``.
    The mask is a VALUE threshold (the k-th sorted value and the nucleus
    boundary's, whichever is higher), so ties at either boundary are all
    kept whatever the sort's stability.  ``top_k <= 0`` disables top-k;
    ``top_p >= 1`` disables the nucleus."""
    v = logits.shape[-1]
    t = torch.clamp_min(temperature.float(), _TEMP_FLOOR)[..., None]
    scaled = logits.float() / t
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(top_k <= 0, v, top_k).clamp(1, v).long()
    kth = torch.gather(sorted_desc, -1, (k - 1)[..., None])
    kth = torch.where((top_k <= 0)[..., None], -torch.inf, kth)
    # nucleus boundary: counting the sorted positions whose INCLUSIVE
    # cumulative probability is still below top_p lands on the first one
    # that reaches it, so the crossing token is kept
    e = torch.exp(sorted_desc - sorted_desc[..., :1])
    cum = torch.cumsum(e, dim=-1) / e.sum(dim=-1, keepdim=True)
    bnd = (cum < top_p.float()[..., None]).sum(dim=-1, keepdim=True)
    pth = torch.gather(sorted_desc, -1, bnd.clamp_max(v - 1))
    pth = torch.where((top_p >= 1.0)[..., None], -torch.inf, pth)
    thresh = torch.maximum(kth, pth)
    return torch.where(scaled >= thresh, scaled, -torch.inf)


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor,
                  seeds: torch.Tensor, positions: torch.Tensor):
    """The sampling suite: ``(…, V)`` logits and ``(…,)`` per-row params
    -> ``(ids (…,) int32, finite (…,) bool)``.

    Rows with ``temperature <= 0`` take :func:`greedy_argmax` of the RAW
    logits (bit for bit the argmax path, ties included); the others draw
    ``argmax(processed_logits + sampling_noise(seed, position))``
    (Gumbel-max: an exact sample of the masked softmax).  ``finite`` is
    :func:`finite_rows` of the raw logits for every row.

    ``positions`` is the SEQUENCE INDEX of the token being drawn: the
    prompt length for a prefill token, ``position + 1`` for a decode
    step, ``start + 1 + column`` for a verify row.  ``top_k = 0`` means
    no top-k filter."""
    greedy = temperature <= 0.0
    masked = processed_logits(logits, temperature, top_k, top_p)
    noise = sampling_noise(seeds, positions, logits.shape[-1])
    ids = torch.where(greedy, greedy_argmax(logits),
                      greedy_argmax(masked + noise))
    return ids.to(torch.int32), finite_rows(logits)


def sample_tokens_host(logits, temperature, top_k, top_p, seeds,
                       positions, device="cuda"):
    """:func:`sample_tokens` on array-likes (numpy arrays, lists or
    tensors), every argument moved to ``device``: the card unless the
    caller asks for the CPU.  A plain call, as the reference's jitted
    host entry is a cached compile of the same function."""
    dev = resolve_device(device)

    def t(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    return sample_tokens(t(logits, None), t(temperature, torch.float32),
                         t(top_k, torch.int32), t(top_p, torch.float32),
                         t(seeds, torch.int64), t(positions, torch.int64))

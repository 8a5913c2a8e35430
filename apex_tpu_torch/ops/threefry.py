"""JAX's threefry stream and flax's rng folding in plain PyTorch, and the
hidden-dropout kernel that draws from them.

BERT's dropout in ``apex_tpu`` draws every mask and every attention seed
from flax's ``dropout`` rng stream.  For the port to drop the positions
the JAX model drops, given the same key, it computes the same keys and
the same bits.  This module is a copy (not an import: the port imports
no JAX) of what that needs:

- from ``jax/_src/prng.py`` and ``jax/_src/random.py`` (JAX 0.9, with
  ``jax_threefry_partitionable=True``, its default, and 64-bit types
  off): the threefry-2x32 block (:func:`threefry2x32`), ``PRNGKey``,
  ``fold_in``, ``split``, 32-bit ``random_bits`` (the partitionable
  form: element i hashes the counter pair (i >> 32, i mod 2**32) and
  keeps the XOR of the two output words), ``uniform``, ``bernoulli``, a
  scalar int32 ``randint``, and the row-batched ``PRNGKey``, ``fold_in``,
  ``random_bits``, ``uniform`` and ``gumbel`` the sampler draws its
  noise with (``*_rows``: one key a row of an (N, 2) tensor);
- from ``flax/core/scope.py`` (flax 0.12): ``LazyRng``'s folding of a
  scope's path and a call count into the stream's key
  (``_fold_in_static``: SHA-1 of the strings, big-endian bytes of the
  ints, the first four digest bytes folded in), and the per-scope
  counter that ``make_rng`` advances (:class:`RngScope`).

A key is a pair of uint32 held as Python ints.  uint32 arithmetic runs
on Python ints (one key at a time, on the host) or on int64 tensors
(a block of counters), masked to 32 bits after each step; the same
:func:`threefry2x32` serves both.

:func:`dropout` is flax's ``nn.Dropout`` (``select(bernoulli(key, 1 -
rate, x.shape), x / (1 - rate), 0)``, the divisor in x's dtype as JAX
types a Python float against an array) as a ``torch.autograd.Function``:
on CUDA tensors the kernel ``csrc/threefry_dropout.cu`` (one pass: bits,
uniform, compare, divide), on CPU tensors :func:`dropout_plain`.
Dropout is linear in x, so its gradient is the same call on the
output's gradient with the same key; nothing is saved but the key.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
from typing import Iterable, List, Sequence, Tuple

import torch
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch._kernels.build import (
    Kernel,
    check_dtype,
    plain_path,
    stream_handle,
)

Key = Tuple[int, int]

M32 = 0xFFFFFFFF
INT32_MAX = 2 ** 31 - 1
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def as_key(key) -> Key:
    """``key`` (a pair of integers: a tuple, or a numpy uint32 array such
    as ``np.asarray(jax.random.PRNGKey(0))``) as a tuple of two Python
    ints in [0, 2**32)."""
    k = [int(x) & M32 for x in key]
    if len(k) != 2:
        raise ValueError(f"a threefry key is two uint32 values; got {key!r}")
    return k[0], k[1]


# -- jax/_src/prng.py --------------------------------------------------------

def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(key: Key, x0, x1):
    """The threefry-2x32 block (20 rounds) of ``key`` over the counter
    words ``x0``, ``x1`` (Python ints or int64 tensors in [0, 2**32)):
    ``prng._threefry2x32_lowering``.  Returns the two output words."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: the seed
    becomes an int32, so the key is ``(0, seed mod 2**32)``."""
    return 0, int(seed) & M32


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in``: the block of ``key`` over the counter
    pair ``(0, data mod 2**32)``."""
    return threefry2x32(key, 0, int(data) & M32)


def split(key: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(key, num)`` (the fold-like split of the
    partitionable mode): key i is the block over the counter pair
    ``(0, i)``."""
    return [threefry2x32(key, 0, i) for i in range(num)]


def _counters(shape: Sequence[int], device):
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    return i >> 32, i & M32


def random_bits(key: Key, shape: Sequence[int] = (), device="cuda"):
    """``jax.random.bits(key, shape, uint32)``: element i (in row-major
    order) is the XOR of the two words of the block over (i >> 32,
    i mod 2**32); int64 tensor of ``shape`` holding the uint32 values,
    on the card unless the caller asks for the CPU."""
    shape = tuple(shape)
    hi, lo = _counters(shape, resolve_device(device))
    y0, y1 = threefry2x32(key, hi, lo)
    return (y0 ^ y1).reshape(shape)


def uniform(key: Key, shape: Sequence[int] = (), device="cuda"):
    """``jax.random.uniform(key, shape)``: float32 in [0, 1) from the top
    23 bits, as a float in [1, 2) minus 1."""
    bits = random_bits(key, shape, device)
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key: Key, p: float, shape: Sequence[int] = (),
              device="cuda"):
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p`` with p
    rounded to float32."""
    device = resolve_device(device)
    return uniform(key, shape, device) < torch.tensor(
        p, dtype=torch.float32, device=device)


# -- row-batched keys ---------------------------------------------------------
# A batch of keys is an (N, 2) int64 tensor of uint32 words.  The same
# block function runs on every row at once, so one call draws every
# row's vector, as the reference vmaps ``PRNGKey``/``fold_in``/``gumbel``
# over its rows (``apex_tpu/ops/sampling.py::_row_keys``).

def key_rows(seeds: torch.Tensor) -> torch.Tensor:
    """``vmap(PRNGKey)`` over (N,) integer seeds: (N, 2) int64 keys
    ``(0, seed mod 2**32)``, on the seeds' device."""
    s = seeds.long() & M32
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in_rows(keys: torch.Tensor, data) -> torch.Tensor:
    """``vmap(fold_in)``: (N, 2) keys and (N,) integer data (or one
    int for every row) -> (N, 2) keys, the block of each key over
    ``(0, data mod 2**32)``."""
    if isinstance(data, torch.Tensor):
        data = data.long() & M32
    else:
        data = int(data) & M32
    y0, y1 = threefry2x32((keys[:, 0], keys[:, 1]), 0, data)
    return torch.stack([y0, y1], dim=-1)


def random_bits_rows(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``vmap(bits(key, (n,), uint32))``: (N, 2) keys -> (N, n) int64
    holding each row's uint32 stream (:func:`random_bits`'s counters)."""
    hi, lo = _counters((n,), keys.device)
    y0, y1 = threefry2x32((keys[:, :1], keys[:, 1:]), hi[None], lo[None])
    return y0 ^ y1


def uniform_rows(keys: torch.Tensor, n: int, minval: float = 0.0,
                 maxval: float = 1.0) -> torch.Tensor:
    """``vmap(uniform(key, (n,), float32, minval, maxval))``: (N, n)
    float32.  The float in [0, 1) from the top 23 bits times ``maxval -
    minval`` (rounded to float32) plus ``minval``, rounded once (XLA
    fuses the two into a multiply-add; the float32 product is exact in
    float64), floored at ``minval``, as ``random._uniform`` does."""
    bits = random_bits_rows(keys, n)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0
    # filled on the device: a tensor built from a Python float would be
    # copied from the host and wait on the stream
    lo = torch.full((), minval, dtype=torch.float32, device=keys.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=keys.device)
    scaled = floats.double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, scaled.float())


def gumbel_rows(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``vmap(gumbel(key, (n,), float32))`` in JAX 0.9's default
    ``mode="low"``: ``-log(-log(uniform(key, minval=tiny, maxval=1)))``,
    (N, n) float32.  The bits are integer work and equal JAX's; the two
    logs may round an ulp apart from XLA's."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform_rows(keys, n, tiny, 1.0)))


def _bits_scalar(key: Key) -> int:
    y0, y1 = threefry2x32(key, 0, 0)
    return y0 ^ y1


def randint(key: Key, minval: int, maxval: int) -> int:
    """``jax.random.randint(key, (), minval, maxval, int32)`` as a Python
    int, on the host: two 32-bit draws from ``split(key)`` reduced into
    [minval, maxval) as ``random._randint`` does (the span, the
    multiplier 2**32 mod span, then ``(hi mod span) * multiplier + lo
    mod span`` mod span, wrapping at 2**32); int32 bounds only."""
    if not (-2 ** 31 <= minval <= INT32_MAX
            and -2 ** 31 <= maxval <= INT32_MAX):
        raise ValueError("randint takes int32 bounds")
    k1, k2 = split(key)
    hi, lo = _bits_scalar(k1), _bits_scalar(k2)
    span = 1 if maxval <= minval else maxval - minval
    mult = (2 ** 16) % span
    mult = ((mult * mult) & M32) % span
    off = ((((hi % span) * mult) & M32) + lo % span) & M32
    out = (minval + off % span) & M32
    return out - (1 << 32) if out > INT32_MAX else out


# -- flax/core/scope.py ------------------------------------------------------

def fold_in_static(key: Key, data: Iterable) -> Key:
    """flax's ``_fold_in_static``: the SHA-1 of the path strings (UTF-8)
    and ints (big-endian, fewest bytes), in order and without
    separators, then ``fold_in`` of its first four bytes (big-endian)."""
    data = tuple(data)
    if not data:
        return key
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise TypeError(f"expected a str or an int, got {x!r}")
    return fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))


class RngScope:
    """One flax scope's view of an rng stream: the stream's root key,
    the scope's module path, and the call counters of every scope of the
    same tree (shared, keyed by path).  :meth:`push` is ``Scope.push``
    (a child named ``name``); :meth:`make_rng` is ``Scope.make_rng``:
    the scope's counter advances by one and the key is the root key with
    ``(*path, count)`` folded in, as ``LazyRng.as_jax_rng`` does.
    :meth:`fork` copies the counters: a function that runs twice on one
    input (a block rematerialised by ``torch.utils.checkpoint``) runs
    each time on a fork of the same snapshot and draws the same keys, as
    flax's ``nn.remat`` replays the same rngs."""

    def __init__(self, key, path: Tuple[str, ...] = (), counters=None):
        self.key = as_key(key)
        self.path = tuple(path)
        self._counters = {} if counters is None else counters

    @classmethod
    def of(cls, key_or_scope) -> "RngScope":
        """A scope as it is, or the root scope of a key."""
        if isinstance(key_or_scope, RngScope):
            return key_or_scope
        return cls(key_or_scope)

    def push(self, name: str) -> "RngScope":
        return RngScope(self.key, self.path + (name,), self._counters)

    def fork(self) -> "RngScope":
        """This scope with its own copy of the counters as they stand."""
        return RngScope(self.key, self.path, dict(self._counters))

    def make_rng(self) -> Key:
        n = self._counters.get(self.path, 0) + 1
        self._counters[self.path] = n
        return fold_in_static(self.key, self.path + (n,))


def attention_seeds(scopes: Sequence[RngScope], device) -> torch.Tensor:
    """``randint(scope.make_rng(), (), 0, int32 max)`` for each scope (a
    BERT attention layer's per-call seed), drawn on the host and placed
    on ``device`` as one (n,) int32 tensor: on the card by one
    ``non_blocking`` copy from pinned memory, so nothing syncs."""
    host = torch.tensor([randint(s.make_rng(), 0, INT32_MAX)
                         for s in scopes], dtype=torch.int32)
    device = torch.device(device)
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


# -- dropout -----------------------------------------------------------------

_P = ctypes.c_void_p
KERNEL = Kernel("threefry_dropout", "apex_threefry_dropout",
                [_P, _P, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32,
                 ctypes.c_float, ctypes.c_float, ctypes.c_int64,
                 ctypes.c_int64, ctypes.c_int64, ctypes.c_int, _P])


@functools.lru_cache(maxsize=None)
def _divisor_value(keep_prob: float, dtype: torch.dtype) -> float:
    """``keep_prob`` rounded to ``dtype`` (where JAX puts a Python float
    divisor), as a float."""
    return float(torch.tensor(keep_prob, dtype=dtype))


def window(full_shape: Sequence[int], dim: int, start: int,
           length: int) -> Tuple[int, int, int]:
    """``(row, row_stride, base)``: where the slice ``[start, start +
    length)`` along ``dim`` of a tensor of ``full_shape`` lies in its
    row-major stream of counters: rows of ``row`` counters,
    ``row_stride`` apart, from ``base`` (what the dropout kernel and
    :func:`dropout_plain` take as ``window``)."""
    inner = math.prod(full_shape[dim + 1:])
    return length * inner, full_shape[dim] * inner, start * inner


def _window_counters(n: int, win, device):
    i = torch.arange(n, dtype=torch.int64, device=device)
    if win is not None:
        row, row_stride, base = win
        i = base + torch.div(i, row, rounding_mode="floor") * row_stride \
            + i % row
    return i >> 32, i & M32


def dropout_plain(x: torch.Tensor, rate: float, key,
                  window=None) -> torch.Tensor:
    """Plain PyTorch version of the dropout kernel, flax's
    ``nn.Dropout.__call__``: ``where(bernoulli(key, 1 - rate, x.shape),
    x / (1 - rate), 0)``, the divisor a 0-d tensor of x's dtype (a true
    division, as the kernel's).  ``window`` (:func:`window`): x is that
    slice of a larger tensor and draws what the larger tensor's call
    draws there.  Differentiable by PyTorch's autograd."""
    keep_prob = 1.0 - rate
    hi, lo = _window_counters(x.numel(), window, x.device)
    y0, y1 = threefry2x32(as_key(key), hi, lo)
    bits = (y0 ^ y1).reshape(x.shape)
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    keep = u < torch.tensor(keep_prob, dtype=torch.float32, device=x.device)
    div = torch.full((), keep_prob, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / div, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))


def _dropout_cuda(x: torch.Tensor, rate: float, key: Key,
                  window=None) -> torch.Tensor:
    code = check_dtype("dropout", x)
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel():
        keep_prob = 1.0 - rate
        row, row_stride, base = window or (x.numel(), 0, 0)
        KERNEL.launch(x.data_ptr(), y.data_ptr(), x.numel(), key[0], key[1],
                      keep_prob, _divisor_value(keep_prob, x.dtype), row,
                      row_stride, base, code, stream_handle(x.device))
    return y


def _dropout_apply(x, rate, key, window=None):
    if plain_path(x):
        return dropout_plain(x, rate, key, window)
    return _dropout_cuda(x, rate, key, window)


class _DropoutFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, rate, key, window):
        ctx.rate, ctx.key, ctx.window = rate, key, window
        return _dropout_apply(x, rate, key, window)

    @staticmethod
    def backward(ctx, dy):
        return _dropout_apply(dy, ctx.rate, ctx.key, ctx.window), None, \
            None, None


def dropout(x: torch.Tensor, rate: float, key, window=None) -> torch.Tensor:
    """flax's ``nn.Dropout`` on ``key``: ``x / (1 - rate)`` where
    ``bernoulli(key, 1 - rate, x.shape)`` keeps, else 0, in x's dtype.
    Rate 0 returns x and rate 1 zeros, drawing nothing, as flax does.
    ``window`` (:func:`window`): x is a slice of a larger tensor and is
    dropped as that tensor's call drops it there (a sequence-parallel
    rank's tokens).  The kernel for CUDA tensors (float32 or bfloat16),
    the plain version for CPU tensors; differentiable in x."""
    rate = float(rate)
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    if window is not None and window[0] == x.numel() and window[2] == 0:
        window = None       # the slice is the whole stream's start
    return _DropoutFn.apply(x, rate, as_key(key),
                            None if window is None else tuple(window))


class Dropout(nn.Module):
    """``flax.linen.Dropout``'s twin as a module: ``forward(x, key)`` is
    :func:`dropout` at this module's rate (the caller derives ``key``
    from the module's flax scope)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, key, window=None):
        if window is None:
            return dropout(x, self.rate, key)
        return dropout(x, self.rate, key, window)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"

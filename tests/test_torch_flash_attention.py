"""apex_tpu_torch flash attention against apex_tpu's Pallas flash kernel.

The JAX side runs ``flash_attention(use_pallas=True, interpret=True)``
with 32-wide blocks, as ``tests/L0/test_flash_attention.py`` does, so
ragged lengths cross block edges; the port's CPU path is its plain
PyTorch version (no CUDA kernel launched).  Inputs come from
``numpy.random.RandomState``.  Scale-aware error max|a-b| / (max|b| + 1)
<= 1e-5 in fp32 for the output, the lse and the gradients dq, dk, dv
(``jax.vjp`` through the interpret-mode backward kernels against the
port's autograd function).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch._kernels import launch_counts
from apex_tpu_torch.ops import (
    bias_to_kv_mask,
    flash_attention,
    make_flash_attention,
)
from apex_tpu_torch.ops.flash_attention import NEG_INF

# the package re-exports a function of the same name as this module
jax_fa = importlib.import_module("apex_tpu.ops.flash_attention")

torch.set_num_threads(1)

TOL = 1e-5


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def _inputs(b, sq, sk, h, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, h, d).astype(np.float32)
    k = rng.randn(b, sk, h, d).astype(np.float32)
    v = rng.randn(b, sk, h, d).astype(np.float32)
    return q, k, v


def _jax(q, k, v, mask, causal):
    return jax_fa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_mask=None if mask is None else jnp.asarray(mask), causal=causal,
        use_pallas=True, interpret=True, block_q=32, block_k=32,
        return_lse=True)


def _port(q, k, v, mask, causal):
    before = launch_counts()
    out = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_mask=None if mask is None else torch.from_numpy(mask),
        causal=causal, return_lse=True)
    assert launch_counts() == before, "the CPU path launched a kernel"
    return out


@pytest.mark.parametrize("s", [32, 33, 70])   # exact, ragged, multi-block
@pytest.mark.parametrize("causal", [False, True])
def test_matches_jax_kernel_with_padding_mask(s, causal):
    q, k, v = _inputs(2, s, s, 2, 16, seed=s)
    mask = np.zeros((2, s), np.float32)
    mask[1, s - s // 3:] = -1e9          # the GPT padding mask's value
    jo, jlse = _jax(q, k, v, mask, causal)
    o, lse = _port(q, k, v, mask, causal)
    assert o.shape == (2, s, 2, 16) and lse.shape == (2, 2, s)
    assert rel_err(o.numpy(), jo) <= TOL
    assert rel_err(lse.numpy(), jlse) <= TOL


def test_fully_masked_row_gives_zeros_and_neg_inf_lse():
    q, k, v = _inputs(2, 40, 40, 2, 16, seed=1)
    mask = np.zeros((2, 40), np.float32)
    mask[0, :] = NEG_INF                 # batch row 0 sees no key at all
    jo, jlse = _jax(q, k, v, mask, False)
    o, lse = _port(q, k, v, mask, False)
    assert np.all(o[0].numpy() == 0.0) and np.all(np.asarray(jo)[0] == 0.0)
    assert np.all(lse[0].numpy() == NEG_INF)
    assert np.all(np.asarray(jlse)[0] == NEG_INF)
    assert rel_err(o[1].numpy(), np.asarray(jo)[1]) <= TOL
    assert rel_err(lse[1].numpy(), np.asarray(jlse)[1]) <= TOL


def test_cross_lengths_without_mask():
    q, k, v = _inputs(1, 24, 50, 3, 16, seed=2)
    jo, jlse = _jax(q, k, v, None, False)
    o, lse = _port(q, k, v, None, False)
    assert rel_err(o.numpy(), jo) <= TOL
    assert rel_err(lse.numpy(), jlse) <= TOL


def test_adapter_collapses_bias_and_matches_jax_adapter():
    q, k, v = _inputs(2, 20, 20, 2, 16, seed=3)
    bias = np.zeros((2, 1, 1, 20), np.float32)
    bias[0, ..., 15:] = -1e9
    want = jax_fa.make_flash_attention(causal=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias))
    got = make_flash_attention(causal=True)(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(bias))
    assert rel_err(got.numpy(), want) <= TOL
    assert bias_to_kv_mask(torch.from_numpy(bias)).shape == (2, 20)
    with pytest.raises(ValueError):
        bias_to_kv_mask(torch.zeros(2, 2, 1, 20))


def _grads(q, k, v, mask, causal, do, dlse=None):
    """(dq, dk, dv) from the JAX interpret kernels (``jax.vjp``) and from
    the port's autograd function; with ``dlse`` the lse output has a
    cotangent too."""
    kw = dict(kv_mask=None if mask is None else jnp.asarray(mask),
              causal=causal, use_pallas=True, interpret=True, block_q=32,
              block_k=32, return_lse=dlse is not None)
    _, vjp = jax.vjp(lambda q, k, v: jax_fa.flash_attention(q, k, v, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do) if dlse is None
               else (jnp.asarray(do), jnp.asarray(dlse)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = launch_counts()
    out = flash_attention(
        qt, kt, vt, kv_mask=None if mask is None else torch.from_numpy(mask),
        causal=causal, return_lse=dlse is not None)
    cot = (torch.from_numpy(do),) if dlse is None else \
        (torch.from_numpy(do), torch.from_numpy(dlse))
    got = torch.autograd.grad(out if dlse is not None else (out,),
                              (qt, kt, vt), cot)
    assert launch_counts() == before, "the CPU path launched a kernel"
    return got, want


@pytest.mark.parametrize("s", [32, 33, 70])   # exact, ragged, multi-block
@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_jax_kernel_with_padding_mask(s, causal):
    q, k, v = _inputs(2, s, s, 2, 16, seed=s + 1)
    do = np.random.RandomState(s + 2).randn(2, s, 2, 16).astype(np.float32)
    mask = np.zeros((2, s), np.float32)
    mask[1, s - s // 3:] = -1e9
    got, want = _grads(q, k, v, mask, causal, do)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert rel_err(g.numpy(), w) <= TOL


def test_grads_through_lse_match_jax_kernel():
    q, k, v = _inputs(2, 45, 45, 2, 16, seed=11)
    rng = np.random.RandomState(12)
    do = rng.randn(2, 45, 2, 16).astype(np.float32)
    dlse = rng.randn(2, 2, 45).astype(np.float32)
    got, want = _grads(q, k, v, None, True, do, dlse)
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), w) <= TOL


def test_grads_cross_lengths_without_mask():
    q, k, v = _inputs(1, 24, 50, 3, 16, seed=13)
    do = np.random.RandomState(14).randn(1, 24, 3, 16).astype(np.float32)
    got, want = _grads(q, k, v, None, False, do)
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), w) <= TOL


def test_grads_of_fully_masked_rows_are_zero():
    q, k, v = _inputs(2, 40, 40, 2, 16, seed=15)
    do = np.random.RandomState(16).randn(2, 40, 2, 16).astype(np.float32)
    mask = np.zeros((2, 40), np.float32)
    mask[0, :] = NEG_INF                 # batch row 0 sees no key at all
    got, want = _grads(q, k, v, mask, False, do)
    for g, w in zip(got, want):
        assert np.all(g[0].numpy() == 0.0) and np.all(np.asarray(w)[0] == 0)
        assert rel_err(g[1].numpy(), np.asarray(w)[1]) <= TOL


def test_dropout_is_refused():
    """Dropout is refused where the JAX package refuses it: a rate
    without a seed, and a dropout closure without the (rate, seed)
    annotation the fused kernels consume (``test_torch_flash_dropout``
    covers dropout itself)."""
    q, k, v = (torch.zeros(1, 4, 1, 16) for _ in range(3))
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention(q, k, v, dropout_rate=0.1)
    with pytest.raises(NotImplementedError, match="annotation"):
        make_flash_attention(causal=True)(q, k, v, None, lambda p: p)


def _bf16_view(shape, strides, offset=0, dtype=torch.bfloat16):
    """A (B, S, H, D) view with the given element strides, ``offset``
    elements into a fresh buffer."""
    n = offset + 1 + sum((s - 1) * st for s, st in zip(shape, strides))
    return torch.zeros(n, dtype=dtype).as_strided(shape, strides, offset)


@pytest.mark.parametrize("case,copied", [
    ("contiguous", False),
    ("qkv_unbind", False),        # (B, S, 3, H, D).unbind(2), k's leg
    ("base_off_2_bytes", True),   # base one element past a 16-byte line
    ("seq_stride_196", True),     # s stride 392 bytes
    ("head_stride_68", True),     # h stride 136 bytes
    ("batch_of_one", False),      # B = 1: its odd stride never multiplies
    ("float32", False),           # the fp32 kernels read any stride
])
def test_kernel_operand_copies_bf16_only_where_the_16_byte_rule_fails(
        case, copied):
    """The flash wrappers' operand preparation on CPU tensors with the
    strides the card would see: a bf16 operand whose base or (b, s, h)
    strides (over dims longer than 1) are not multiples of 16 bytes is
    copied into new contiguous memory; every other operand is passed as
    it lies."""
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    t = {
        "contiguous": lambda: torch.zeros(2, 5, 3, 64, dtype=torch.bfloat16),
        "qkv_unbind": lambda: torch.zeros(
            2, 5, 3, 4, 64, dtype=torch.bfloat16).unbind(2)[1],
        "base_off_2_bytes": lambda: _bf16_view((2, 5, 3, 64),
                                               (960, 192, 64, 1), 1),
        "seq_stride_196": lambda: _bf16_view((2, 5, 3, 64),
                                             (980, 196, 64, 1)),
        "head_stride_68": lambda: _bf16_view((2, 5, 3, 64),
                                             (1020, 204, 68, 1)),
        "batch_of_one": lambda: _bf16_view((1, 5, 3, 64), (7, 192, 64, 1)),
        "float32": lambda: _bf16_view((2, 5, 3, 64), (980, 196, 64, 1),
                                      1, torch.float32),
    }[case]()
    torch.manual_seed(0)
    t.copy_(torch.randn(t.shape))
    out = fa._kernel_operand(t)
    assert (out is not t) == copied
    assert fa._meets_16_byte_rule(out) or out.dtype == torch.float32
    if copied:
        assert out.is_contiguous() and out.data_ptr() != t.data_ptr()
        assert torch.equal(out, t)

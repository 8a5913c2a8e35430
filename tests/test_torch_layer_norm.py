"""apex_tpu_torch LayerNorm against apex_tpu's Pallas LayerNorm kernel.

The JAX side runs the kernel in interpret mode (``use_pallas=True`` off
the TPU), as ``tests/L0/test_fused_layer_norm.py`` does; the port's CPU
path is its plain PyTorch version, and every test checks that no CUDA
kernel was launched.  Inputs come from ``numpy.random.RandomState``.
Error is scale-aware, max|a-b| / (max|b| + 1) (``tools/kernel_parity.py``):
<= 1e-5 in fp32 (both sides compute the same two-pass fp32 statistics),
<= 2e-2 in bf16 (outputs rounded to bf16 on both sides may differ by an
ulp).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.normalization import FusedLayerNorm as JaxFusedLayerNorm
from apex_tpu_torch._kernels import launch_counts
from apex_tpu_torch.normalization import (
    FusedLayerNorm,
    fused_layer_norm,
    fused_layer_norm_affine,
)

# the package re-exports a function of the same name as this module
jax_ln = importlib.import_module("apex_tpu.normalization.fused_layer_norm")

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def _to_np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,ns", [((8, 64), 64), ((4, 33), 33),
                                      ((5, 3, 100), 100),
                                      ((2, 3, 7), (3, 7)),
                                      # the paths' widths
                                      ((2, 5, 768), 768), ((3, 1024), 1024)])
def test_affine_matches_jax_kernel(shape, ns, dtype, wdtype):
    """y against the reference's forward, with fp32 weights and with bf16
    weights as amp O2 keeps LayerNorm's params (both sides widen them to
    fp32 for the affine step)."""
    rng = np.random.RandomState(len(shape) * 100 + shape[-1])
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    wshape = (ns,) if isinstance(ns, int) else ns
    w = (1 + 0.1 * rng.randn(*wshape)).astype(np.float32)
    b = (0.1 * rng.randn(*wshape)).astype(np.float32)
    want = jax_ln.fused_layer_norm_affine(
        jnp.asarray(x, dtype), jnp.asarray(w, wdtype),
        jnp.asarray(b, wdtype), ns, 1e-5, True)
    before = launch_counts()
    got = fused_layer_norm_affine(
        torch.from_numpy(x).to(getattr(torch, dtype)),
        torch.from_numpy(w).to(getattr(torch, wdtype)),
        torch.from_numpy(b).to(getattr(torch, wdtype)), ns, 1e-5)
    assert launch_counts() == before, "the CPU path launched a kernel"
    assert got.dtype == getattr(torch, dtype) and got.shape == shape
    assert rel_err(_to_np(got), want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_non_affine_matches_jax_kernel(dtype):
    x = np.random.RandomState(3).randn(6, 129).astype(np.float32)
    want = jax_ln.fused_layer_norm(jnp.asarray(x, dtype), 129, 1e-5, True)
    got = fused_layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                           129)
    assert rel_err(_to_np(got), want) <= TOL[dtype]


def test_module_matches_jax_module():
    x = np.random.RandomState(4).randn(4, 10, 64).astype(np.float32)
    jm = JaxFusedLayerNorm(64, use_pallas=True)
    variables = jm.init(__import__("jax").random.PRNGKey(0),
                        jnp.asarray(x))
    rng = np.random.RandomState(5)
    scale = (1 + 0.2 * rng.randn(64)).astype(np.float32)
    bias = (0.2 * rng.randn(64)).astype(np.float32)
    want = jm.apply({"params": {"scale": jnp.asarray(scale),
                                "bias": jnp.asarray(bias)}}, jnp.asarray(x))
    assert set(variables["params"]) == {"scale", "bias"}
    m = FusedLayerNorm(64, device="cpu")
    assert set(dict(m.named_parameters())) == {"scale", "bias"}
    m.load_state_dict({"scale": torch.from_numpy(scale),
                       "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    assert rel_err(_to_np(got), want) <= TOL["float32"]


def test_two_pass_variance_on_offset_rows():
    """A large common offset: E[x^2] - mean^2 cancels catastrophically in
    fp32, the two-pass variance of the TPU kernel does not."""
    rng = np.random.RandomState(6)
    x = (1e4 + rng.randn(3, 256)).astype(np.float32)
    got = fused_layer_norm(torch.from_numpy(x), 256).numpy()
    want = (x - x.astype(np.float64).mean(1, keepdims=True)) / np.sqrt(
        x.astype(np.float64).var(1, keepdims=True) + 1e-5)
    assert rel_err(got, want) <= 1e-3


def _t(a, dtype, grad=True):
    return torch.from_numpy(np.array(a)).to(getattr(torch, dtype)) \
        .requires_grad_(grad)


@pytest.mark.parametrize("dtype,wdtype", [("float32", "float32"),
                                          ("bfloat16", "float32"),
                                          ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("shape,ns", [((8, 64), 64), ((4, 33), 33),
                                      ((2, 3, 7), (3, 7)),
                                      # the paths' widths (GPT-2 small's
                                      # 768, BERT-large's 1024) and a
                                      # ragged one
                                      ((2, 5, 768), 768), ((9, 1024), 1024),
                                      ((6, 1001), 1001)])
def test_affine_grads_match_jax_kernel(shape, ns, dtype, wdtype):
    """dx (B3 and its plain version), dweight and dbias against
    ``jax.vjp`` through the interpret-mode kernels; every gradient comes
    back in its operand's dtype, as ``_fla_bwd`` casts them."""
    rng = np.random.RandomState(shape[-1] + 7)
    wshape = (ns,) if isinstance(ns, int) else ns
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.randn(*wshape)).astype(np.float32)
    b = (0.1 * rng.randn(*wshape)).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    _, vjp = jax.vjp(
        lambda x, w, b: jax_ln.fused_layer_norm_affine(x, w, b, ns, 1e-5,
                                                       True),
        jnp.asarray(x, dtype), jnp.asarray(w, wdtype), jnp.asarray(b, wdtype))
    want = vjp(jnp.asarray(dy, dtype))
    xt, wt, bt = _t(x, dtype), _t(w, wdtype), _t(b, wdtype)
    before = launch_counts()
    y = fused_layer_norm_affine(xt, wt, bt, ns, 1e-5)
    got = torch.autograd.grad(y, (xt, wt, bt), _t(dy, dtype, False))
    assert launch_counts() == before, "the CPU path launched a kernel"
    for g, t, jg in zip(got, (xt, wt, bt), want):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert rel_err(_to_np(g), jg) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_non_affine_grad_matches_jax_kernel(dtype):
    rng = np.random.RandomState(8)
    x = rng.randn(6, 129).astype(np.float32)
    dy = rng.randn(6, 129).astype(np.float32)
    _, vjp = jax.vjp(
        lambda x: jax_ln.fused_layer_norm(x, 129, 1e-5, True),
        jnp.asarray(x, dtype))
    (want,) = vjp(jnp.asarray(dy, dtype))
    xt = _t(x, dtype)
    (got,) = torch.autograd.grad(fused_layer_norm(xt, 129), xt,
                                 _t(dy, dtype, False))
    assert got.dtype == xt.dtype
    assert rel_err(_to_np(got), want) <= TOL[dtype]


def _fla_bwd_numpy(dy, x, mean, invvar, w):
    """The reference's ``_fla_bwd`` (apex_tpu/normalization/
    fused_layer_norm.py:226-236) in float64 numpy: dx from the gamma-scaled
    dy and xhat, dweight and dbias as column sums of dy * xhat and dy."""
    dy, x = dy.astype(np.float64), x.astype(np.float64)
    xhat = (x - mean[:, None]) * invvar[:, None]
    dyw = dy if w is None else dy * w[None, :]
    n2 = x.shape[1]
    dx = invvar[:, None] * (dyw - (dyw.sum(1, keepdims=True)
                                   + xhat * (dyw * xhat).sum(1, keepdims=True))
                            / n2)
    return dx, (dy * xhat).sum(0), dy.sum(0)


@pytest.mark.parametrize("n1,n2", [(16, 768), (8, 1024), (5, 1001), (3, 7)])
@pytest.mark.parametrize("affine", [True, False])
def test_backward_plain_matches_reference_formula(n1, n2, affine):
    """``_ln_backward_plain`` — the CPU path and the kernel's reference —
    returns (dx, dweight, dbias) as ``_fla_bwd`` forms them, None for
    the weight gradients without a weight; in float32 within 1e-5."""
    ln = importlib.import_module(
        "apex_tpu_torch.normalization.fused_layer_norm")
    rng = np.random.RandomState(n1 * n2)
    x = (rng.randn(n1, n2) * 2 + 0.5).astype(np.float32)
    dy = rng.randn(n1, n2).astype(np.float32)
    w = (1 + 0.1 * rng.randn(n2)).astype(np.float32) if affine else None
    _, mean, invvar = ln._ln_forward_plain(torch.from_numpy(x), 1e-5)
    got = ln.layer_norm_bwd(torch.from_numpy(dy), torch.from_numpy(x), mean,
                            invvar, None if w is None else torch.from_numpy(w))
    want = _fla_bwd_numpy(dy, x, mean.double().numpy(),
                          invvar.double().numpy(), w)
    assert rel_err(_to_np(got[0]), want[0]) <= TOL["float32"]
    if not affine:
        assert got[1] is None and got[2] is None
        return
    for g, jg in zip(got[1:], want[1:]):
        assert g.dtype == torch.float32 and g.shape == (n2,)
        assert rel_err(_to_np(g), jg) <= TOL["float32"]


def test_backward_plain_computes_only_what_is_asked():
    """No weight gradient asked for: (dx, None, None); no input gradient:
    (None, dweight, dbias) equal to the full call's."""
    ln = importlib.import_module(
        "apex_tpu_torch.normalization.fused_layer_norm")
    rng = np.random.RandomState(12)
    x, dy = (torch.from_numpy(rng.randn(6, 40).astype(np.float32))
             for _ in range(2))
    w = torch.from_numpy((1 + 0.1 * rng.randn(40)).astype(np.float32)) \
        .to(torch.bfloat16)
    _, mean, invvar = ln._ln_forward_plain(x, 1e-5)
    full = ln.layer_norm_bwd(dy, x, mean, invvar, w)
    assert full[1].dtype == torch.bfloat16 and full[2].dtype == torch.bfloat16
    dx, dw, db = ln.layer_norm_bwd(dy, x, mean, invvar, w, grad_weight=False)
    assert dw is None and db is None and torch.equal(dx, full[0])
    dx, dw, db = ln.layer_norm_bwd(dy, x, mean, invvar, w, grad_input=False)
    assert dx is None and torch.equal(dw, full[1]) and torch.equal(db,
                                                                   full[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n2,fast", [
    (768, True), (1024, True),           # the paths' widths
    (1000, True),                        # whole 16-byte chunks, <= 1024
    (7, False), (33, False), (1001, False),
    (1032, False),                       # wider than 32 elements a lane
])
def test_fast_path_choice(dtype, n2, fast):
    """``_fast_rows`` — which path the forward and the backward take —
    for whole aligned rows of each width, and the generic path for a
    view 4 bytes off the 16-byte grid (whatever its width)."""
    ln = importlib.import_module(
        "apex_tpu_torch.normalization.fused_layer_norm")
    x = torch.zeros(3, n2, dtype=dtype)
    w = torch.zeros(n2, dtype=dtype)
    assert ln._fast_rows(n2, x, torch.empty_like(x), w, w) is fast
    for wd in (torch.float32, torch.bfloat16):
        assert ln._fast_rows(n2, x, x, w.to(wd), w.to(wd)) is fast
    buf = torch.zeros(3 * n2 + 2, dtype=torch.float32).view(dtype)
    off = buf[16 // x.element_size() // 4:][:3 * n2].view(3, n2)
    assert off.data_ptr() % 16 != 0
    assert ln._fast_rows(n2, off, x, w, w) is False
    assert ln._fast_rows(n2, x, x, w, off[0]) is False


@pytest.mark.parametrize("dtype,fast", [(torch.float32, True),
                                        (torch.bfloat16, False)])
def test_fast_path_needs_whole_chunks_of_the_dtype(dtype, fast):
    """100 elements are 25 fp32 chunks of 16 bytes but 12.5 bf16 ones."""
    ln = importlib.import_module(
        "apex_tpu_torch.normalization.fused_layer_norm")
    assert ln._fast_rows(100, torch.zeros(2, 100, dtype=dtype)) is fast


def test_kernel_weight_operands():
    """The kernels read fp32 and bf16 weights as they are and any other
    dtype through an fp32 copy."""
    ln = importlib.import_module(
        "apex_tpu_torch.normalization.fused_layer_norm")
    for dt in (torch.float32, torch.bfloat16):
        w = torch.ones(16, dtype=dt)
        assert ln._kernel_weight(w) is w
    assert ln._kernel_weight(torch.ones(16, dtype=torch.float16)).dtype \
        == torch.float32
    strided = torch.ones(32)[::2]
    assert ln._kernel_weight(strided).is_contiguous()


def test_module_backward_reaches_its_params():
    m = FusedLayerNorm(16, device="cpu")
    x = torch.randn(3, 16, requires_grad=True)
    m(x).pow(2).sum().backward()
    assert x.grad is not None and m.scale.grad is not None \
        and m.bias.grad is not None


def test_shape_errors():
    with pytest.raises(ValueError):
        fused_layer_norm(torch.zeros(4, 8), 16)
    m = FusedLayerNorm(8, device="cpu")
    with pytest.raises(ValueError):
        m(torch.zeros(2, 9))

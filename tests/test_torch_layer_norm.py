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
@pytest.mark.parametrize("shape,ns", [((8, 64), 64), ((4, 33), 33),
                                      ((5, 3, 100), 100),
                                      ((2, 3, 7), (3, 7))])
def test_affine_matches_jax_kernel(shape, ns, dtype):
    rng = np.random.RandomState(len(shape) * 100 + shape[-1])
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    wshape = (ns,) if isinstance(ns, int) else ns
    w = (1 + 0.1 * rng.randn(*wshape)).astype(np.float32)
    b = (0.1 * rng.randn(*wshape)).astype(np.float32)
    want = jax_ln.fused_layer_norm_affine(
        jnp.asarray(x, dtype), jnp.asarray(w), jnp.asarray(b), ns, 1e-5,
        True)
    before = launch_counts()
    got = fused_layer_norm_affine(
        torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(w),
        torch.from_numpy(b), ns, 1e-5)
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


def test_shape_errors():
    with pytest.raises(ValueError):
        fused_layer_norm(torch.zeros(4, 8), 16)
    m = FusedLayerNorm(8, device="cpu")
    with pytest.raises(ValueError):
        m(torch.zeros(2, 9))

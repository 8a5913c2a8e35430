"""The port's CUDA kernels against their plain PyTorch versions on the card.

These run only where CUDA is available (marker ``cuda``; each test skips
with a reason elsewhere) and need no JAX, so they run on a GPU machine
without it:

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest`` because ``tests/conftest.py`` sets up JAX.)  They cover
the edges ``chip_smoke.py`` does not: odd widths, ragged lengths, the
built head_dim (64), fully-masked rows, strided operands and the errors
the wrappers raise.  Scale-aware error max|a-b| / (max|b| + 1) <= 2e-5
in fp32, <= 2e-2 in bf16; every kernel call adds exactly one launch.
"""

import importlib

import pytest
import torch

from apex_tpu_torch._kernels import launch_counts

ln = importlib.import_module("apex_tpu_torch.normalization.fused_layer_norm")
fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
da = importlib.import_module("apex_tpu_torch.ops.decode_attention")

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def rel_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / (want.abs().max() + 1)).item()


def _one_launch(name, fn):
    before = launch_counts()[name]
    out = fn()
    torch.cuda.synchronize()
    assert launch_counts()[name] == before + 1
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n1,n2", [(1, 7), (33, 100), (5, 1000), (64, 768)])
@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_matches_plain(gen, dtype, n1, n2, affine):
    x = (3 * torch.randn(n1, n2, device="cuda", generator=gen) + 1).to(dtype)
    w = b = None
    if affine:
        w = 1 + 0.1 * torch.randn(n2, device="cuda", generator=gen)
        b = 0.1 * torch.randn(n2, device="cuda", generator=gen)
    y, mean, invvar = _one_launch("layer_norm_fwd",
                                  lambda: ln.layer_norm_fwd(x, w, b, 1e-5))
    xhat, pmean, pinvvar = ln._ln_forward_plain(x, 1e-5)
    want = (xhat if w is None else xhat * w + b).to(dtype)
    assert y.dtype == dtype
    assert rel_err(y, want) <= TOL[dtype]
    assert rel_err(mean, pmean) <= 2e-5 and rel_err(invvar, pinvvar) <= 2e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,causal", [(33, 33, True), (100, 100, False),
                                          (24, 70, False), (130, 130, True)])
def test_flash_matches_plain(gen, dtype, sq, sk, causal):
    b, h, d = 2, 3, 64
    q = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(dtype)
    k, v = (torch.randn(b, sk, h, d, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    mask = torch.zeros(b, sk, device="cuda")
    mask[1, sk - sk // 3:] = -1e9
    if not causal:
        mask[0, :] = fa.NEG_INF          # batch row 0 sees no key at all
    o, lse = _one_launch("flash_fwd", lambda: fa.flash_attention(
        q, k, v, kv_mask=mask, causal=causal, return_lse=True))
    po, plse = fa._reference(q, k, v, mask, causal, d ** -0.5,
                             return_lse=True)
    assert rel_err(o, po) <= TOL[dtype]
    assert rel_err(lse, plse) <= 2e-5
    if not causal:
        assert torch.all(o[0] == 0) and torch.all(lse[0] == fa.NEG_INF)


def test_flash_reads_strided_operands(gen):
    qkv = torch.randn(1, 50, 3, 4, 64, device="cuda", generator=gen)
    q, k, v = qkv.unbind(2)              # views with a stride gap on S
    o = _one_launch("flash_fwd",
                    lambda: fa.flash_attention(q, k, v, causal=True))
    assert rel_err(o, fa._reference(q, k, v, None, True, 64 ** -0.5)) <= 2e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 37, 1025, 3000])
def test_decode_matches_plain(gen, dtype, t):
    b, h, d = 4, 3, 64
    q = torch.randn(b, 1, h, d, device="cuda", generator=gen).to(dtype)
    k, v = (torch.randn(b, t, h, d, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    bias = torch.zeros(b, t, device="cuda")
    bias[1, t // 2:] = -1e9
    bias[2, :] = da.NEG_INF              # all masked: zeros
    o = _one_launch("decode_attention",
                    lambda: da.cached_attention(q, k, v, kv_bias=bias))
    want = da._reference(q, k, v, bias, d ** -0.5)
    assert rel_err(o, want) <= TOL[dtype]
    assert torch.all(o[2] == 0)


def test_decode_reads_strided_operands_without_bias(gen):
    kv = torch.randn(2, 300, 2, 4, 64, device="cuda", generator=gen)
    k, v = kv.unbind(2)
    q = torch.randn(2, 1, 4, 64, device="cuda", generator=gen)
    o = _one_launch("decode_attention",
                    lambda: da.cached_attention(q, k, v))
    assert rel_err(o, da._reference(q, k, v, None, 64 ** -0.5)) <= 2e-5


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = torch.randn(4, 8, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        ln.layer_norm_fwd(x, None, None, 1e-5)
    with pytest.raises(ValueError):
        ln.layer_norm_fwd(torch.randn(8, 4, device="cuda").t(), None, None,
                          1e-5)
    q = torch.randn(1, 4, 2, 80, device="cuda")
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    for d in (32, 128):                  # head dims the kernels are not built for
        q_d = torch.randn(1, 4, 2, d, device="cuda")
        with pytest.raises(ValueError):
            fa.flash_attention(q_d, q_d, q_d)
        with pytest.raises(ValueError):
            da.cached_attention(q_d[:, :1], q_d, q_d)
    with pytest.raises(TypeError):
        fa.flash_attention(q[..., :64], q[..., :64].half(), q[..., :64])
    with pytest.raises(ValueError):
        da.cached_attention(q[:, :1], q, q)
    with pytest.raises(ValueError):
        fa.flash_attention(q[..., :64], q.cpu()[..., :64], q[..., :64])

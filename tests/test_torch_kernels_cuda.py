"""The port's CUDA kernels against their plain PyTorch versions on the card.

These run only where CUDA is available (marker ``cuda``; each test skips
with a reason elsewhere) and need no JAX, so they run on a GPU machine
without it:

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest`` because ``tests/conftest.py`` sets up JAX.)  They cover
the edges ``chip_smoke.py`` does not: odd widths, ragged lengths, the
built head_dim (64), fully-masked rows, strided operands, inf/nan
gradients in the Adam step, the multi-tensor Adam (B1-multi) bit for
bit against its plain version over odd, misaligned and empty segments
in five groups (one skipped) and through FusedAdam's tree and grouped
layouts, gradients flowing through the kernels' autograd functions, the errors the wrappers raise, B2 at the paths'
shapes and both sides of its fast path's edges with fp32 and bf16
weights (every block size giving the same bits, and no device kernel
but its own under the profiler, nor B3's), B3's dweight and dbias, decode split across 64-key tiles (every split count of 1025
keys, masked tiles skipped, T past the old shared-memory limit), B8 (int8 K/V) bit for bit against B7 on
the dequantized K/V, the same bits from repeated launches of B3, B7
and B8, and the threefry dropout kernel bit for bit against its plain
version; besides, a train-state checkpoint of card tensors (bf16
leaves) round-trips bit for bit, and DCGAN at O0 on the card matches
the CPU within 1e-4; B1 on ZeRO shards at an offset and through
``FusedAdam.with_zero`` bit for bit, and B4-B6 (and their dropout
branches) at one ``--tp 2`` rank's 6 heads with a head offset; the
sequence-parallel call modes: B4's lse merged over two key blocks (one
fully masked for a row) against one call over the joined keys, B5 and
B6 with an lse cotangent, B4d-B6d at a ring hop's row and column
offsets, the threefry dropout's window against the dense slice, and
ring and Ulysses attention at a world of one; BERT's token-type gradient
repeats its bits; the stochastic sampler (``sample_tokens``, plain
PyTorch) and the row-batched threefry it draws with give on the card
the CPU's keys and uniform bits bit for bit, Gumbel noise within
``NOISE_ULPS`` epsilons of max(|x|, 1), and the CPU's tokens; the
disaggregated server, its prefill engine on a stream of its own and its
pool one context, gives the monolithic server's tokens, with the offload
tier too (promotes importing into blocks a hand-off just freed).
Scale-aware error
max|a-b| / (max|b| + 1) <= 2e-5 in fp32, <= 2e-2 in bf16; the bf16
flash o, dq, dk and dv also row by row (``row_err``); every kernel call
adds exactly one launch.
"""

import importlib

import numpy as np
import pytest
import torch

from apex_tpu_torch._kernels import launch_counts

ln = importlib.import_module("apex_tpu_torch.normalization.fused_layer_norm")
fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
da = importlib.import_module("apex_tpu_torch.ops.decode_attention")
adam = importlib.import_module("apex_tpu_torch.optimizers.fused_adam")
kvq = importlib.import_module("apex_tpu_torch.ops.kv_quant")
tf = importlib.import_module("apex_tpu_torch.ops.threefry")

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
ROW_TOL = 1e-2  # bf16 flash o, dq, dk and dv, per row (as chip_smoke.py)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def rel_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / (want.abs().max() + 1)).item()


def row_err(got, want, eps=1e-2):
    """max over rows (the head dim) of ||got_r - want_r|| / (||want_r||
    + eps): unlike ``rel_err`` it does not let the largest row of a
    causal output (row 0, o = v[0]) set the bound for the late rows.
    ``eps`` keeps rows that are zero up to rounding (fully masked, or
    the dq of a row with one live key) from dividing noise by noise."""
    got, want = got.float(), want.float()
    return ((got - want).norm(dim=-1) / (want.norm(dim=-1) + eps)).max() \
        .item()


def _check_bf16(got, want):
    """The scale-aware and the per-row bound, with both readings in the
    message."""
    errs = rel_err(got, want), row_err(got, want)
    assert errs[0] <= 2e-2 and errs[1] <= ROW_TOL, \
        f"scale-aware {errs[0]:.3g}, row {errs[1]:.3g}"


def _one_launch(name, fn):
    before = launch_counts()[name]
    out = fn()
    torch.cuda.synchronize()
    assert launch_counts()[name] == before + 1
    return out


# B2's shapes: the paths' (decode, a prefill bucket, the GPT and BERT
# training steps) and both sides of the fast path's edges (whole
# 16-byte chunks, at most 1024 elements)
LN_FWD_SHAPES = [(8, 768), (256, 768), (8192, 768), (4096, 1024),
                 (1, 7), (33, 100), (5, 1000), (3, 1001), (5, 1024),
                 (5, 1032), (64, 768)]


def _ln_fwd_inputs(gen, dtype, wdtype, n1, n2):
    x = (3 * torch.randn(n1, n2, device="cuda", generator=gen) + 1).to(dtype)
    if wdtype is None:
        return x, None, None
    w = (1 + 0.1 * torch.randn(n2, device="cuda", generator=gen)).to(wdtype)
    b = (0.1 * torch.randn(n2, device="cuda", generator=gen)).to(wdtype)
    return x, w, b


def _ln_fwd_check(x, w, b, got):
    y, mean, invvar = got
    xhat, pmean, pinvvar = ln._ln_forward_plain(x, 1e-5)
    want = (xhat if w is None else xhat * w.float() + b.float()).to(x.dtype)
    assert y.dtype == x.dtype
    assert rel_err(y, want) <= TOL[x.dtype]
    assert rel_err(mean, pmean) <= 2e-5 and rel_err(invvar, pinvvar) <= 2e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n1,n2", LN_FWD_SHAPES)
@pytest.mark.parametrize("affine", [None, torch.float32, torch.bfloat16])
def test_layer_norm_matches_plain(gen, dtype, n1, n2, affine):
    """B2 against its plain version, without an affine step and with fp32
    or bf16 weights (read in their dtype); a second launch gives the
    same bits."""
    x, w, b = _ln_fwd_inputs(gen, dtype, affine, n1, n2)
    got = _one_launch("layer_norm_fwd",
                      lambda: ln.layer_norm_fwd(x, w, b, 1e-5))
    _ln_fwd_check(x, w, b, got)
    again = ln.layer_norm_fwd(x, w, b, 1e-5)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n1,n2", [(8192, 768), (4096, 1024), (5, 1000)])
def test_layer_norm_fwd_rows_walked_give_the_same_bits(gen, dtype, n1, n2):
    """A row gives the same bits whether its warp takes it alone or walks
    to it past other rows (the fast path's grid is resident, so at 4096
    rows and more a warp takes several)."""
    x, w, b = _ln_fwd_inputs(gen, dtype, dtype, n1, n2)
    full = ln.layer_norm_fwd(x, w, b, 1e-5)
    for r in (0, n1 // 2, n1 - 1):
        alone = ln.layer_norm_fwd(x[r:r + 1].clone(), w, b, 1e-5)
        assert all(torch.equal(a, c[r:r + 1]) for a, c in zip(alone, full)), r


def test_layer_norm_fwd_misaligned_rows_and_other_weights(gen):
    """A row view off the 16-byte grid takes the generic path; a weight
    and bias of two dtypes, or fp16 ones, are read through fp32 copies;
    each call is one launch and agrees with the plain version."""
    n1, n2 = 40, 768
    x, w, b = _ln_fwd_inputs(gen, torch.bfloat16, torch.bfloat16, n1, n2)
    buf = torch.empty(n1 * n2 + 1, device="cuda", dtype=torch.bfloat16)
    x_off = buf[1:].view(n1, n2)                # 2 bytes off the grid
    x_off.copy_(x)
    for xi, wi, bi in ((x_off, w, b), (x, w, b.float()), (x, w.half(),
                                                          b.half())):
        got = _one_launch("layer_norm_fwd",
                          lambda: ln.layer_norm_fwd(xi, wi, bi, 1e-5))
        _ln_fwd_check(xi, wi, bi, got)


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_layer_norm_runs_only_its_own_kernels(gen, wdtype):
    """Under the profiler: one affine forward with fp32 or bf16 weights
    (bf16: amp O2's LayerNorm) runs exactly one device kernel, and one
    backward with the weight gradients exactly B3's two (rows, column
    sums): no casts."""
    from torch.profiler import ProfilerActivity, profile
    x, w, b = _ln_fwd_inputs(gen, torch.bfloat16, wdtype, 4096, 1024)
    dy = torch.randn_like(x)
    _, mean, invvar = ln.layer_norm_fwd(x, w, b, 1e-5)
    ln.layer_norm_bwd(dy, x, mean, invvar, w)
    torch.cuda.synchronize()

    def device_kernels(fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    fwd = device_kernels(lambda: ln.layer_norm_fwd(x, w, b, 1e-5))
    assert len(fwd) == 1 and "layer_norm_fwd_kernel" in fwd[0], fwd
    bwd = device_kernels(lambda: ln.layer_norm_bwd(dy, x, mean, invvar, w))
    assert len(bwd) == 2 and all("layer_norm_bwd" in k for k in bwd), bwd


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


def _decode_bias(b, t):
    """(b, t) biases over the kernel's 64-key tiles: row 0 all live; row 1
    the engine's masked tail (-1e9, read and weighted 0); row 2 all
    masked (zeros); from row 3 on NEG_INF masks that leave whole tiles
    masked at the start, in the middle and at the tail, and a row whose
    only live key is the last (the self slot)."""
    bias = torch.zeros(b, t, device="cuda")
    bias[1, t // 2:] = -1e9
    bias[2, :] = da.NEG_INF
    if b > 3:
        bias[3, :] = da.NEG_INF
        bias[3, t // 3:t // 3 + 5] = 0.0     # live keys mid-row only
        bias[3, t - 1] = 0.0
    if b > 4:
        bias[4, :2 * t // 3] = da.NEG_INF    # masked head, live tail
    if b > 5:
        bias[5, :] = da.NEG_INF
        bias[5, t - 1] = 0.0                 # only the self slot
    return bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 37, 63, 64, 65, 1025, 3000])
def test_decode_matches_plain(gen, dtype, t):
    """Split across 64-key tiles at T on either side of a tile edge,
    with masked tiles skipped; repeated launches give the same bits."""
    b, h, d = 6, 3, 64
    q = torch.randn(b, 1, h, d, device="cuda", generator=gen).to(dtype)
    k, v = (torch.randn(b, t, h, d, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    bias = _decode_bias(b, t)
    o = _one_launch("decode_attention",
                    lambda: da.cached_attention(q, k, v, kv_bias=bias))
    want = da._reference(q, k, v, bias, d ** -0.5)
    assert rel_err(o, want) <= TOL[dtype]
    assert torch.all(o[2] == 0)
    assert torch.equal(o, da.cached_attention(q, k, v, kv_bias=bias))


def test_decode_reads_strided_operands_without_bias(gen):
    kv = torch.randn(2, 300, 2, 4, 64, device="cuda", generator=gen)
    k, v = kv.unbind(2)
    q = torch.randn(2, 1, 4, 64, device="cuda", generator=gen)
    o = _one_launch("decode_attention",
                    lambda: da.cached_attention(q, k, v))
    assert rel_err(o, da._reference(q, k, v, None, 64 ** -0.5)) <= 2e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_copies_rows_off_the_16_byte_grid(gen, dtype):
    """K/V whose (b, t, h) rows are not 16-byte aligned (a base one
    element off) are read from a contiguous copy: the same bits as the
    aligned tensors give."""
    b, t, h, d = 4, 130, 3, 64
    q = torch.randn(b, 1, h, d, device="cuda", generator=gen).to(dtype)
    k, v = (torch.randn(b, t, h, d, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    buf = torch.empty(2 * k.numel() + 1, device="cuda", dtype=dtype)
    k_off = buf[1:1 + k.numel()].view(k.shape)
    v_off = buf[1 + k.numel():].view(v.shape)
    k_off.copy_(k)
    v_off.copy_(v)
    bias = _decode_bias(b, t)
    o = _one_launch("decode_attention", lambda: da.cached_attention(
        q, k_off, v_off, kv_bias=bias))
    assert torch.equal(o, da.cached_attention(q, k, v, kv_bias=bias))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n1,n2", [(1, 7), (1, 768), (33, 1001), (64, 768),
                                   (4096, 1024), (8192, 768)])
@pytest.mark.parametrize("affine", [None, torch.float32, torch.bfloat16])
def test_layer_norm_bwd_matches_plain(gen, dtype, n1, n2, affine):
    """dx, dweight and dbias in one call (one launch) against the plain
    version, with the weight read in its dtype (fp32 or bf16; dweight and
    dbias come back in it, fp32 sums rounded once); a second launch gives
    the same bits."""
    x = (3 * torch.randn(n1, n2, device="cuda", generator=gen) + 1).to(dtype)
    dy = torch.randn(n1, n2, device="cuda", generator=gen).to(dtype)
    w = (1 + 0.1 * torch.randn(n2, device="cuda", generator=gen)) \
        .to(affine) if affine is not None else None
    _, mean, invvar = ln._ln_forward_plain(x, 1e-5)
    got = _one_launch("layer_norm_bwd",
                      lambda: ln.layer_norm_bwd(dy, x, mean, invvar, w))
    want = ln._ln_backward_plain(dy, x, mean, invvar, w)
    assert got[0].dtype == dtype
    assert rel_err(got[0], want[0]) <= TOL[dtype]
    if affine is None:
        assert got[1] is None and got[2] is None
    else:
        for g, pw in zip(got[1:], want[1:]):
            assert g.dtype == affine and rel_err(g, pw) <= TOL[affine]
    again = ln.layer_norm_bwd(dy, x, mean, invvar, w)
    assert all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(got, again))


def test_layer_norm_bwd_asked_gradients_weight_dtype_and_alignment(gen):
    """Each call is one launch whatever it is asked for; a bf16 weight
    gets bf16 gradients; a row operand off the 16-byte grid takes the
    generic path and agrees with the plain version."""
    n1, n2 = 300, 768
    x = torch.randn(n1, n2, device="cuda", generator=gen) \
        .to(torch.bfloat16)
    dy = torch.randn(n1, n2, device="cuda", generator=gen) \
        .to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn(n2, device="cuda", generator=gen)) \
        .to(torch.bfloat16)
    _, mean, invvar = ln._ln_forward_plain(x, 1e-5)
    full = _one_launch("layer_norm_bwd",
                       lambda: ln.layer_norm_bwd(dy, x, mean, invvar, w))
    want = ln._ln_backward_plain(dy, x, mean, invvar, w)
    for g, pw in zip(full, want):
        assert g.dtype == torch.bfloat16 and rel_err(g, pw) <= 2e-2
    dx, dw, db = _one_launch("layer_norm_bwd", lambda: ln.layer_norm_bwd(
        dy, x, mean, invvar, w, grad_weight=False))
    assert dw is None and db is None and torch.equal(dx, full[0])
    dx, dw, db = _one_launch("layer_norm_bwd", lambda: ln.layer_norm_bwd(
        dy, x, mean, invvar, w, grad_input=False))
    assert dx is None and torch.equal(dw, full[1]) and torch.equal(db,
                                                                   full[2])
    buf = torch.empty(2 * n1 * n2 + 1, device="cuda", dtype=torch.bfloat16)
    x_off = buf[1:1 + n1 * n2].view(n1, n2)     # 2 bytes off the grid
    dy_off = buf[1 + n1 * n2:].view(n1, n2)
    x_off.copy_(x)
    dy_off.copy_(dy)
    got = _one_launch("layer_norm_bwd", lambda: ln.layer_norm_bwd(
        dy_off, x_off, mean, invvar, w.float()))
    want = ln._ln_backward_plain(dy, x, mean, invvar, w.float())
    assert rel_err(got[0], want[0]) <= 2e-2
    assert all(rel_err(g, pw) <= 2e-5 for g, pw in zip(got[1:], want[1:]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,causal,full_mask", [
    (16, True, False), (77, True, False), (100, False, True),
    (1024, True, False)])
def test_flash_bwd_matches_plain(gen, dtype, s, causal, full_mask):
    b, h, d = 2, 3, 64
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                   .to(dtype) for _ in range(4))
    mask = torch.zeros(b, s, device="cuda")
    mask[1, s - s // 3:] = -1e9
    if full_mask:
        mask[0, :] = fa.NEG_INF          # batch row 0 sees no key at all
    scale = d ** -0.5
    o, lse = fa._reference(q, k, v, mask, causal, scale, return_lse=True)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    before = launch_counts()
    got = fa.flash_attention_bwd(q, k, v, do, lse, delta, mask, causal, scale)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert after["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    want = (fa._bwd_dq_reference(q, k, v, do, lse, delta, mask, causal,
                                 scale),
            *fa._bwd_dkv_reference(q, k, v, do, lse, delta, mask, causal,
                                   scale))
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert rel_err(g, w) <= TOL[dtype]
        if full_mask:
            assert torch.all(g[0] == 0)


def _adam_inputs(gen, n=4096):
    p, m, g = (torch.randn(n, device="cuda", generator=gen)
               for _ in range(3))
    v = torch.rand(n, device="cuda", generator=gen)
    g[5], g[77] = float("inf"), float("nan")
    return p, m.mul_(0.1), v.mul_(0.01), g


@pytest.mark.parametrize("keep", [1.0, 0.0])
@pytest.mark.parametrize("eps_inside", [False, True])
def test_fused_adam_matches_plain_with_nonfinite_grads(gen, keep,
                                                       eps_inside):
    p, m, v, g = _adam_inputs(gen)
    scalars = torch.tensor([1e-3, 0.9, 0.999, 1e-8, 4.0, 0.01, keep],
                           device="cuda")
    want = adam._adam_plain(p, m, v, g, scalars, eps_inside)
    old = [t.clone() for t in (p, m, v)]
    _one_launch("fused_adam",
                lambda: adam.adam_flat(p, m, v, g, scalars, eps_inside))
    for got, w, o in zip((p, m, v), want, old):
        # inf/nan lanes agree too: equal_nan, and bitwise where skipped
        assert torch.allclose(got, w, rtol=0, atol=1e-6, equal_nan=True)
        if keep == 0.0:
            assert torch.equal(got, o)


def _bits(t):
    return t.view(torch.int32)


def test_fused_adam_flat_equals_plain_bit_for_bit(gen):
    """Each operation of B1 rounds on its own, in the plain version's
    order, so finite inputs give the plain version's bits."""
    p, m, v, g = _adam_inputs(gen)
    g[5] = g[77] = 0.5
    for eps_inside in (False, True):
        scalars = torch.tensor([1e-3, 0.9, 0.999, 1e-8, 4.0, 0.01, 1.0],
                               device="cuda")
        want = adam._adam_plain(p, m, v, g, scalars, eps_inside)
        adam.adam_flat(p, m, v, g, scalars, eps_inside)
        for got, w in zip((p, m, v), want):
            assert torch.equal(_bits(got), _bits(w))


@pytest.mark.parametrize("ranks", [2, 4])
def test_fused_adam_on_a_zero_shard_at_an_offset(gen, ranks):
    """B1 on each rank's slice of a flat buffer (views at an offset, as
    ``with_zero`` and ``zero2_update`` launch it) gives the bits of the
    whole buffer's update."""
    n = 128 * 33
    p, m, v, g = _adam_inputs(gen, n)
    g[5] = g[77] = 0.5
    scalars = torch.tensor([1e-3, 0.9, 0.999, 1e-8, 4.0, 0.01, 1.0],
                           device="cuda")
    want = adam._adam_plain(p, m, v, g, scalars, False)
    k = n // ranks
    for r in range(ranks):
        sl = slice(r * k, (r + 1) * k)
        ms, vs = m[sl].clone(), v[sl].clone()
        _one_launch("fused_adam", lambda: adam.adam_flat(
            p[sl], ms, vs, g[sl], scalars, False))
        assert torch.equal(_bits(ms), _bits(want[1][sl]))
        assert torch.equal(_bits(vs), _bits(want[2][sl]))
    assert torch.equal(_bits(p), _bits(want[0]))


def test_fused_adam_zero_step_equals_the_replicated_one(gen):
    """``FusedAdam.with_zero`` at a world of one process (no process
    group: the gathers are copies) launches B1 once over its shard, the
    whole buffer, and gives the replicated step's bits."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import mesh, shard_optimizer_state
    params = {f"w{i}": torch.randn(n, device="cuda", generator=gen)
              for i, n in enumerate((1000, 37, 3000))}
    grads = {k: torch.randn_like(v) for k, v in params.items()}
    opt = FusedAdam(lr=1e-3)
    want, _ = opt.step({k: v.clone() for k, v in params.items()}, grads,
                       opt.init(params))
    zopt = opt.with_zero(mesh.WORLD)
    st = shard_optimizer_state(opt.init(params), mesh.WORLD)
    got, _ = _one_launch("fused_adam", lambda: zopt.step(
        {k: v.clone() for k, v in params.items()}, grads, st))
    for k in want:
        assert torch.equal(_bits(got[k]), _bits(want[k]))


# the multi-tensor form (B1-multi): segments of odd lengths, one longer
# than a chunk, at starts off the 16-byte grid, p/m/v/g misaligned alike
# (head, float4 body, tail) or unlike (scalar), one empty
_MULTI_SEGMENTS = ((1, (0, 0, 0, 0)), (3, (1, 1, 1, 1)), (4097, (2, 2, 2, 2)),
                   (70001, (3, 3, 3, 3)), (129, (1, 2, 3, 0)), (0, (0,) * 4),
                   (6, (3, 0, 0, 0)), (1000, (0, 0, 0, 0)))


def _carve(bufs, n_groups):
    """The segments of ``_MULTI_SEGMENTS`` carved from four buffers, the
    i-th in group ``i % n_groups``, and the mask of what the kept groups
    may write."""
    segments, kept, cursor = [], torch.zeros(bufs[0].numel(),
                                             dtype=torch.bool), 0
    for i, (n, offs) in enumerate(_MULTI_SEGMENTS):
        cursor += -cursor % 4
        segments.append((*(b[cursor + o:cursor + o + n]
                           for b, o in zip(bufs, offs)), i % n_groups))
        if i % n_groups != n_groups - 1:
            kept[cursor:cursor + n + 3] = True
        cursor += n + 4
    return segments, kept


def _multi_case(gen, n_groups=5):
    """Four buffers and (G, 7) scalars whose last group is skipped and
    holds segments with inf/nan gradients."""
    total = sum(n + 4 for n, _ in _MULTI_SEGMENTS) + 64
    bufs = [torch.randn(total, device="cuda", generator=gen)
            for _ in range(4)]
    bufs[1].mul_(0.1)
    bufs[2] = bufs[2].abs_().mul_(0.01)
    rows = [[1e-3 * (gid + 1), 0.9, 0.999, 1e-8, 2.0 + gid, 0.01 * gid,
             0.0 if gid == n_groups - 1 else 1.0]
            for gid in range(n_groups)]
    for p, m, v, g, gid in _carve(bufs, n_groups)[0]:
        if gid == n_groups - 1 and g.numel() > 5:
            g[0], g[5] = float("inf"), float("nan")
    return bufs, torch.tensor(rows, device="cuda")


@pytest.mark.parametrize("eps_inside", [False, True])
def test_fused_adam_multi_matches_plain_bit_for_bit(gen, eps_inside):
    bufs, scalars = _multi_case(gen)
    twins = [b.clone() for b in bufs]
    old = [b.clone() for b in bufs]
    segments, kept = _carve(bufs, scalars.shape[0])
    _one_launch("fused_adam_multi", lambda: adam.adam_multi(
        segments, scalars, eps_inside))
    adam.adam_multi_plain(_carve(twins, scalars.shape[0])[0], scalars,
                          eps_inside)
    kept = kept.cuda()
    for got, want, o in zip(bufs[:3], twins[:3], old):
        assert torch.equal(_bits(got), _bits(want))
        # the skipped group and the gaps keep every bit
        assert torch.equal(_bits(got[~kept]), _bits(o[~kept]))


def test_fused_adam_multi_refuses_what_it_does_not_take(gen):
    p = torch.zeros(8, device="cuda")
    scalars = torch.ones(1, 7, device="cuda")
    with pytest.raises(ValueError, match="no scalars"):
        adam.adam_multi([(p, p, p, p, 1)], scalars, False)
    with pytest.raises(ValueError, match="one length"):
        adam.adam_multi([(p, p, p, p[:4], 0)], scalars, False)
    with pytest.raises(ValueError, match="contiguous"):
        q = torch.zeros(16, device="cuda")[::2]
        adam.adam_multi([(q, q, q, q, 0)], scalars, False)


@pytest.mark.parametrize("layout,groups", [
    ("tree", None), ("tree", [{"match": r"bias", "lr": 1e-4}]),
    ("flat", [{"match": r"bias", "weight_decay": 0.0}])])
def test_fused_adam_layouts_launch_b1_multi_once_a_step(gen, layout, groups):
    """The tree and grouped flat layouts step through one B1-multi
    launch; the tree layout equals the flat one bit for bit (no norm),
    and an overflowed step keeps every bit without a host sync."""
    from apex_tpu_torch.optimizers import FusedAdam
    shapes = {"w": (300, 7), "bias": (129,), "s": (), "u": (5, 3)}

    def tree(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return {k: torch.randn(s, device="cuda", generator=g)
                for k, s in shapes.items()}

    opt = FusedAdam(lr=1e-3, weight_decay=0.01, layout=layout,
                    param_groups=groups)
    ref = FusedAdam(lr=1e-3, weight_decay=0.01, layout="flat",
                    param_groups=groups)
    params, rparams = tree(0), tree(0)
    st, rst = opt.init(params), ref.init(rparams)
    for i in range(3):
        grads = tree(10 + i)
        before = launch_counts()
        params, st = opt.step(params, grads, st, scale=2.0)
        rparams, rst = ref.step(rparams, grads, rst, scale=2.0)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert counts["fused_adam_multi"] == before["fused_adam_multi"] \
            + 1 + (groups is not None)
    for k in shapes:
        assert torch.equal(params[k].detach(), rparams[k].detach()), k
    snap = {k: v.detach().clone() for k, v in params.items()}
    grads = tree(20)
    grads["w"][0, 0] = float("inf")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        params, st = opt.step(params, grads, st,
                              skip=torch.isinf(grads["w"]).any())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for k in shapes:
        assert torch.equal(params[k].detach(), snap[k]), k
    assert int(st.step) == 3


def test_amp_step_on_overflow_syncs_nothing_and_keeps_every_bit(gen):
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedAdam
    params = {"w": torch.randn(300, 7, device="cuda", generator=gen),
              "b": torch.randn(129, device="cuda", generator=gen)}
    opt = amp.AmpOptimizer(FusedAdam(lr=1e-3), amp.LossScaler("dynamic"))
    state = opt.init(params)
    grads = {k: torch.randn_like(t) for k, t in params.items()}
    params, state = opt.step(params, grads, state)
    snap = ([t.clone() for t in params.values()],
            state.inner.m.clone(), state.inner.v.clone(),
            state.inner.step.clone())
    grads["b"][3] = float("inf")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        params, state = opt.step(params, grads, state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for got, old in zip(params.values(), snap[0]):
        assert torch.equal(got, old)
    assert torch.equal(state.inner.m, snap[1])
    assert torch.equal(state.inner.v, snap[2])
    assert torch.equal(state.inner.step, snap[3])
    assert float(opt.loss_scale(state)) == 2.0 ** 15


def test_gradients_flow_through_the_kernels(gen):
    """loss.backward() on the card reaches every input through the
    LayerNorm and flash autograd functions (B2/B3, B4/B5/B6)."""
    m = ln.FusedLayerNorm(64, device="cuda")
    x = torch.randn(2, 40, 3, 64, device="cuda", generator=gen,
                    requires_grad=True)
    before = launch_counts()
    y = m(x)
    o = fa.flash_attention(y, y * 0.5, y * 2.0, causal=True)
    o.float().pow(2).sum().backward()
    torch.cuda.synchronize()
    after = launch_counts()
    for name in ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd",
                 "flash_bwd_dq", "flash_bwd_dkv"):
        assert after[name] == before[name] + 1, name
    for t in (x, m.scale, m.bias):
        assert t.grad is not None and torch.isfinite(t.grad).all()
        assert t.grad.abs().sum() > 0


def test_decode_attention_refuses_a_gradient(gen):
    q = torch.randn(2, 1, 3, 64, device="cuda", generator=gen,
                    requires_grad=True)
    k, v = (torch.randn(2, 9, 3, 64, device="cuda", generator=gen)
            for _ in range(2))
    with pytest.raises(RuntimeError, match="no backward"):
        da.cached_attention(q, k, v)
    with torch.no_grad():
        da.cached_attention(q, k, v)


# -- attention dropout: B4d, B5d, B6d ----------------------------------------

def _seed(seed, h, offsets=None):
    return fa.seed_array(seed, offsets, num_heads=h, device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,causal", [(33, 33, True), (100, 100, False),
                                          (24, 70, False), (130, 130, True),
                                          (1024, 1024, True)])
@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_flash_dropout_matches_plain(gen, dtype, sq, sk, causal, rate):
    """B4d, B5d and B6d against their plain versions, with a padded
    batch row, a fully-masked one (non-causal) and ragged tails."""
    b, h, d = 2, 3, 64
    q, do = (torch.randn(b, sq, h, d, device="cuda", generator=gen)
             .to(dtype) for _ in range(2))
    k, v = (torch.randn(b, sk, h, d, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    mask = torch.zeros(b, sk, device="cuda")
    mask[1, sk - sk // 3:] = -1e9
    if not causal:
        mask[0, :] = fa.NEG_INF
    seed = _seed(1234 + sq, h, (5, 70000, 1, 2 * h))
    scale = d ** -0.5
    o, lse = _one_launch("flash_fwd_dropout", lambda: fa.flash_attention_fwd(
        q, k, v, mask, causal, scale, rate, seed))
    po, plse = fa._reference(q, k, v, mask, causal, scale, return_lse=True,
                             dropout_rate=rate, seed=seed)
    assert rel_err(o, po) <= TOL[dtype]
    assert rel_err(lse, plse) <= 2e-5
    delta = (do.float() * po.float()).sum(-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, plse, delta, mask, causal, scale, rate, seed)
    dq = _one_launch("flash_bwd_dq_dropout",
                     lambda: fa.flash_attention_bwd_dq(*args))
    dk, dv = _one_launch("flash_bwd_dkv_dropout",
                         lambda: fa.flash_attention_bwd_dkv(*args))
    want = (fa._bwd_dq_reference(*args), *fa._bwd_dkv_reference(*args))
    for g, w in zip((dq, dk, dv), want):
        assert g.dtype == dtype
        assert rel_err(g, w) <= TOL[dtype]
        if not causal:
            assert torch.all(g[0] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_at_six_local_heads_with_a_head_offset(gen, dtype, rate):
    """B4, B5 and B6 (B4d-B6d with dropout) at one rank's 6 of GPT-2
    small's 12 heads under --tp 2 (causal, S 1024, head_off 6 of 12)
    against their plain versions; with dropout the mask is the 12-head
    call's for heads 6-11."""
    b, s, h, d = 2, 1024, 6, 64
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                   .to(dtype) for _ in range(4))
    seed = _seed(4321, h, (0, 0, h, 2 * h))
    scale = d ** -0.5
    suffix = "_dropout" if rate else ""
    o, lse = _one_launch("flash_fwd" + suffix, lambda: fa.flash_attention_fwd(
        q, k, v, None, True, scale, rate, seed if rate else None))
    po, plse = fa._reference(q, k, v, None, True, scale, return_lse=True,
                             dropout_rate=rate, seed=seed if rate else None)
    assert rel_err(o, po) <= TOL[dtype]
    assert rel_err(lse, plse) <= 2e-5
    delta = (do.float() * po.float()).sum(-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, plse, delta, None, True, scale, rate,
            seed if rate else None)
    dq = _one_launch("flash_bwd_dq" + suffix,
                     lambda: fa.flash_attention_bwd_dq(*args))
    dk, dv = _one_launch("flash_bwd_dkv" + suffix,
                         lambda: fa.flash_attention_bwd_dkv(*args))
    want = (fa._bwd_dq_reference(*args), *fa._bwd_dkv_reference(*args))
    for g, w in zip((dq, dk, dv), want):
        assert rel_err(g, w) <= TOL[dtype]
    if rate:
        rows = torch.arange(s, device="cuda")
        local = fa.keep_from_seed(seed, b, h, rows, rows, rate)
        full = fa.keep_from_seed(_seed(4321, 2 * h), b, 2 * h, rows, rows,
                                 rate)
        assert torch.equal(local, full[:, h:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_flash_dropout_mask_reads_back_bitwise(gen, dtype, rate):
    """q = 0 makes every p = 1/Sk; with Sk = D = 64 and v = I the
    output's column d is key d's kept value, so ``o > 0`` IS the keep
    mask the kernel drew; likewise dv with do = I and dq with k = I.
    All must equal ``keep_from_seed`` bit for bit (offsets past 2**16
    included)."""
    b, h, n = 2, 3, 64
    eye = torch.eye(n, device="cuda")[None, :, None, :].expand(b, n, h, n)
    zeros = torch.zeros(b, n, h, n, device="cuda", dtype=dtype)
    v = eye.to(dtype).contiguous()
    seed = _seed(2 ** 31 - 2, h, (70001, 65540, 4, 2 * h))
    keep = fa.keep_from_seed(seed, b, h, torch.arange(n, device="cuda"),
                             torch.arange(n, device="cuda"), rate)
    o, lse = fa.flash_attention_fwd(zeros, zeros, v, None, False, 0.125,
                                    rate, seed)
    assert torch.equal(o.float().permute(0, 2, 1, 3) > 0, keep)
    kept = o.float()[o.float() > 0]
    want = torch.full_like(kept, 1.0 / (n * (1.0 - rate)))
    assert rel_err(kept, want) <= TOL[dtype]
    delta = torch.zeros(b, h, n, device="cuda")
    _, dv = fa.flash_attention_bwd_dkv(zeros, zeros, v, v, lse, delta, None,
                                       False, 0.125, rate, seed)
    # dv[b, key, h, d] = p_v[b, h, q = d, key]
    assert torch.equal(dv.float().permute(0, 2, 3, 1) > 0, keep)
    # dq: k = I, v and do all-ones in column 0 (so do.v = 1) and delta =
    # 0 make dq[b, q, h, d] = keep / (n (1 - rate)) * scale at key d
    col0 = zeros.clone()
    col0[..., 0] = 1
    dq = fa.flash_attention_bwd_dq(zeros, v, col0, col0, lse, delta, None,
                                   False, 0.125, rate, seed)
    assert torch.equal(dq.float().permute(0, 2, 1, 3) > 0, keep)


def test_flash_dropout_branch_with_nothing_dropped_matches_plain_kernel(
        gen):
    """At a rate whose keep-mask drops nothing and whose divisor rounds
    to 1.0f, the dropout kernels compute what the dropout-off kernels do
    (to the rounding of a differently contracted FMA chain); rate 0 runs
    the dropout-off kernel itself, bit for bit."""
    b, s, h, d = 2, 77, 3, 64
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                   for _ in range(4))
    rate = 1e-9
    seed = _seed(11, h)
    keep = fa.keep_from_seed(seed, b, h, torch.arange(s, device="cuda"),
                             torch.arange(s, device="cuda"), rate)
    assert bool(keep.all())
    assert torch.tensor(1.0 - rate, dtype=torch.float32).item() == 1.0
    for causal in (False, True):
        o0, lse0 = fa.flash_attention_fwd(q, k, v, None, causal, 0.125)
        o1, lse1 = _one_launch("flash_fwd_dropout", lambda: (
            fa.flash_attention_fwd(q, k, v, None, causal, 0.125, rate,
                                   seed)))
        assert rel_err(o1, o0) <= 1e-6 and rel_err(lse1, lse0) <= 1e-6
        delta = (do * o0).sum(-1).permute(0, 2, 1).contiguous()
        g0 = fa.flash_attention_bwd(q, k, v, do, lse0, delta, None, causal,
                                    0.125)
        g1 = fa.flash_attention_bwd(q, k, v, do, lse0, delta, None, causal,
                                    0.125, rate, seed)
        for a, c in zip(g1, g0):
            assert rel_err(a, c) <= 1e-6
    o2 = _one_launch("flash_fwd", lambda: fa.flash_attention(
        q, k, v, dropout_rate=0.0, dropout_seed=5))
    assert torch.equal(o2, fa.flash_attention(q, k, v))


def test_dropout_gradients_flow_through_the_kernels(gen):
    """Autograd through B4d/B5d/B6d equals autograd through the plain
    dropout reference on the same seed."""
    b, s, h, d = 2, 70, 2, 64
    qkv = [torch.randn(b, s, h, d, device="cuda", generator=gen,
                       requires_grad=True) for _ in range(3)]
    mask = torch.zeros(b, s, device="cuda")
    mask[1, 50:] = -1e9
    before = launch_counts()
    o = fa.flash_attention(*qkv, kv_mask=mask, dropout_rate=0.2,
                           dropout_seed=torch.tensor(99, device="cuda"))
    got = torch.autograd.grad(o.pow(2).sum(), qkv)
    torch.cuda.synchronize()
    after = launch_counts()
    for name in ("flash_fwd_dropout", "flash_bwd_dq_dropout",
                 "flash_bwd_dkv_dropout"):
        assert after[name] == before[name] + 1, name
    po = fa._reference(*qkv, mask, False, d ** -0.5, dropout_rate=0.2,
                       seed=_seed(99, h))
    want = torch.autograd.grad(po.pow(2).sum(), qkv)
    assert rel_err(o, po) <= 2e-5
    for g, w in zip(got, want):
        assert rel_err(g, w) <= 2e-5


# -- bf16 flash on the tensor cores: B4, B4d, B5, B5d, B6, B6d --------------

_BF16_SEQS = (1, 63, 64, 65, 127, 128, 129, 200, 1024)


def _bf16_flash_case(gen, sq, sk, causal, rate):
    """B4/B4d, B5/B5d and B6/B6d in bf16 against their plain versions at
    one (Sq, Sk): batch row 1 padded (its last third of keys at -1e9),
    and without causal masking batch row 0 fully masked (zeros, NEG_INF
    lse, zero dq, dk and dv).  The lse is held on the live rows alone,
    so the NEG_INF rows cannot hide an error in the scale-aware
    bound."""
    b, h, d = 2, 3, 64
    q, do = (torch.randn(b, sq, h, d, device="cuda", generator=gen)
             .bfloat16() for _ in range(2))
    k, v = (torch.randn(b, sk, h, d, device="cuda", generator=gen)
            .bfloat16() for _ in range(2))
    mask = torch.zeros(b, sk, device="cuda")
    mask[1, sk - sk // 3:] = -1e9
    if not causal:
        mask[0, :] = fa.NEG_INF
    seed = _seed(4321 + sq, h, (3, 70000, 2, 2 * h)) if rate else None
    scale = d ** -0.5
    suffix = "_dropout" if rate else ""
    o, lse = _one_launch("flash_fwd" + suffix, lambda: fa.flash_attention_fwd(
        q, k, v, mask, causal, scale, rate, seed))
    po, plse = fa._reference(q, k, v, mask, causal, scale, return_lse=True,
                             dropout_rate=rate, seed=seed)
    assert o.dtype == torch.bfloat16
    _check_bf16(o, po)
    live = slice(0 if causal else 1, None)
    assert rel_err(lse[live], plse[live]) <= 2e-5
    delta = (do.float() * po.float()).sum(-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, plse, delta, mask, causal, scale, rate, seed)
    dq = _one_launch("flash_bwd_dq" + suffix,
                     lambda: fa.flash_attention_bwd_dq(*args))
    assert dq.dtype == torch.bfloat16
    _check_bf16(dq, fa._bwd_dq_reference(*args))
    dk, dv = _one_launch("flash_bwd_dkv" + suffix,
                         lambda: fa.flash_attention_bwd_dkv(*args))
    for got, want in zip((dk, dv), fa._bwd_dkv_reference(*args)):
        assert got.dtype == torch.bfloat16 and got.shape == k.shape
        _check_bf16(got, want)
    if not causal:
        assert torch.all(o[0] == 0) and torch.all(lse[0] == fa.NEG_INF)
        assert torch.all(dq[0] == 0)
        assert torch.all(dk[0] == 0) and torch.all(dv[0] == 0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", _BF16_SEQS)
def test_flash_bf16_tiles_match_plain(gen, s, causal, rate):
    _bf16_flash_case(gen, s, s, causal, rate)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("sq,sk", [(1, 1024), (63, 129), (65, 200),
                                   (200, 64), (129, 1), (1024, 127)])
def test_flash_bf16_cross_lengths_match_plain(gen, sq, sk, rate):
    _bf16_flash_case(gen, sq, sk, False, rate)


def test_flash_bf16_reads_strided_and_misaligned_operands(gen):
    """The ``qkv.unbind`` views of ``test_flash_reads_strided_operands``
    in bf16 are read where they lie; an operand whose base is 2 bytes
    past a 16-byte line goes through the wrapper's contiguous copy and
    gives what the copy itself gives, bit for bit, in the forward, dq
    and dk/dv."""
    qkv = torch.randn(1, 50, 3, 4, 64, device="cuda",
                      generator=gen).bfloat16()
    q, k, v = qkv.unbind(2)
    assert all(fa._kernel_operand(t) is t for t in (q, k, v))
    o, lse = _one_launch("flash_fwd", lambda: fa.flash_attention_fwd(
        q, k, v, None, True, 0.125))
    po, plse = fa._reference(q, k, v, None, True, 0.125, return_lse=True)
    _check_bf16(o, po)
    assert rel_err(lse, plse) <= 2e-5
    do = torch.randn(1, 50, 4, 64, device="cuda", generator=gen).bfloat16()
    delta = (do.float() * po.float()).sum(-1).permute(0, 2, 1).contiguous()
    dq = _one_launch("flash_bwd_dq", lambda: fa.flash_attention_bwd_dq(
        q, k, v, do, plse, delta, None, True, 0.125))
    _check_bf16(dq, fa._bwd_dq_reference(q, k, v, do, plse, delta, None,
                                         True, 0.125))
    dkv = _one_launch("flash_bwd_dkv", lambda: fa.flash_attention_bwd_dkv(
        q, k, v, do, plse, delta, None, True, 0.125))
    for got, want in zip(dkv, fa._bwd_dkv_reference(q, k, v, do, plse, delta,
                                                    None, True, 0.125)):
        _check_bf16(got, want)
    buf = torch.empty(50 * 4 * 64 + 8, device="cuda", dtype=torch.bfloat16)
    q_off = buf[1:1 + 50 * 4 * 64].view(1, 50, 4, 64)
    q_off.copy_(q)
    assert q_off.data_ptr() % 16 == 2
    assert fa._kernel_operand(q_off) is not q_off
    o_off, lse_off = fa.flash_attention_fwd(q_off, k, v, None, True, 0.125)
    o_ref, lse_ref = fa.flash_attention_fwd(q.contiguous(), k, v, None, True,
                                            0.125)
    assert torch.equal(o_off, o_ref) and torch.equal(lse_off, lse_ref)
    dq_off = fa.flash_attention_bwd_dq(q_off, k, v, do, plse, delta, None,
                                       True, 0.125)
    assert torch.equal(dq_off, fa.flash_attention_bwd_dq(
        q.contiguous(), k, v, do, plse, delta, None, True, 0.125))
    dkv_off = fa.flash_attention_bwd_dkv(q_off, k, v, do, plse, delta, None,
                                         True, 0.125)
    dkv_ref = fa.flash_attention_bwd_dkv(q.contiguous(), k, v, do, plse,
                                         delta, None, True, 0.125)
    assert all(torch.equal(a, c) for a, c in zip(dkv_off, dkv_ref))


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_bf16_launches_are_bit_identical(gen, rate):
    """One block owns each output (no atomics): two launches on the same
    inputs give the same bits, o, lse, dq, dk and dv."""
    b, s, h, d = 2, 333, 3, 64
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                   .bfloat16() for _ in range(4))
    seed = _seed(8, h) if rate else None
    runs = []
    for _ in range(2):
        o, lse = fa.flash_attention_fwd(q, k, v, None, True, 0.125, rate,
                                        seed)
        delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1) \
            .contiguous()
        bargs = (q, k, v, do, lse, delta, None, True, 0.125, rate, seed)
        runs.append((o, lse, fa.flash_attention_bwd_dq(*bargs),
                     *fa.flash_attention_bwd_dkv(*bargs)))
    for a, c in zip(*runs):
        assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 1, 2])
def test_flash_dropout_mask_reads_back_over_tiles(gen, dtype, window):
    """The keep-mask of B4d, B5d and B6d read back bit for bit over more
    than one tile in q and in k: Sq = Sk = 192 with q = 0 (every p =
    1/192) and a one-hot operand selecting the 64-key window ``window``:
    v for the forward (o[q, d] keeps key 64 w + d), k for dq (with v and
    do all-ones in column 0, delta = 0), and do over the q window for dv
    (dv[key, d] keeps query 64 w + d: B6d's transposed keep bits, whose
    rows are keys)."""
    b, h, n, d = 2, 3, 192, 64
    rate = 0.1
    zeros = torch.zeros(b, n, h, d, device="cuda", dtype=dtype)
    onehot = zeros.clone()
    cols = torch.arange(d, device="cuda")
    onehot[:, window * d + cols, :, cols] = 1
    col0 = zeros.clone()
    col0[..., 0] = 1
    seed = _seed(2 ** 31 - 5, h, (70001, 65540, 4, 2 * h))
    keep = fa.keep_from_seed(seed, b, h, torch.arange(n, device="cuda"),
                             torch.arange(n, device="cuda"), rate)
    win = slice(window * d, (window + 1) * d)
    lse = torch.full((b, h, n), float(np.log(n)), device="cuda")
    delta = torch.zeros(b, h, n, device="cuda")
    o, _ = fa.flash_attention_fwd(zeros, zeros, onehot, None, False, 0.125,
                                  rate, seed)
    assert torch.equal(o.float().permute(0, 2, 1, 3) > 0, keep[..., win])
    dq = fa.flash_attention_bwd_dq(zeros, onehot, col0, col0, lse, delta,
                                   None, False, 0.125, rate, seed)
    assert torch.equal(dq.float().permute(0, 2, 1, 3) > 0, keep[..., win])
    _, dv = fa.flash_attention_bwd_dkv(zeros, zeros, zeros, onehot, lse,
                                       delta, None, False, 0.125, rate, seed)
    assert torch.equal(dv.float().permute(0, 2, 3, 1) > 0, keep[:, :, win])


# -- int8 K/V decode: B8 ------------------------------------------------------

def _q8_inputs(gen, dtype, b, t, h=3, d=64):
    """q in ``dtype``; int8 K/V and their scales from ``quantize_kv`` of
    random data, head 1 of K all zero (zero scales); slot 0 fully
    masked, the others with a masked tail as the engine's bias."""
    q = torch.randn(b, 1, h, d, device="cuda", generator=gen).to(dtype)
    k, v = (torch.randn(b, t, h, d, device="cuda", generator=gen)
            for _ in range(2))
    k[:, :, 1] = 0
    (kq, ks), (vq, vs) = kvq.quantize_kv(k), kvq.quantize_kv(v)
    bias = torch.zeros(b, t, device="cuda")
    bias[0] = da.NEG_INF
    bias[1:, t // 2 + 1:] = -1e9
    return q, kq, ks, vq, vs, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 17, 63, 64, 65, 1025, 3000])
def test_decode_q8_matches_plain_and_b7_bitwise(gen, dtype, t):
    q, kq, ks, vq, vs, bias = _q8_inputs(gen, dtype, 6, t)
    bias[3:] = _decode_bias(6, t)[3:]           # NEG_INF tiles skipped
    before = launch_counts()["decode_attention"]
    o = _one_launch("decode_attention_q8", lambda: da.cached_attention(
        q, kq, vq, kv_bias=bias, k_scale=ks, v_scale=vs))
    assert launch_counts()["decode_attention"] == before
    assert o.dtype == dtype and o.shape == q.shape
    want = da._reference(q, kq, vq, bias, 64 ** -0.5, ks, vs)
    assert rel_err(o, want) <= TOL[dtype]
    assert torch.all(o[0] == 0)          # the empty slot: every key masked
    b7 = _one_launch("decode_attention", lambda: da.cached_attention(
        q, kvq.dequantize_kv(kq, ks, dtype), kvq.dequantize_kv(vq, vs, dtype),
        kv_bias=bias))
    assert torch.equal(o, b7)
    assert torch.equal(o, da.cached_attention(
        q, kq, vq, kv_bias=bias, k_scale=ks, v_scale=vs))


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_runs_past_the_old_shared_memory_limit(gen, quantized):
    """T = 20,000 (the old kernels kept a shared-memory score row and
    took T <= 19,242 with int8 K/V): B8 equals B7 on the dequantized K/V
    bit for bit, both against the plain version, masked tiles skipped."""
    t = 20_000
    q, kq, ks, vq, vs, bias = _q8_inputs(gen, torch.float32, 6, t, h=2)
    bias[3:] = _decode_bias(6, t)[3:]
    kd, vd = kvq.dequantize_kv(kq, ks, q.dtype), kvq.dequantize_kv(vq, vs,
                                                                   q.dtype)
    b7 = _one_launch("decode_attention", lambda: da.cached_attention(
        q, kd, vd, kv_bias=bias))
    assert rel_err(b7, da._reference(q, kd, vd, bias, 64 ** -0.5)) <= 2e-5
    assert torch.all(b7[0] == 0)
    if quantized:
        o = _one_launch("decode_attention_q8", lambda: da.cached_attention(
            q, kq, vq, kv_bias=bias, k_scale=ks, v_scale=vs))
        assert torch.equal(o, b7)
        assert torch.equal(o, da.cached_attention(
            q, kq, vq, kv_bias=bias, k_scale=ks, v_scale=vs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 2, 3, 5, 9, 17])
def test_decode_every_split_count_matches_plain(gen, monkeypatch, dtype,
                                                splits):
    """Every way 1025 keys (17 tiles) split, the wrapper's choice
    replaced: each count against the plain version, zeros on the
    all-masked rows, B8 bit for bit B7 at the same count, and a second
    launch (the combine's counters reset) the same bits."""
    t = 1025
    tiles = -(-17 // splits)
    monkeypatch.setattr(da, "_split", lambda *_: (tiles, splits))
    q, kq, ks, vq, vs, bias = _q8_inputs(gen, dtype, 6, t)
    bias[3:] = _decode_bias(6, t)[3:]
    o = _one_launch("decode_attention_q8", lambda: da.cached_attention(
        q, kq, vq, kv_bias=bias, k_scale=ks, v_scale=vs))
    assert rel_err(o, da._reference(q, kq, vq, bias, 64 ** -0.5, ks,
                                    vs)) <= TOL[dtype]
    assert torch.all(o[0] == 0)
    b7 = _one_launch("decode_attention", lambda: da.cached_attention(
        q, kvq.dequantize_kv(kq, ks, dtype), kvq.dequantize_kv(vq, vs, dtype),
        kv_bias=bias))
    assert torch.equal(o, b7)
    assert torch.equal(o, da.cached_attention(
        q, kq, vq, kv_bias=bias, k_scale=ks, v_scale=vs))


def test_decode_q8_reads_gathered_strides(gen):
    """K/V and scales as the engine hands them over: views into a wider
    pool gather, the scales transposed, nothing contiguous."""
    q, kq, ks, vq, vs, bias = _q8_inputs(gen, torch.float32, 2, 300)
    kv = torch.stack([kq, vq], dim=2)                   # (B, T, 2, H, D)
    kq_s, vq_s = kv.unbind(2)
    sc = torch.stack([ks, vs]).transpose(1, 2).contiguous().transpose(1, 2)
    ks_s, vs_s = sc.unbind(0)
    assert not any(x.is_contiguous() for x in (kq_s, vq_s, ks_s, vs_s))
    o = _one_launch("decode_attention_q8", lambda: da.cached_attention(
        q, kq_s, vq_s, kv_bias=bias, k_scale=ks_s, v_scale=vs_s))
    assert torch.equal(o, da.cached_attention(q, kq, vq, kv_bias=bias,
                                              k_scale=ks, v_scale=vs))
    assert rel_err(o, da._reference(q, kq, vq, bias, 64 ** -0.5, ks,
                                    vs)) <= 2e-5


def test_decode_q8_zero_scales_and_refusals(gen):
    q, kq, ks, vq, vs, _ = _q8_inputs(gen, torch.float32, 2, 40)
    o = da.cached_attention(q, kq, vq, k_scale=torch.zeros_like(ks),
                            v_scale=torch.zeros_like(vs))
    assert torch.isfinite(o).all() and torch.all(o == 0)
    q32 = torch.randn(2, 1, 3, 32, device="cuda", generator=gen)
    k32, s32 = kvq.quantize_kv(torch.randn(2, 40, 3, 32, device="cuda",
                                           generator=gen))
    with pytest.raises(ValueError, match="head_dim"):
        da.cached_attention(q32, k32, k32, k_scale=s32, v_scale=s32)
    with pytest.raises(TypeError):      # int8 K/V need their scales
        da.cached_attention(q, kq, vq)
    with pytest.raises(TypeError):      # scales need int8 K/V
        da.cached_attention(q, kq.float(), vq.float(), k_scale=ks,
                            v_scale=vs)
    with pytest.raises(ValueError, match="together"):
        da.cached_attention(q, kq, vq, k_scale=ks)
    qg = q.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        da.cached_attention(qg, kq, vq, k_scale=ks, v_scale=vs)
    with torch.no_grad():
        da.cached_attention(qg, kq, vq, k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_kv_on_the_card_equals_the_cpu(gen, dtype):
    x = (torch.randn(8, 100, 12, 64, device="cuda", generator=gen)
         * torch.rand(8, 100, 12, 1, device="cuda", generator=gen) * 5)
    x[0, 0, 0] = 0
    x = x.to(dtype)
    q, s = kvq.quantize_kv(x)
    qc, sc = kvq.quantize_kv(x.cpu())
    assert torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)
    assert torch.equal(kvq.dequantize_kv(q, s, dtype).cpu(),
                       kvq.dequantize_kv(qc, sc, dtype))


# -- threefry dropout ---------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,rate", [((1,), 0.1), ((3, 1001, 7), 0.1),
                                        ((2, 130, 1024), 0.1),
                                        ((5, 33), 0.5)])
def test_threefry_dropout_matches_plain_bitwise(gen, dtype, shape, rate):
    """The kernel (one launch forward, one for the gradient) equals its
    plain version on the same key bit for bit, output and gradient,
    through a strided input too."""
    key = tf.fold_in(tf.PRNGKey(len(shape)), 7)
    x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    dy = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    xg = x.clone().requires_grad_()
    y = _one_launch("threefry_dropout", lambda: tf.dropout(xg, rate, key))
    assert y.dtype == dtype and y.shape == x.shape
    assert torch.equal(y, tf.dropout_plain(x, rate, key))
    _one_launch("threefry_dropout", lambda: y.backward(dy))
    assert torch.equal(xg.grad, tf.dropout_plain(dy, rate, key))
    xt = x.transpose(0, -1)                 # not contiguous
    assert torch.equal(tf.dropout(xt, rate, key),
                       tf.dropout_plain(xt.contiguous(), rate, key))
    if x.numel() > 10_000:
        kept = float((y != 0).float().mean())
        assert abs(kept - (1 - rate)) < 0.01


# -- the flagship step's pieces on the card (no kernel of their own) ----------

@pytest.fixture
def nccl_world(gen):
    """A one-rank NCCL process group for the test (NCCL takes one rank a
    GPU)."""
    import torch.distributed as dist
    from apex_tpu_torch.parallel.multiproc import free_port, \
        initialize_distributed
    initialize_distributed("cuda", world_size=1, rank=0,
                           init_method=f"tcp://127.0.0.1:{free_port()}")
    yield gen
    dist.destroy_process_group()


def test_syncbn_and_ddp_at_world_one_over_nccl(nccl_world):
    """SyncBatchNorm's NCCL sums over a world of one give the local
    statistics: output, running statistics and gradients equal the
    plain formulas (fp32, 2e-5); DDP's reduction is exact (predivide 2
    and back) and keeps bf16 gradients bf16 under allreduce_always_fp32."""
    from apex_tpu_torch.parallel import DistributedDataParallel, \
        SyncBatchNorm
    gen = nccl_world
    x = (torch.randn(6, 8, 5, 5, device="cuda", generator=gen) * 2 + 1) \
        .contiguous(memory_format=torch.channels_last).requires_grad_()
    bn = SyncBatchNorm(8, device="cuda")
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        bn.bias.uniform_(-0.5, 0.5, generator=gen)
    y = bn(x)
    (y ** 3).sum().backward()
    xr = x.detach().clone().requires_grad_()
    w = bn.weight.detach().clone().requires_grad_()
    b = bn.bias.detach().clone().requires_grad_()
    mean = xr.mean((0, 2, 3))
    var = (xr * xr).mean((0, 2, 3)) - mean * mean
    want = (xr - mean.view(1, -1, 1, 1)) * torch.rsqrt(var + 1e-5).view(
        1, -1, 1, 1) * w.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)
    (want ** 3).sum().backward()
    n = x.numel() / 8
    assert rel_err(y, want) <= 2e-5
    assert rel_err(x.grad, xr.grad) <= 2e-5
    assert rel_err(bn.weight.grad, w.grad) <= 2e-5
    assert rel_err(bn.running_mean, 0.1 * mean) <= 2e-5
    assert rel_err(bn.running_var, 0.9 + 0.1 * var * n / (n - 1)) <= 2e-5
    g = {"a": torch.randn(5, device="cuda", generator=gen),
         "b": torch.randn(3, device="cuda", generator=gen).bfloat16()}
    out = DistributedDataParallel(gradient_predivide_factor=2.0,
                                  allreduce_always_fp32=True) \
        .reduce_gradients(g)
    assert torch.equal(out["a"], g["a"]) and torch.equal(out["b"], g["b"])
    assert out["b"].dtype == torch.bfloat16


def test_overflow_select_on_the_card(gen):
    """AmpOptimizer over the optax-style SGD on the card: an overflowed
    step keeps every bit of the params and the state (the schedule's
    count too), halves the scale and syncs nothing."""
    from apex_tpu_torch.amp import LossScaler
    from apex_tpu_torch.amp.optimizer import AmpOptimizer
    from apex_tpu_torch.optimizers import transforms as T
    tx = T.chain(T.add_decayed_weights(1e-4),
                 T.sgd(T.linear_schedule(0.01, 0.1, 5), momentum=0.9))
    opt = AmpOptimizer(tx, LossScaler("dynamic"))
    params = {"w": torch.randn(64, 32, device="cuda", generator=gen)
              .requires_grad_(),
              "b": torch.randn(32, device="cuda", generator=gen)
              .requires_grad_()}
    st = opt.init(params)
    good = {k: torch.randn_like(v) for k, v in params.items()}
    params, st = opt.step(params, good, st)
    bad = {k: v.clone() for k, v in good.items()}
    bad["w"][3, 4].fill_(float("inf"))
    snap = ([p.detach().clone() for p in params.values()],
            [t.clone() for t in torch.utils._pytree.tree_leaves(st.inner)])
    scale0 = st.loss_scalers[0].loss_scale.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        params, st = opt.step(params, bad, st)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(torch.equal(a, b) for a, b in zip(params.values(), snap[0]))
    assert all(torch.equal(a, b) for a, b in zip(
        torch.utils._pytree.tree_leaves(st.inner), snap[1]))
    assert int(st.inner[1][1].count) == 1
    assert torch.equal(st.loss_scalers[0].loss_scale, scale0 / 2)


# -- the train-state checkpoint and DCGAN on the card ------------------------

def test_checkpoint_roundtrip_of_a_cuda_train_state(gen, tmp_path):
    """An O3 train state on the card (bf16 params, fp32 momentum, the
    scaler's fp32/int32/bool leaves) restored onto a fresh state on the
    card: every leaf on the card, in its own dtype, bit for bit."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.amp import _amp_state
    from apex_tpu_torch.models import MLP
    from apex_tpu_torch.optimizers import transforms
    from apex_tpu_torch.utils import checkpoint
    saved = _amp_state._amp_state.opt_properties
    try:
        model, opt = amp.initialize(MLP(features=(64,), in_features=32),
                                    transforms.sgd(0.1, momentum=0.9),
                                    opt_level="O3", verbosity=0)
        params = model.init()
        st = opt.init(params)
        x = torch.randn(16, 32, device="cuda", generator=gen)
        y = torch.arange(16, device="cuda") % 10
        for _ in range(2):
            loss = torch.nn.functional.cross_entropy(
                model.apply(params, x).float(), y)
            with amp.scale_loss(loss, st) as scaled:
                g = torch.autograd.grad(scaled, list(params.values()))
            params, st = opt.step(params, dict(zip(params, g)), st)
        state = {"params": params, "opt_state": st, "epoch": 1}
        checkpoint.save(str(tmp_path / "c"), state)
        fresh = model.init()
        restored = checkpoint.restore(
            str(tmp_path / "c"),
            {"params": fresh, "opt_state": opt.init(fresh), "epoch": 0})
    finally:
        _amp_state._amp_state.opt_properties = saved
    assert restored["epoch"] == 1
    got = torch.utils._pytree.tree_leaves((restored["params"],
                                           restored["opt_state"]))
    want = torch.utils._pytree.tree_leaves((params, st))
    assert any(t.dtype == torch.bfloat16 for t in want)
    assert any(t.dtype == torch.bool for t in want)
    for a, b in zip(got, want):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_dcgan_o0_on_the_card_matches_the_cpu(gen):
    """``dcgan_main_amp.train()`` at O0 (base 8, B 4, 2 iterations, TF32
    off) on the card against the same run on the CPU from the same
    weights and batches: losses and running statistics within 1e-4
    scale-aware; params within 1e-4 but for Adam's sign-of-noise steps
    (a gradient within rounding of zero steps by lr either way): every
    param within 2 lr, and under 0.1% of them past 1e-4."""
    from apex_tpu_torch.amp import _amp_state
    from apex_tpu_torch.examples import dcgan_main_amp as dcgan
    args = dcgan.parse_args(["--b", "4", "--iters", "2", "--opt-level",
                             "O0", "--print-freq", "0"])
    saved = (_amp_state._amp_state.opt_properties,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = [dcgan.train(args, device=d, base_features=8)
                for d in ("cuda", "cpu")]
    finally:
        (_amp_state._amp_state.opt_properties,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    card, cpu = runs
    for k in ("loss_d", "loss_g"):
        assert rel_err(torch.tensor(card[k]), torch.tensor(cpu[k])) <= 1e-4
    for side in ("G", "D"):
        for (name, a), (_, b) in zip(card[side].unwrapped.named_buffers(),
                                     cpu[side].unwrapped.named_buffers()):
            assert rel_err(a.cpu(), b) <= 1e-4, name
    lr, far, total = args.lr, 0, 0
    for side in ("pG", "pD"):
        for name, a in card[side].items():
            b = cpu[side][name].detach()
            diff = (a.detach().cpu() - b).abs()
            assert diff.max().item() <= 2 * lr * 1.001, name
            far += int((diff > 1e-4 * (b.abs().max() + 1)).sum())
            total += diff.numel()
    assert far <= 1e-3 * total, (far, total)


# -- the sequence-parallel call modes (ring hops, Ulysses) -------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_hop_lse_merge_equals_one_call_over_the_joined_keys(gen, dtype):
    """B4 with ``return_lse`` on two key blocks, merged with the ring's
    log-sum-exp rule, equals one call over the joined keys; a batch row
    whose keys are all masked in one block takes only the other's."""
    b, s, h, d = 2, 96, 3, 64
    q, k1, v1, k2, v2 = (torch.randn(b, s, h, d, device="cuda",
                                     generator=gen).to(dtype)
                         for _ in range(5))
    m1 = torch.zeros(b, s, device="cuda")
    m1[1] = fa.NEG_INF
    m2 = torch.zeros(b, s, device="cuda")
    o1, l1 = _one_launch("flash_fwd", lambda: fa.flash_attention(
        q, k1, v1, kv_mask=m1, return_lse=True))
    o2, l2 = fa.flash_attention(q, k2, v2, kv_mask=m2, return_lse=True)
    assert (l1[1] <= fa.NEG_INF / 2).all() and (o1[1] == 0).all()
    lse = torch.logaddexp(l1, l2)
    t = lambda w: w.permute(0, 2, 1)[..., None]
    merged = o1.float() * t(torch.exp(l1 - lse)) \
        + o2.float() * t(torch.exp(l2 - lse))
    want, want_lse = fa._reference(q, torch.cat([k1, k2], 1),
                                   torch.cat([v1, v2], 1),
                                   torch.cat([m1, m2], 1), False,
                                   1.0 / d ** 0.5, return_lse=True)
    assert rel_err(merged, want) <= TOL[dtype]
    assert rel_err(lse, want_lse) <= TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_with_an_lse_cotangent(gen, dtype, causal):
    """B5 and B6 with ``delta - dlse`` (a ring hop's backward, whose lse
    feeds the merge) against their plain versions on the same delta."""
    b, s, h, d = 2, 160, 3, 64
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda",
                               generator=gen).to(dtype) for _ in range(4))
    scale = 1.0 / d ** 0.5
    o, lse = fa._reference(q, k, v, None, causal, scale, return_lse=True)
    dlse = torch.randn(b, h, s, device="cuda", generator=gen)
    delta = ((do.float() * o.float()).sum(-1).permute(0, 2, 1)
             - dlse).contiguous()
    args = (q, k, v, do, lse, delta, None, causal, scale)
    dq = _one_launch("flash_bwd_dq", lambda: fa.flash_attention_bwd_dq(
        *args))
    dk, dv = _one_launch("flash_bwd_dkv",
                         lambda: fa.flash_attention_bwd_dkv(*args))
    want = (fa._bwd_dq_reference(*args),) + fa._bwd_dkv_reference(*args)
    for got, ref in zip((dq, dk, dv), want):
        assert rel_err(got, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["fwd", "dq", "dkv"])
def test_flash_dropout_at_ring_offsets_matches_plain(gen, dtype, which):
    """B4d, B5d and B6d with a ring hop's row and column offsets (rank 1
    of 2 holding rank 0's block, and the diagonal at 512) against their
    plain versions on the same seed array."""
    b, s, h, d = 2, 128, 3, 64
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda",
                               generator=gen).to(dtype) for _ in range(4))
    scale = 1.0 / d ** 0.5
    for offsets, causal in (((s, 0, 0, h), False), ((512, 512, 0, h), True)):
        seed = fa.seed_array(1234, offsets, num_heads=h, device="cuda")
        po, plse = fa._reference(q, k, v, None, causal, scale,
                                 return_lse=True, dropout_rate=0.1,
                                 seed=seed)
        delta = (do.float() * po.float()).sum(-1).permute(0, 2, 1) \
            .contiguous()
        bargs = (q, k, v, do, plse, delta, None, causal, scale, 0.1, seed)
        if which == "fwd":
            got = _one_launch("flash_fwd_dropout",
                              lambda: fa.flash_attention_fwd(
                                  q, k, v, None, causal, scale, 0.1,
                                  seed))[0]
            want = po
        elif which == "dq":
            got = _one_launch("flash_bwd_dq_dropout",
                              lambda: fa.flash_attention_bwd_dq(*bargs))
            want = fa._bwd_dq_reference(*bargs)
        else:
            got = torch.cat(_one_launch(
                "flash_bwd_dkv_dropout",
                lambda: fa.flash_attention_bwd_dkv(*bargs)))
            want = torch.cat(fa._bwd_dkv_reference(*bargs))
        assert rel_err(got, want) <= TOL[dtype], offsets


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_threefry_dropout_window_is_the_dense_slice(gen, dtype):
    """A sequence-parallel rank's window of the hidden dropout (one
    launch of the windowed loop) equals its plain version and the slice
    of the whole tensor's call, bit for bit, output and gradient."""
    key = tf.fold_in(tf.PRNGKey(3), 5)
    x = torch.randn(3, 256, 768, device="cuda", generator=gen).to(dtype)
    full = tf.dropout(x, 0.1, key)
    for n in (2, 4):
        sl = 256 // n
        for r in range(n):
            win = tf.window(x.shape, 1, r * sl, sl)
            part = x[:, r * sl:(r + 1) * sl].clone().requires_grad_()
            got = _one_launch("threefry_dropout",
                              lambda: tf.dropout(part, 0.1, key, win))
            assert torch.equal(got, full[:, r * sl:(r + 1) * sl])
            assert torch.equal(got, tf.dropout_plain(part.detach(), 0.1, key,
                                                     win))
            dy = torch.ones_like(got)
            got.backward(dy)
            assert torch.equal(part.grad, tf.dropout_plain(dy, 0.1, key,
                                                           win))


def test_sequence_parallel_at_a_world_of_one_is_flash(gen):
    """Ring and Ulysses without a process group (a world of one) on card
    tensors: the flash kernels' output, causal and not."""
    sq = importlib.import_module("apex_tpu_torch.parallel.sequence")
    q, k, v = (torch.randn(2, 128, 4, 64, device="cuda",
                           generator=gen).to(torch.bfloat16)
               for _ in range(3))
    for causal in (False, True):
        want = fa.flash_attention(q, k, v, causal=causal)
        for fn in (sq.ring_attention, sq.ulysses_attention):
            assert torch.equal(fn(q, k, v, causal=causal), want)


def test_bert_token_type_gradient_repeats_its_bits(gen):
    """BERT's token-type rows get every token of a type (4096 into one row
    here): the model takes them as a one-hot product, whose backward
    repeats its bits, where the embedding gather's backward on the card
    sums such a row in no fixed order."""
    bert = importlib.import_module("apex_tpu_torch.models.bert")
    cfg = bert.BertConfig(vocab_size=64, hidden_size=1024,
                          num_hidden_layers=1, num_attention_heads=16,
                          intermediate_size=64, hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
    enc = bert.BertEncoder(cfg, device="cuda")
    ids = torch.randint(0, 64, (32, 128), device="cuda", generator=gen)
    r = torch.randn(32, 128, 1024, device="cuda", generator=gen)
    grads = []
    for _ in range(20):
        enc.zero_grad()
        (enc(ids) * r).sum().backward()
        grads.append(enc.token_type_embeddings.weight.grad.clone())
    assert all(torch.equal(g, grads[0]) for g in grads)


NOISE_ULPS = 4


def test_sampler_and_row_batched_threefry_match_the_cpu(gen):
    """GPT-2's vocabulary, 8 rows of every class: the keys and the
    uniform bits equal the CPU's, the noise is within NOISE_ULPS
    float32 epsilons of max(|x|, 1) (the card's logs may round apart),
    and the tokens equal the CPU's unless a row's top two scores lie
    within 1e-4."""
    smp = importlib.import_module("apex_tpu_torch.ops.sampling")
    v = 50257
    logits = torch.randn(8, v, device="cuda", generator=gen) * 3
    temp = torch.tensor([0, .8, 1, .7, .9, 1.3, .5, 1], device="cuda")
    top_k = torch.tensor([0, 0, 40, 0, 20, 0, 1, 50257], device="cuda",
                         dtype=torch.int32)
    top_p = torch.tensor([1, 1, 1, .9, .8, .95, 1, .5], device="cuda")
    seeds = torch.arange(8, device="cuda") * 7919 + 1
    pos = torch.arange(8, device="cuda") * 100 + 3
    keys = tf.fold_in_rows(tf.fold_in_rows(tf.key_rows(seeds), pos), 0)
    keys_cpu = tf.fold_in_rows(tf.fold_in_rows(tf.key_rows(seeds.cpu()),
                                               pos.cpu()), 0)
    assert torch.equal(keys.cpu(), keys_cpu)
    tiny = torch.finfo(torch.float32).tiny
    assert torch.equal(tf.uniform_rows(keys, v, tiny, 1.0).cpu(),
                       tf.uniform_rows(keys_cpu, v, tiny, 1.0))
    noise = smp.sampling_noise(seeds, pos, v).cpu()
    want = smp.sampling_noise(seeds.cpu(), pos.cpu(), v)
    eps = torch.finfo(torch.float32).eps
    assert ((noise - want).abs() / (eps * want.abs().clamp_min(1))).max() \
        <= NOISE_ULPS
    args = (logits, temp, top_k, top_p, seeds, pos)
    ids, fin = smp.sample_tokens(*args)
    ids_cpu, fin_cpu = smp.sample_tokens(*(a.cpu() for a in args))
    assert torch.equal(fin.cpu(), fin_cpu) and bool(fin_cpu.all())
    score = smp.processed_logits(*(a.cpu() for a in args[:4])) + want
    top2 = score.topk(2).values
    near = (top2[:, 0] - top2[:, 1]) < 1e-4
    assert torch.equal(ids.cpu()[~near], ids_cpu[~near])


def test_disagg_tight_prefill_pool_hands_off_on_the_card(gen):
    """The disaggregated server on the card, its prefill engine on a
    stream of its own and its pool one full context (every hand-off's
    blocks are rewritten by the next prefill at once, which must wait
    for the copy): the tokens are the monolithic server's, both pools
    audit clean after every step, and the prefill pool launches B4 once
    a layer a prompt, as the monolithic server does."""
    gpt = importlib.import_module("apex_tpu_torch.models.gpt")
    serving = importlib.import_module("apex_tpu_torch.serving")
    cfg = gpt.GPTConfig(vocab_size=64, hidden_size=128, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=256,
                        max_position_embeddings=128, hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)
    sd = gpt.GPTLMHeadModel(cfg, device="cuda", seed=0).state_dict()
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 64, size=int(rng.randint(4, 100))).tolist()
               for _ in range(8)]
    kw = dict(device="cuda", max_batch_size=4, block_size=16,
              cache_dtype=torch.float32, enable_chunked_prefill=False)
    mono = serving.InferenceServer(cfg, sd, **kw)
    before = launch_counts()
    want = mono.generate(prompts, 24)
    mono_flash = launch_counts()["flash_fwd"] - before.get("flash_fwd", 0)
    srv = serving.InferenceServer(
        cfg, sd, enable_disagg=True,
        disagg_prefill_blocks=mono.engine.blocks_per_seq + 1, **kw)
    assert srv.prefill_engine.stream is not None
    before = launch_counts()
    reqs = [srv.submit(p, 24) for p in prompts]
    while srv.has_work:
        srv.step()
        srv.audit()
    torch.cuda.synchronize()
    flash = launch_counts()["flash_fwd"] - before.get("flash_fwd", 0)
    st = srv.stats()
    assert [r.generated for r in reqs] == want
    assert st["disagg"]["handoff"]["requests"] == len(prompts)
    assert flash == mono_flash == cfg.num_hidden_layers * len(prompts)


def test_offload_promote_into_blocks_a_handoff_freed(gen):
    """The disaggregated server with the offload tier on the card: the
    prefill pool (the cache home, on a stream of its own) holds one
    context, so pass 2's promotes import into blocks a hand-off released
    in the same step, which the decode stream's copy may still be
    reading; the import waits for it.  Tokens equal a roomy monolithic
    server's without offload, both pools audit clean after every step,
    and the demote exports and promote imports ran in the prefill
    pool."""
    gpt = importlib.import_module("apex_tpu_torch.models.gpt")
    serving = importlib.import_module("apex_tpu_torch.serving")
    cfg = gpt.GPTConfig(vocab_size=64, hidden_size=128, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=256,
                        max_position_embeddings=128, hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)
    sd = gpt.GPTLMHeadModel(cfg, device="cuda", seed=0).state_dict()
    rng = np.random.RandomState(1)
    # 6 full blocks and a tail each: 7 blocks, more than half the pool
    prompts = [rng.randint(0, 64, size=int(rng.randint(97, 104))).tolist()
               for _ in range(4)]
    kw = dict(device="cuda", max_batch_size=4, block_size=16,
              cache_dtype=torch.float32, enable_chunked_prefill=False)
    roomy = serving.InferenceServer(cfg, sd, **kw)
    want = [roomy.generate(prompts, 24) for _ in range(2)]
    srv = serving.InferenceServer(
        cfg, sd, enable_disagg=True, enable_kv_offload=True,
        disagg_prefill_blocks=roomy.engine.blocks_per_seq + 1, **kw)
    freed, reused, exports = set(), [], []
    release = srv.prefill_scheduler.release_handoff
    imports = srv.prefill_engine.import_blocks
    export = srv.prefill_engine.export_blocks

    def release_and_note(req):
        freed.update(req.block_table)
        return release(req)

    def import_and_note(ids, payload):
        reused.append(len(freed & set(ids)))
        return imports(ids, payload)

    def export_and_note(ids, **kwargs):
        exports.append(len(ids))
        return export(ids, **kwargs)

    srv.prefill_scheduler.release_handoff = release_and_note
    srv.prefill_engine.import_blocks = import_and_note
    srv.prefill_engine.export_blocks = export_and_note
    got = []
    for _ in range(2):
        reqs = [srv.submit(p, 24) for p in prompts]
        while srv.has_work:
            freed.clear()
            srv.step()
            srv.audit()
        got.append([r.generated for r in reqs])
    torch.cuda.synchronize()
    st = srv.stats()["offload"]
    assert got == want
    assert st["demotes"] == sum(exports) > 0
    assert st["promotes_host"] > 0 and st["crc_rejects"] == 0
    assert len(reused) == st["promote_ms"]["count"]
    assert max(reused) > 0, "no promote reused blocks a hand-off freed"

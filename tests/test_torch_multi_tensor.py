"""apex_tpu_torch multi-tensor ops and flat buffers against apex_tpu's.

Same trees (odd sizes, as ``tests/L0/test_multi_tensor.py`` uses), made
with ``numpy.random.RandomState``, go through ``apex_tpu.ops.multi_tensor``
/ ``apex_tpu.ops.flatten`` and their port twins.  Both compute in fp32:
values agree to 1e-6 scale-aware, overflow flags exactly.  Trees are
dicts; the two packages order dict leaves differently (JAX by sorted key,
PyTorch by insertion), so leaves are compared by key, never by position.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch.ops.flatten import flatten, flatten_like, unflatten
from apex_tpu_torch.ops.multi_tensor import (
    multi_tensor_axpby,
    multi_tensor_l2norm,
    multi_tensor_scale,
    multi_tensor_unscale,
    tree_any_nonfinite,
)

jmt = importlib.import_module("apex_tpu.ops.multi_tensor")
jfl = importlib.import_module("apex_tpu.ops.flatten")

torch.set_num_threads(1)

SIZES = [27, 55, 34, 35, 29, 19]
TOL = 1e-6


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def _trees(seed, bad=None, key="t3", idx=0, sizes=SIZES):
    rng = np.random.RandomState(seed)
    np_tree = {f"t{i}": rng.randn(n).astype(np.float32)
               for i, n in enumerate(sizes)}
    if bad is not None:
        np_tree[key][idx] = bad
    return ({k: jnp.asarray(v) for k, v in np_tree.items()},
            {k: torch.from_numpy(v.copy()) for k, v in np_tree.items()})


def _same(port_tree, jax_tree, dtype=torch.float32):
    assert set(port_tree) == set(jax_tree)
    for k, v in port_tree.items():
        assert v.dtype == dtype
        assert rel_err(v.float().numpy(), jax_tree[k]) <= TOL, k


POSITIONS = [(None, "t0", 0), (np.inf, "t0", 0), (-np.inf, "t3", 34),
             (np.nan, "t5", 18)]


@pytest.mark.parametrize("bad,key,idx", POSITIONS)
def test_scale_and_unscale_match_jax(bad, key, idx):
    jt, pt = _trees(0, bad, key, idx)
    jout, jflag = jmt.multi_tensor_scale(jt, 0.5)
    out, flag = multi_tensor_scale(pt, 0.5)
    assert bool(flag) == bool(jflag) == (bad is not None)
    assert flag.dtype == torch.bool and flag.ndim == 0
    if bad is None:
        _same(out, jout)
    jout, jflag = jmt.multi_tensor_unscale(jt, 4.0, out_dtype=jnp.float32)
    out, flag = multi_tensor_unscale(pt, torch.tensor(4.0),
                                     out_dtype=torch.float32)
    assert bool(flag) == bool(jflag)
    if bad is None:
        _same(out, jout)


def test_scale_flags_overflow_from_the_scaling_itself():
    _, flag = multi_tensor_scale({"t": torch.full((8,), 1e38)}, 1e10)
    _, jflag = jmt.multi_tensor_scale({"t": jnp.full((8,), 1e38)}, 1e10)
    assert bool(flag) and bool(jflag)


def test_scale_casts_to_out_dtype():
    jt, pt = _trees(1)
    out, _ = multi_tensor_scale(pt, 2.0, out_dtype=torch.bfloat16)
    jout, _ = jmt.multi_tensor_scale(jt, 2.0, out_dtype=jnp.bfloat16)
    for k in out:
        assert out[k].dtype == torch.bfloat16
        assert rel_err(out[k].float().numpy(),
                       np.asarray(jout[k], np.float32)) <= 1e-2


@pytest.mark.parametrize("arg_to_check", [-1, 0, 1])
@pytest.mark.parametrize("bad_in", [None, "x", "y"])
def test_axpby_arg_to_check_matches_jax(arg_to_check, bad_in):
    jx, px = _trees(2, np.inf if bad_in == "x" else None)
    jy, py = _trees(3, np.nan if bad_in == "y" else None)
    jout, jflag = jmt.multi_tensor_axpby(2.0, jx, -0.5, jy,
                                         arg_to_check=arg_to_check)
    out, flag = multi_tensor_axpby(2.0, px, -0.5, py,
                                   arg_to_check=arg_to_check)
    assert bool(flag) == bool(jflag)
    expect = bad_in is not None and (arg_to_check == -1 or
                                     (arg_to_check == 0) == (bad_in == "x"))
    assert bool(flag) == expect
    if bad_in is None:
        _same(out, jout)
    with pytest.raises(ValueError):
        multi_tensor_axpby(1.0, px, 1.0, py, arg_to_check=2)


@pytest.mark.parametrize("per_tensor", [False, True])
def test_l2norm_matches_jax(per_tensor):
    jt, pt = _trees(4)
    want = jmt.multi_tensor_l2norm(jt, per_tensor=per_tensor)
    got = multi_tensor_l2norm(pt, per_tensor=per_tensor)
    if not per_tensor:
        assert rel_err(got.numpy(), want) <= TOL
        return
    assert rel_err(got[0].numpy(), want[0]) <= TOL
    for k in got[1]:
        assert rel_err(got[1][k].numpy(), want[1][k]) <= TOL


@pytest.mark.parametrize("bad", [None, np.inf, np.nan])
def test_tree_any_nonfinite_matches_jax(bad):
    jt, pt = _trees(5, bad, "t2", 7)
    pt["ids"] = torch.arange(4)           # integer leaves cannot overflow
    jt["ids"] = jnp.arange(4)
    assert bool(tree_any_nonfinite(pt)) == bool(
        jmt.tree_any_nonfinite(jt)) == (bad is not None)


@pytest.mark.parametrize("pad_to", [1, 128])
def test_flatten_round_trip_matches_jax(pad_to):
    rng = np.random.RandomState(6)
    # keys in sorted order, so both packages lay the buffer out alike
    shapes = {"b": (1000,), "k": (3, 4, 5), "s": (), "w": (37, 13)}
    np_tree = {k: np.asarray(rng.randn(*s), np.float32)
               for k, s in shapes.items()}
    jflat, jspec = jfl.flatten({k: jnp.asarray(v) for k, v in np_tree.items()},
                               dtype=jnp.float32, pad_to=pad_to)
    tree = {k: torch.from_numpy(v.copy()) for k, v in np_tree.items()}
    flat, spec = flatten(tree, dtype=torch.float32, pad_to=pad_to)
    assert flat.shape == tuple(jflat.shape) and spec.total == jspec.total
    assert torch.all(flat[spec.total:] == 0)
    back = unflatten(flat, spec)
    jback = jfl.unflatten(jflat, jspec)
    for k in shapes:
        assert back[k].shape == shapes[k]
        np.testing.assert_array_equal(back[k].numpy(), np_tree[k])
        np.testing.assert_array_equal(np.asarray(jback[k]), np_tree[k])
    # leaves are views of the buffer: an in-place update reaches them
    flat.mul_(2.0)
    np.testing.assert_array_equal(back["w"].numpy(), 2 * np_tree["w"])
    again = flatten_like(tree, spec, dtype=torch.float32, pad_to=pad_to)
    np.testing.assert_array_equal(again.numpy(), np.asarray(jflat))


def test_unflatten_casts_back_half_leaves():
    tree = {"a": torch.ones(3, dtype=torch.bfloat16), "b": torch.zeros(2)}
    flat, spec = flatten(tree)
    assert flat.dtype == torch.float32
    back = unflatten(flat, spec)
    assert back["a"].dtype == torch.bfloat16 and back["b"].dtype == \
        torch.float32
    assert unflatten(flat, spec, cast_back=False)["a"].dtype == torch.float32
    with pytest.raises(ValueError):
        flatten_like({"a": tree["a"]}, spec)

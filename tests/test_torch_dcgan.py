"""The port's DCGAN (``apex_tpu_torch.models.dcgan`` and
``apex_tpu_torch.examples.dcgan_main_amp``) against the JAX package on
the CPU.

- every layer's output (flax's ``capture_intermediates`` against
  forward hooks) and the whole forward of the ``Generator`` and the
  ``Discriminator``, weights from ``dcgan_params_from_jax``, at
  ``base_features=8``, B 4, fp32: 1e-5 scale-aware;
- one ``train_step`` against the JAX example's ``train_step`` (built as
  ``examples/dcgan/main_amp.py`` builds it, from ``apex_tpu`` pieces) on
  the same weights, batch and noise: at O0 the params, running
  statistics, losses and the three scales within 1e-5 scale-aware
  (scales equal); at O1 within 2e-2.  Adam's first step moves each
  param by lr times the sign of its gradient: the few gradient elements
  within float32 rounding of zero (``NOISE_FLOOR``) may step either way
  in either framework, so they are held to that bound, 2 lr, and must be
  under 0.1% of the elements;
- the Discriminator's 64-pixel error;
- ``transforms.adam`` against ``optax.adam`` over 10 steps (rtol and
  atol 1e-6) and ``sigmoid_binary_cross_entropy`` against optax's;
- ``--ddp`` on a world of one equal to the run without it, bit for
  bit; an inf in the real batch skips D's step and halves scaler 0
  only, while G steps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from apex_tpu import amp as jamp
from apex_tpu import models as jmodels
from apex_tpu_torch import amp
from apex_tpu_torch import models as tm
from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.examples import dcgan_main_amp as twin
from apex_tpu_torch.optimizers import transforms

BASE = 8
B = 4
NZ = 100


@pytest.fixture(autouse=True)
def _no_leaked_o1():
    """O1's patches are process-global in both packages: remove them and
    the port's policy after every test."""
    saved = _amp_state._amp_state.opt_properties
    yield
    jamp.remove_o1_patches()
    amp.remove_o1_patches()
    _amp_state._amp_state.opt_properties = saved
    _amp_state._amp_state.casts_disabled = False


def scale_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_vars():
    G = jmodels.Generator(z_dim=NZ, base_features=BASE)
    D = jmodels.Discriminator(base_features=BASE)
    rngG, rngD = jax.random.split(jax.random.PRNGKey(0))
    vg = jax.jit(lambda k: G.init(k, jnp.ones((1, NZ)), train=True))(rngG)
    vd = jax.jit(lambda k: D.init(k, jnp.ones((1, 64, 64, 3)),
                                  train=True))(rngD)
    return _np_tree(vg), _np_tree(vd)


def _inputs(seed=0):
    args = twin.parse_args(["--b", str(B)])
    return next(twin.synthetic_batches(args, seed))


def _port_models(jax_vars):
    g = tm.Generator(NZ, BASE, device="cpu", seed=None)
    g.load_state_dict(tm.dcgan_params_from_jax(jax_vars[0]))
    d = tm.Discriminator(BASE, device="cpu", seed=None)
    d.load_state_dict(tm.dcgan_params_from_jax(jax_vars[1]))
    return g, d


def _hooked(module, x):
    outs = {}
    hooks = [m.register_forward_hook(
        lambda _m, _a, out, name=name: outs.__setitem__(name, out))
        for name, m in module.named_children()]
    try:
        y = module(x, train=True)
    finally:
        for h in hooks:
            h.remove()
    return y, outs


def test_layers_and_forward_match_jax(jax_vars):
    real, z = _inputs()
    g, d = _port_models(jax_vars)
    checks = []
    for jm, vars_, port, x in (
            (jmodels.Generator(z_dim=NZ, base_features=BASE), jax_vars[0], g,
             z),
            (jmodels.Discriminator(base_features=BASE), jax_vars[1], d,
             real)):
        want, mut = jm.apply(vars_, jnp.asarray(x), train=True,
                             capture_intermediates=True,
                             mutable=["intermediates", "batch_stats"])
        inter = mut["intermediates"]
        got, outs = _hooked(port, torch.from_numpy(x))
        checks.append(scale_err(got.detach(), want))
        assert set(outs) == set(inter) - {"__call__"}
        for name, out in outs.items():
            ref = np.asarray(inter[name]["__call__"][0])
            checks.append(scale_err(out.detach().permute(0, 2, 3, 1), ref))
    assert max(checks) < 1e-5, checks


def test_discriminator_needs_64_pixels():
    d = tm.Discriminator(BASE, device="cpu")
    with pytest.raises(ValueError, match="64x64"):
        d(torch.zeros(2, 32, 32, 3))


def _jax_step(opt_level):
    """The JAX example's ``train_step`` (``examples/dcgan/main_amp.py``),
    at ``base_features=BASE``."""
    netG = jmodels.Generator(z_dim=NZ, base_features=BASE)
    netD = jmodels.Discriminator(base_features=BASE)
    [netG, netD], [optG, optD] = jamp.initialize(
        [netG, netD], [optax.adam(2e-4, b1=0.5, b2=0.999),
                       optax.adam(2e-4, b1=0.5, b2=0.999)],
        opt_level=opt_level, num_losses=3, verbosity=0)

    def bce_logits(logits, target):
        return optax.sigmoid_binary_cross_entropy(
            logits, jnp.full_like(logits, target)).mean()

    @jax.jit
    def train_step(pG, sG, pD, sD, optG_state, optD_state, real, z):
        def d_real_loss(pd):
            logits, upd = netD.apply({"params": pd, "batch_stats": sD},
                                     real, train=True,
                                     mutable=["batch_stats"])
            loss = bce_logits(logits, 1.0)
            with jamp.scale_loss(loss, optD_state, loss_id=0) as scaled:
                return scaled, (loss, upd["batch_stats"])
        gradsDr, (errD_real, sD1) = jax.grad(d_real_loss, has_aux=True)(pD)
        fake, _ = netG.apply({"params": pG, "batch_stats": sG}, z,
                             train=True, mutable=["batch_stats"])

        def d_fake_loss(pd):
            logits, upd = netD.apply({"params": pd, "batch_stats": sD1},
                                     jax.lax.stop_gradient(fake),
                                     train=True, mutable=["batch_stats"])
            loss = bce_logits(logits, 0.0)
            with jamp.scale_loss(loss, optD_state, loss_id=1) as scaled:
                return scaled, (loss, upd["batch_stats"])
        gradsDf, (errD_fake, sD2) = jax.grad(d_fake_loss, has_aux=True)(pD)
        gDr, ovfr, st1 = optD.unscale_grads(gradsDr, optD_state, loss_id=0)
        gD, ovff, st2 = optD.unscale_grads(gradsDf, st1, loss_id=1,
                                           stashed=gDr)
        pD_new, optD_state3 = optD.apply_gradients(pD, gD, st2, ovfr | ovff)

        def g_loss(pg):
            fake_g, updG = netG.apply({"params": pg, "batch_stats": sG}, z,
                                      train=True, mutable=["batch_stats"])
            logits = netD.apply({"params": pD_new, "batch_stats": sD2},
                                fake_g, train=True,
                                mutable=["batch_stats"])[0]
            loss = bce_logits(logits, 1.0)
            with jamp.scale_loss(loss, optG_state, loss_id=2) as scaled:
                return scaled, (loss, updG["batch_stats"])
        gradsG, (errG, sG2) = jax.grad(g_loss, has_aux=True)(pG)
        pG_new, optG_state1 = optG.step(pG, gradsG, optG_state, loss_id=2)
        return (pG_new, sG2, pD_new, sD2, optG_state1, optD_state3,
                errD_real + errD_fake, errG, gradsG, gD)

    return train_step, optG, optD


# Adam's first step is lr * g / (|g| + eps): the sign of g wherever
# |g| >> eps.  A gradient element within float32 rounding of zero (below
# NOISE_FLOOR times its tensor's largest) has no sign of its own, and
# either framework's rounding may step it either way by lr.
NOISE_FLOOR = 1e-5
LR = 2e-4


def _compare_step(jax_vars, opt_level):
    """Scale-aware errors of the port's step against the JAX step, by
    name: losses, params (outside the noise floor), running statistics;
    the scales must be equal.  Params inside the noise floor must move
    by at most 2 lr, and be under 0.1% of the elements."""
    vg, vd = jax_vars
    step, optG, optD = _jax_step(opt_level)
    real, z = _inputs()
    out = step(vg["params"], vg["batch_stats"], vd["params"],
               vd["batch_stats"], optG.init(vg["params"]),
               optD.init(vd["params"]), real, z)
    jpG, jsG, jpD, jsD, joG, joD, jerrD, jerrG, jgG, jgD = _np_tree(out)

    args = twin.parse_args(["--b", str(B), "--opt-level", opt_level,
                            "--iters", "1", "--print-freq", "0"])
    got = twin.train(args, device="cpu", base_features=BASE,
                     state_dicts=(tm.dcgan_params_from_jax(vg),
                                  tm.dcgan_params_from_jax(vd)),
                     batches=[(real, z)])
    errs = {"loss_d": scale_err(got["loss_d"][0], jerrD),
            "loss_g": scale_err(got["loss_g"][0], jerrG)}
    noisy = total = 0
    for side, (params, stats, grads), module, port_params in (
            ("G", (jpG, jsG, jgG), got["G"].unwrapped, got["pG"]),
            ("D", (jpD, jsD, jgD), got["D"].unwrapped, got["pD"])):
        want = tm.dcgan_params_from_jax({"params": params,
                                         "batch_stats": stats})
        g = tm.dcgan_params_from_jax({"params": grads})
        have = dict(port_params)
        have.update(module.named_buffers())
        assert set(have) == set(want)
        for name in want:
            h, w = have[name].detach(), want[name]
            if name in g:
                floor = g[name].abs() < NOISE_FLOOR * g[name].abs().max()
                assert bool(((h - w)[floor].abs() <= 2 * LR * 1.001).all())
                noisy += int(floor.sum())
                total += floor.numel()
                h, w = h[~floor], w[~floor]
            errs[f"{side}.{name}"] = scale_err(h, w)
    assert noisy <= 1e-3 * total, (noisy, total)
    scales = [float(joD.loss_scalers[0].loss_scale),
              float(joD.loss_scalers[1].loss_scale),
              float(joG.loss_scalers[2].loss_scale)]
    assert got["loss_scales"] == scales
    return errs


def test_o0_step_matches_jax_example(jax_vars):
    errs = _compare_step(jax_vars, "O0")
    assert max(errs.values()) < 1e-5, max(errs.items(), key=lambda kv: kv[1])


def test_o1_step_matches_jax_example(jax_vars):
    errs = _compare_step(jax_vars, "O1")
    assert max(errs.values()) < 2e-2, max(errs.items(), key=lambda kv: kv[1])


def test_adam_matches_optax():
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(5, 3).astype(np.float32),
              "b": rng.randn(4).astype(np.float32)}
    jtx, ttx = optax.adam(2e-4, b1=0.5), transforms.adam(2e-4, b1=0.5)
    jp, tp = params, {k: torch.from_numpy(v.copy())
                      for k, v in params.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for _ in range(10):
        g = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in params.items()}
        u, js = jtx.update(g, js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = ttx.update({k: torch.from_numpy(v) for k, v in g.items()},
                            ts, tp)
        tp = transforms.apply_updates(tp, tu)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)
    assert int(ts[0].count) == int(js[0].count) == 10
    x = rng.randn(4, 7).astype(np.float32) * 5
    y = (rng.rand(4, 7) < 0.5).astype(np.float32)
    np.testing.assert_allclose(
        transforms.sigmoid_binary_cross_entropy(torch.from_numpy(x),
                                                torch.from_numpy(y)).numpy(),
        np.asarray(optax.sigmoid_binary_cross_entropy(x, y)),
        rtol=1e-6, atol=1e-6)


def test_ddp_world_of_one_and_the_overflow_step():
    args = twin.parse_args(["--b", "2", "--opt-level", "O0", "--iters", "2",
                            "--print-freq", "0"])
    base = twin.train(args, device="cpu", base_features=BASE)
    args.ddp = True
    with_ddp = twin.train(args, device="cpu", base_features=BASE)
    assert base["loss_d"] == with_ddp["loss_d"]
    assert base["loss_g"] == with_ddp["loss_g"]
    for k in base["pG"]:
        assert torch.equal(base["pG"][k], with_ddp["pG"][k])
    for k in base["pD"]:
        assert torch.equal(base["pD"][k], with_ddp["pD"][k])

    # an inf in the real batch: D skips, only scaler 0 halves, G steps
    args = twin.parse_args(["--b", "2", "--opt-level", "O1", "--iters", "1",
                            "--print-freq", "0"])
    real, z = next(twin.synthetic_batches(args))
    real[0, 0, 0, 0] = np.inf
    G, D, optG, optD, pG, pD, sG, sD = twin.build(args, device="cpu",
                                                  base_features=BASE)
    before = ({k: v.clone() for k, v in pG.items()},
              {k: v.clone() for k, v in pD.items()})
    pG2, pD2, sG2, sD2, _, errG = twin.train_step(
        G, D, optG, optD, pG, pD, sG, sD, torch.from_numpy(real),
        torch.from_numpy(z))
    assert all(torch.equal(pD2[k], before[1][k]) for k in pD2)
    assert not all(torch.equal(pG2[k], before[0][k]) for k in pG2)
    assert int(sD2.skipped_steps) == 1 and int(sG2.applied_steps) == 1
    scales = [float(optD.loss_scale(sD2, 0)), float(optD.loss_scale(sD2, 1)),
              float(optG.loss_scale(sG2, 2))]
    assert scales == [2.0 ** 15, 2.0 ** 16, 2.0 ** 16]
    assert np.isfinite(float(errG))

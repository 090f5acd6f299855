"""Adversarial training of the port against the JAX package
(where2edit_tpu/train/gan_trainer.py) on the same weights, inputs and
draws: the losses, R1 and the path length penalty, the gradients of every
training program (D step, R1, G step, path length: the last two through the
kernels' Functions twice) against ``jax.grad`` of the JAX package's own
losses, one Adam update against ``optax.adam``; and the trainer's mechanics
(EMA, metrics, kernel calls per program).

8² generator and discriminator (512 channels wide), batch 4, float32.
Bars, relative to the largest magnitude of each tensor: 1e-4 for losses and
penalties; 1e-3 for gradients, which are sums over every pixel of the batch
taken in another order (the R1 and path-length gradients also through a
second derivative).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from where2edit_tpu_torch import convert
from where2edit_tpu_torch.train.gan_trainer import (
    Draws,
    GANTrainConfig,
    GANTrainer,
    logistic_d_loss,
    logistic_g_loss,
    path_length_penalty,
    r1_penalty,
)

from torch_parity import np_tree, perturb, t

SIZE, BATCH = 8, 4
TOL, GRAD_TOL = 1e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the tier-1 run puts six test processes on the
    machine's cores, where more threads per process spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_models():
    from where2edit_tpu.models.stylegan2 import Discriminator, Generator  # noqa: PLC0415

    jg = Generator(size=SIZE, channel_multiplier=1)
    jd = Discriminator(size=SIZE, channel_multiplier=1)
    gv = jax.jit(lambda: jg.init({"params": jax.random.PRNGKey(1),
                                  "noise": jax.random.PRNGKey(2)},
                                 [jnp.zeros((1, 512))]))()
    dv = jax.jit(lambda: jd.init({"params": jax.random.PRNGKey(3)},
                                 jnp.zeros((1, SIZE, SIZE, 3))))()
    rng = np.random.default_rng(0)
    gv = perturb({k: dict(v) for k, v in np_tree(gv).items()}, rng)
    dv = perturb(np_tree(dv), rng)
    return jg, jd, gv, dv


def _trainer(jax_models, **cfg) -> GANTrainer:
    _, _, gv, dv = jax_models
    tr = GANTrainer(GANTrainConfig(size=SIZE, batch_size=BATCH,
                                   channel_multiplier=1, **cfg), device="cpu")
    convert.load_converted(tr.g, convert.generator_state_dict(gv, SIZE))
    convert.load_converted(tr.d, convert.discriminator_state_dict(dv, SIZE, 1))
    return tr


def _draws(batch: int, inject: int, seed: int):
    """numpy z1, z2, inject and per-layer noise, and the same as ``Draws``."""
    rng = np.random.default_rng(seed)
    z1, z2 = (rng.standard_normal((batch, 512)).astype(np.float32) for _ in range(2))
    noise = [rng.standard_normal((batch, r, r, 1)).astype(np.float32)
             for r in (4, 8, 8)]
    return ((z1, z2, inject, noise),
            Draws(t(z1), t(z2), torch.tensor(inject), [t(n) for n in noise]))


def _jax_synth(jg, g_params, gv, z1, z2, inject, noise):
    """(image, W+): the JAX trainer's _mixed_wplus_from + _synthesize with
    explicit noise."""
    v = {**gv, "params": g_params}
    w1 = jg.apply(v, jnp.asarray(z1), method=jg.get_latent)
    w2 = jg.apply(v, jnp.asarray(z2), method=jg.get_latent)
    row = jnp.arange(jg.n_latent)[None, :, None]
    wplus = jnp.where(row < inject, w1[:, None, :], w2[:, None, :])
    img = jg.apply(v, [wplus], input_is_latent=True,
                   noise=[jnp.asarray(n) for n in noise]).image
    return img, wplus


def _real(seed=9):
    return np.random.default_rng(seed).uniform(
        -1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _check_grads(module, state_dict, tol=GRAD_TOL):
    """Every parameter's .grad against the JAX gradient tree converted to
    the port's layout (the converters are the same transposes)."""
    checked = 0
    for name, p in module.named_parameters():
        want = state_dict[name].numpy()
        if not np.any(want):
            assert p.grad is None or not torch.any(p.grad), name
            continue
        assert _rel(p.grad.numpy(), want) <= tol, (name, _rel(p.grad.numpy(), want))
        checked += 1
    assert checked > 0


def test_torch_gan_losses_match_jax():
    from where2edit_tpu.train import gan_trainer as jt  # noqa: PLC0415

    rng = np.random.default_rng(1)
    real, fake = (rng.standard_normal((6, 1)).astype(np.float32) * 3 for _ in range(2))
    assert _rel(logistic_d_loss(t(real), t(fake)),
                jt.logistic_d_loss(jnp.asarray(real), jnp.asarray(fake))) <= 1e-6
    assert _rel(logistic_g_loss(t(fake)), jt.logistic_g_loss(jnp.asarray(fake))) <= 1e-6


def test_torch_r1_penalty_and_grads_match_jax(jax_models):
    from where2edit_tpu.train import gan_trainer as jt  # noqa: PLC0415

    _, jd, _, dv = jax_models
    tr = _trainer(jax_models)
    real = _real()
    cfg = tr.cfg

    def loss(d_params):
        pen = jt.r1_penalty(lambda p, x: jd.apply({"params": p}, x), d_params,
                            jnp.asarray(real))
        return cfg.r1 / 2.0 * pen * cfg.d_reg_every, pen

    (want_loss, want_pen), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        dv["params"])
    assert _rel(r1_penalty(tr.d, t(real)).detach(), want_pen) <= TOL
    got_loss = tr.r1_step(t(real))
    assert _rel(got_loss, want_loss) <= TOL
    _check_grads(tr.d, convert.discriminator_state_dict(np_tree(grads), SIZE, 1))


def test_torch_path_length_penalty_matches_jax(jax_models):
    from where2edit_tpu.train import gan_trainer as jt  # noqa: PLC0415

    jg, _, gv, _ = jax_models
    (z1, z2, inject, noise), draws = _draws(2, 3, seed=4)
    key = jax.random.PRNGKey(7)
    pl_noise = np.asarray(jax.random.normal(key, (2, SIZE, SIZE, 3), jnp.float32))

    @jax.jit
    def penalty():
        _, wplus = _jax_synth(jg, gv["params"], gv, z1, z2, inject, noise)
        return jt.path_length_penalty(
            lambda w: jg.apply(gv, [w], input_is_latent=True,
                               noise=[jnp.asarray(n) for n in noise]).image,
            wplus, jnp.asarray(0.7), key)

    want = penalty()
    tr = _trainer(jax_models)
    img, wp = tr.synthesize(draws)
    got = path_length_penalty(img, wp, torch.tensor(0.7), t(pl_noise))
    for g, w in zip(got, want):
        assert _rel(g.detach(), w) <= TOL


def test_torch_d_step_grads_match_jax(jax_models):
    from where2edit_tpu.train import gan_trainer as jt  # noqa: PLC0415

    jg, jd, gv, dv = jax_models
    (z1, z2, inject, noise), draws = _draws(BATCH, 2, seed=5)
    real = _real()
    fake, _ = _jax_synth(jg, gv["params"], gv, z1, z2, inject, noise)

    def loss(d_params):
        return jt.logistic_d_loss(jd.apply({"params": d_params}, jnp.asarray(real)),
                                  jd.apply({"params": d_params}, fake))

    want_loss, grads = jax.jit(jax.value_and_grad(loss))(dv["params"])
    tr = _trainer(jax_models)
    assert _rel(tr.d_step_with(t(real), draws), want_loss) <= TOL
    _check_grads(tr.d, convert.discriminator_state_dict(np_tree(grads), SIZE, 1))


def test_torch_g_step_grads_match_jax(jax_models):
    from where2edit_tpu.train import gan_trainer as jt  # noqa: PLC0415

    jg, jd, gv, dv = jax_models
    (z1, z2, inject, noise), draws = _draws(BATCH, 4, seed=6)

    def loss(g_params):
        img, _ = _jax_synth(jg, g_params, gv, z1, z2, inject, noise)
        return jt.logistic_g_loss(jd.apply(dv, img))

    want_loss, grads = jax.jit(jax.value_and_grad(loss))(gv["params"])
    tr = _trainer(jax_models)
    assert _rel(tr.g_step_with(draws), want_loss) <= TOL
    assert all(p.grad is None for p in tr.d.parameters())  # D frozen in the G step
    assert all(p.requires_grad for p in tr.d.parameters())  # and released after
    _check_grads(tr.g, convert.generator_state_dict(
        {"params": np_tree(grads)}, SIZE))


def test_torch_path_step_grads_match_jax(jax_models):
    from where2edit_tpu.train import gan_trainer as jt  # noqa: PLC0415

    jg, _, gv, _ = jax_models
    (z1, z2, inject, noise), draws = _draws(2, 4, seed=8)
    key = jax.random.PRNGKey(11)
    pl_noise = np.asarray(jax.random.normal(key, (2, SIZE, SIZE, 3), jnp.float32))
    tr = _trainer(jax_models)
    cfg = tr.cfg

    def loss(g_params):
        _, wplus = _jax_synth(jg, g_params, gv, z1, z2, inject, noise)
        pen, _, _ = jt.path_length_penalty(
            lambda w: jg.apply({**gv, "params": g_params}, [w], input_is_latent=True,
                               noise=[jnp.asarray(n) for n in noise]).image,
            wplus, jnp.zeros(()), key)
        return cfg.path_regularize * cfg.g_reg_every * pen

    want_loss, grads = jax.jit(jax.value_and_grad(loss))(gv["params"])
    got_loss, _ = tr.path_step_with(draws, t(pl_noise))
    assert _rel(got_loss, want_loss) <= TOL
    _check_grads(tr.g, convert.generator_state_dict(
        {"params": np_tree(grads)}, SIZE))


def test_torch_adam_matches_optax(jax_models):
    """Two updates of D with the lazy-regularisation correction
    (lr·c, betas (0, 0.99^c), c = 16/17) on the same gradients; the updated
    parameters within float32 rounding (1e-6 of their largest magnitude)."""
    tr = _trainer(jax_models)
    rng = np.random.default_rng(3)
    params = {n: p.detach().numpy().copy() for n, p in tr.d.named_parameters()}
    grads = [{n: rng.standard_normal(v.shape).astype(np.float32)
              for n, v in params.items()} for _ in range(2)]
    c = 16 / 17
    opt = optax.adam(0.002 * c, b1=0.0, b2=0.99 ** c)
    state = opt.init(params)
    want = params
    for g in grads:
        updates, state = opt.update(g, state, want)
        want = optax.apply_updates(want, updates)
        for n, p in tr.d.named_parameters():
            p.grad = t(g[n])
        tr.d_opt.step()
    for n, p in tr.d.named_parameters():
        assert _rel(p.detach().numpy(), want[n]) <= 1e-6, n


def test_torch_trainer_step_and_ema(jax_models):
    tr = _trainer(jax_models, d_reg_every=2, g_reg_every=2)
    real = t(_real())
    e0 = [p.detach().clone() for p in tr.g_ema.parameters()]
    beta = tr.ema_beta
    assert beta == 0.5 ** (BATCH / 10000.0)
    hist = []
    keys = []
    for _ in range(2):
        m = tr.step(real)
        keys.append(set(m))
        assert all(math.isfinite(float(v)) for v in m.values()), m
        hist.append([p.detach().clone() for p in tr.g.parameters()])
    assert keys == [{"d_loss", "r1", "g_loss", "path", "path_length"},
                    {"d_loss", "g_loss"}]
    assert float(tr.pl_mean) != 0.0 and tr.global_step == 2
    for i, e in enumerate(tr.g_ema.parameters()):
        want = e0[i]
        for h in hist:
            want = beta * want + (1 - beta) * h[i]
        torch.testing.assert_close(e, want, rtol=1e-6, atol=1e-6)

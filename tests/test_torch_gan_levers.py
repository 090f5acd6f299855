"""The GAN trainer's memory and precision levers against the JAX package's
and against themselves:

- ``d_microbatch`` (D and R1 programs) and ``g_microbatch`` (G program)
  against the JAX trainer's chunked programs on the same weights and
  draws: the mean of the chunk losses and gradients, minibatch-stddev per
  chunk, the G chunks slicing one full-batch draw of z1, z2 and the
  mixing index as JAX's ``_g_step`` does. The noise differs in its stream
  only: the port slices each chunk's rows of one full-batch noise draw,
  where JAX's chunked program draws each chunk's noise from a key split
  per chunk; here both sides take the same sliced noise, so only the
  z/inject slicing is held against JAX. The D loss comes from
  the JAX trainer's own ``_d_step`` program; every gradient from
  ``jax.grad`` of the same mean of chunk losses built from the JAX
  package's losses. Bars: losses 1e-4 relative; gradients in relative L2
  at ``chip_smoke.py`` phase 10's bars, 1e-3 for the whole model and 5e-2
  per tensor (a chunk of 2 takes its minibatch-stddev over 2 samples, and
  R1's second derivative crosses leaky-ReLU kinks, so single small
  tensors such as a bias move more than the model does).
- ``remat`` and ``d_remat`` against none: the same losses and gradients
  (R1's gradient of a gradient through a checkpointed ResBlock included),
  to 1e-6 of the largest magnitude (the recomputed forwards are the same
  arithmetic; only the order the backward accumulates may differ).
- bf16 training (``bf16``/``d_bf16``; a bf16 generator in the attention
  trainer and in the StyleCLIP coach) tracks fp32 over 3 steps at the JAX
  package's bar, |Δloss| ≤ 0.1·|loss| + 0.1 (tests/test_training.py).

8² generator and discriminator (512 wide), batch 4; the mapper trainers at
32² and 64² as their own tests.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from where2edit_tpu_torch import convert
from where2edit_tpu_torch.train.gan_trainer import Draws, GANTrainConfig, GANTrainer

from torch_parity import np_tree, perturb, t

SIZE, BATCH, CHUNK = 8, 4, 2
TOL, REMAT_TOL = 1e-4, 1e-6
MODEL_GRAD_TOL, PARAM_GRAD_TOL = 1e-3, 5e-2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
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
    tr = GANTrainer(GANTrainConfig(size=SIZE, batch_size=BATCH, channel_multiplier=1,
                                   **cfg), device="cpu")
    convert.load_converted(tr.g, convert.generator_state_dict(gv, SIZE))
    convert.load_converted(tr.d, convert.discriminator_state_dict(dv, SIZE, 1))
    return tr


def _draws(seed: int, inject: int = 2):
    rng = np.random.default_rng(seed)
    z1, z2 = (rng.standard_normal((BATCH, 512)).astype(np.float32) for _ in range(2))
    noise = [rng.standard_normal((BATCH, r, r, 1)).astype(np.float32) for r in (4, 8, 8)]
    return ((z1, z2, inject, noise),
            Draws(t(z1), t(z2), torch.tensor(inject), [t(n) for n in noise]))


def _jax_synth(jg, g_params, gv, z1, z2, inject, noise):
    v = {**gv, "params": g_params}
    w1 = jg.apply(v, jnp.asarray(z1), method=jg.get_latent)
    w2 = jg.apply(v, jnp.asarray(z2), method=jg.get_latent)
    row = jnp.arange(jg.n_latent)[None, :, None]
    wplus = jnp.where(row < inject, w1[:, None, :], w2[:, None, :])
    return jg.apply(v, [wplus], input_is_latent=True,
                    noise=[jnp.asarray(n) for n in noise]).image


def _real(seed=9):
    return np.random.default_rng(seed).uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(
        np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _check_grads(module, state_dict):
    """Every parameter's .grad against the JAX gradient tree in the port's
    layout: relative L2 per tensor and over the whole model."""
    diff2 = ref2 = 0.0
    for name, p in module.named_parameters():
        want = state_dict[name].numpy().astype(np.float64)
        if not np.any(want):
            continue
        d2 = float(np.square(p.grad.numpy() - want).sum())
        r2 = float(np.square(want).sum())
        assert np.sqrt(d2 / r2) <= PARAM_GRAD_TOL, (name, np.sqrt(d2 / r2))
        diff2, ref2 = diff2 + d2, ref2 + r2
    assert ref2 > 0 and np.sqrt(diff2 / ref2) <= MODEL_GRAD_TOL, np.sqrt(diff2 / ref2)


def _chunks(a):
    return [a[i:i + CHUNK] for i in range(0, BATCH, CHUNK)]


def _jax_trainer(jax_models, **cfg):
    from where2edit_tpu.train import gan_trainer as jt  # noqa: PLC0415

    jg, jd, gv, dv = jax_models
    tr = jt.GANTrainer(jt.GANTrainConfig(size=SIZE, batch_size=BATCH,
                                         channel_multiplier=1, **cfg),
                       generator=jg, discriminator=jd,
                       g_vars=jax.tree.map(jnp.asarray, gv),
                       d_params=jax.tree.map(jnp.asarray, dv["params"]))
    return jt, tr


def test_torch_d_microbatch_matches_jax(jax_models):
    jg, jd, gv, dv = jax_models
    (z1, z2, inject, noise), draws = _draws(seed=5)
    real = _real()
    fake = _jax_synth(jg, gv["params"], gv, z1, z2, inject, noise)
    jt, jtr = _jax_trainer(jax_models, d_microbatch=CHUNK)
    _, _, want_loss = jtr._d_step(jtr.d_params, jtr.d_opt_state, jnp.asarray(real), fake)

    def loss(d_params):
        return sum(jt.logistic_d_loss(jd.apply({"params": d_params}, r),
                                      jd.apply({"params": d_params}, f))
                   for r, f in zip(_chunks(jnp.asarray(real)), _chunks(fake))) / (BATCH // CHUNK)

    mean_loss, grads = jax.jit(jax.value_and_grad(loss))(dv["params"])
    assert _rel(want_loss, mean_loss) <= 1e-6  # the program is that mean
    tr = _trainer(jax_models, d_microbatch=CHUNK)
    assert _rel(tr.d_step_with(t(real), draws), want_loss) <= TOL
    _check_grads(tr.d, convert.discriminator_state_dict(np_tree(grads), SIZE, 1))


def test_torch_d_microbatch_r1_matches_jax(jax_models):
    _, jd, _, dv = jax_models
    real = _real(seed=11)
    jt, jtr = _jax_trainer(jax_models, d_microbatch=CHUNK)
    _, _, want_loss = jtr._d_r1_step(jtr.d_params, jtr.d_opt_state, jnp.asarray(real))
    cfg = jtr.cfg

    def loss(d_params):
        return sum(cfg.r1 / 2.0 * cfg.d_reg_every * jt.r1_penalty(
            lambda p, x: jd.apply({"params": p}, x), d_params, r)
            for r in _chunks(jnp.asarray(real))) / (BATCH // CHUNK)

    grads = jax.jit(jax.grad(loss))(dv["params"])
    tr = _trainer(jax_models, d_microbatch=CHUNK)
    assert _rel(tr.r1_step(t(real)), want_loss) <= TOL
    _check_grads(tr.d, convert.discriminator_state_dict(np_tree(grads), SIZE, 1))


def test_torch_g_microbatch_matches_jax(jax_models):
    """The G chunks slice one full-batch draw: z1, z2, the shared mixing
    index and each chunk's rows of the noise. JAX's ``_g_step`` slices z1,
    z2 and the index the same way but draws each chunk's noise from its
    own split key, so the JAX side is built here from its losses with the
    port's sliced noise, not run through ``_g_step``."""
    from where2edit_tpu.train import gan_trainer as jt  # noqa: PLC0415

    jg, jd, gv, dv = jax_models
    (z1, z2, inject, noise), draws = _draws(seed=6, inject=4)

    def loss(g_params):
        parts = [jt.logistic_g_loss(jd.apply(dv, _jax_synth(
            jg, g_params, gv, z1[i:i + CHUNK], z2[i:i + CHUNK], inject,
            [n[i:i + CHUNK] for n in noise]))) for i in range(0, BATCH, CHUNK)]
        return sum(parts) / len(parts)

    want_loss, grads = jax.jit(jax.value_and_grad(loss))(gv["params"])
    tr = _trainer(jax_models, g_microbatch=CHUNK)
    assert _rel(tr.g_step_with(draws), want_loss) <= TOL
    assert all(p.grad is None for p in tr.d.parameters())
    _check_grads(tr.g, convert.generator_state_dict({"params": np_tree(grads)}, SIZE))


def _grads(module) -> list:
    return [p.grad.clone() for p in module.parameters() if p.grad is not None]


def _same(a: list, b: list, tol=REMAT_TOL):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert _rel(x.numpy(), y.numpy()) <= tol


@pytest.mark.parametrize("bf16", [False, True])
def test_torch_remat_matches_none(jax_models, bf16):
    """G (remat) and D (d_remat, each ResBlock) recomputed in the backward:
    the G, D and R1 programs' losses and gradients are those without."""
    (_, draws) = _draws(seed=7)
    real = t(_real(seed=12))
    kw = dict(bf16=bf16, d_bf16=bf16)
    plain, remat = _trainer(jax_models, **kw), _trainer(jax_models, remat=True,
                                                        d_remat=True, **kw)
    assert remat.d.remat and not plain.d.remat
    for program, model in (("g", "g"), ("d", "d"), ("r1", "d")):
        run = {"g": lambda tr: tr.g_step_with(draws),
               "d": lambda tr: tr.d_step_with(real, draws),
               "r1": lambda tr: tr.r1_step(real)}[program]
        # each program from the same state on both sides
        remat.g.load_state_dict(plain.g.state_dict())
        remat.d.load_state_dict(plain.d.state_dict())
        want, got = run(plain), run(remat)
        assert _rel(got, want) <= REMAT_TOL, program
        _same(_grads(getattr(remat, model)), _grads(getattr(plain, model)))


def _tracks(bf16_losses: list, fp32_losses: list) -> None:
    """JAX's bar for a bf16 step against fp32 (tests/test_training.py)."""
    assert len(bf16_losses) == len(fp32_losses) == 3
    for lb, lf in zip(bf16_losses, fp32_losses):
        assert np.isfinite(lb) and abs(lb - lf) <= 0.1 * abs(lf) + 0.1, (lb, lf)


def test_torch_bf16_gan_step_tracks_fp32(jax_models):
    real = t(_real(seed=13))
    runs = {}
    for bf16 in (False, True):
        tr = _trainer(jax_models, bf16=bf16, d_bf16=bf16, d_reg_every=2, g_reg_every=2)
        assert tr.g.dtype == (torch.bfloat16 if bf16 else torch.float32)
        steps = [tr.step(real) for _ in range(3)]
        assert all(p.dtype == torch.float32 for p in tr.g.parameters())
        runs[bf16] = {k: [float(m[k]) for m in steps] for k in ("d_loss", "g_loss")}
    for k in ("d_loss", "g_loss"):
        _tracks(runs[True][k], runs[False][k])


def test_torch_bf16_attention_step_tracks_fp32():
    from torch_parity import attention_models, attention_trainer  # noqa: PLC0415

    m = attention_models()
    bank = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (7, 512)).astype(np.float32))
    runs = {}
    for bf16 in (False, True):
        tr = attention_trainer(m)
        if bf16:
            tr.generator.dtype = torch.bfloat16
        runs[bf16] = [float(tr.step(i, bank)[0]["loss"]) for i in range(60, 63)]
    _tracks(runs[True], runs[False])


def test_torch_bf16_coach_step_tracks_fp32(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    from where2edit_tpu_torch.editing.latent_mappers import stylespace_count  # noqa: PLC0415
    from where2edit_tpu_torch.editing.styleclip_mapper import build_mapper  # noqa: PLC0415
    from where2edit_tpu_torch.losses.clip_loss import CLIPLoss  # noqa: PLC0415
    from where2edit_tpu_torch.losses.id_loss import IDLoss  # noqa: PLC0415
    from where2edit_tpu_torch.models.clip_model import CLIP  # noqa: PLC0415
    from where2edit_tpu_torch.models.clip_tokenizer import tokenize  # noqa: PLC0415
    from where2edit_tpu_torch.models.irse import Backbone  # noqa: PLC0415
    from where2edit_tpu_torch.models.stylegan2 import Generator  # noqa: PLC0415
    from where2edit_tpu_torch.train.coach import Coach, CoachConfig  # noqa: PLC0415

    from torch_parity import TINY_CLIP, arcface_state  # noqa: PLC0415

    size, batch = 64, 2
    w = np.random.default_rng(4).standard_normal((batch, 10, 512)).astype(np.float32) * 0.5
    tokens = torch.from_numpy(np.asarray(tokenize(["a person with purple hair"]))).long()
    arc = arcface_state(seed=0)
    runs = {}
    for bf16 in (False, True):
        gen = Generator(size, rng=torch.Generator().manual_seed(1),
                        dtype=torch.bfloat16 if bf16 else torch.float32).eval()
        mapper = build_mapper("LevelsMapper", n_styles=stylespace_count(size),
                              rng=torch.Generator().manual_seed(2))
        clip = CLIP(**TINY_CLIP, rng=torch.Generator().manual_seed(3)).eval()
        cfg = CoachConfig(exp_dir=str(tmp_path / str(bf16)), mapper_type="LevelsMapper",
                          batch_size=batch, test_batch_size=batch,
                          train_dataset_size=batch, test_dataset_size=batch,
                          stylegan_size=size)
        coach = Coach(cfg, generator=gen, mapper=mapper, clip_loss=CLIPLoss(clip, size),
                      id_loss=IDLoss(Backbone.from_state_dict(arc, drop_ratio=0.6).eval()),
                      latent_avg=torch.zeros(1, 512), text_tokens=tokens,
                      train_latents=w, test_latents=w)
        coach.metrics.close()
        b = next(coach._batches(coach.train_latents, batch, False))
        runs[bf16] = [float(coach.step(b)[0]["loss"]) for _ in range(3)]
    _tracks(runs[True], runs[False])

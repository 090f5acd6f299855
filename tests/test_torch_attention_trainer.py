"""The port's region-attention trainer against the JAX package's
(where2edit_tpu/train/attention_trainer.py) on the same weights and draws
(``torch_parity.attention_models``: generator size 32, a small CLIP, the
real VGG16).

One ``step_with`` against the JAX ``_step`` at step 60 of 300, so both
ramps are on: every loss term within 1e-4 relative, the mapper's gradient
within 1e-3 relative L2 for the whole model and 5e-2 per tensor, with
``freeze_attention_until=0.0`` on both sides for the unmasked gradients.

The same for the W+ branch (``work_in_stylespace=False``: the mapper on the
target's W+, ``latent + delta``, the synthesis from the new W+), with the
production W+ mapper and its cluster-free twin.

Then the port alone, with a pooled stand-in for VGG16 where the test is of
the loop and not of the losses: the freeze mask and the lr of 0 at step 0,
Adam against ``optax.adam`` at counts 0, 1 and 60 (1e-6), the NaN guard's
rollback and abort, and a run resumed at step 1 against an uninterrupted
one (bitwise).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from where2edit_tpu.train import attention_trainer as jat
from where2edit_tpu_torch.losses.perceptual import PerceptualLoss
from where2edit_tpu_torch.models.vgg import VggFeatures
from where2edit_tpu_torch.train.attention_trainer import MapperAdam, is_attention_param
from where2edit_tpu_torch.train.lr import styleclip_lr_schedule

from torch_parity import (
    ATT_BATCH,
    ATT_PROMPTS,
    ATT_SIZE,
    attention_models,
    attention_trainer,
    compare_attention_step,
    jax_attention_draws,
    jax_attention_step,
    t,
)

STEP_IDX = 60


@pytest.fixture(scope="module")
def models():
    return attention_models()


class PooledFeatures(torch.nn.Module):
    """A cheap stand-in for VGG16 in the tests of the loop: the 224² image
    average-pooled 8x8 as its relu2_2."""

    def forward(self, x, last="relu4_3"):
        pooled = torch.nn.functional.avg_pool2d(x.permute(0, 3, 1, 2), 8)
        return VggFeatures(relu2_2=pooled.permute(0, 2, 3, 1))


def cheap_trainer(m, **kw):
    return attention_trainer(m, perceptual=PerceptualLoss(PooledFeatures(), ATT_SIZE),
                             **kw)


def _bank(seed):
    return np.random.default_rng(seed).standard_normal((ATT_PROMPTS, 512)).astype(np.float32)


def test_torch_attention_step_matches_jax(models):
    key = jax.random.PRNGKey(11)
    bank = _bank(5)
    aux_j, grads_j = jax_attention_step(models, key, STEP_IDX, bank)
    tr = attention_trainer(models, freeze=0.0)
    aux_t, img, amap = tr.step_with(jax_attention_draws(key), STEP_IDX, t(bank))
    assert img.shape == (ATT_BATCH, ATT_SIZE, ATT_SIZE, 3)
    assert amap.shape == (ATT_BATCH, 16, 16, 1)
    assert all(aux_j[k] != 0.0 for k in ("consist", "perceptual", "delta", "reg", "tv"))
    compare_attention_step(aux_t, aux_j, tr, grads_j)


@pytest.mark.parametrize("mapper", ["FullSpaceMapperFEATClusterLin",
                                    "FullSpaceMapperFEATLin"])
def test_torch_attention_wplus_step_matches_jax(mapper):
    m = attention_models(mapper)
    key = jax.random.PRNGKey(12)
    bank = _bank(6)
    aux_j, grads_j = jax_attention_step(m, key, STEP_IDX, bank)
    tr = attention_trainer(m, freeze=0.0)
    aux_t, img, amap = tr.step_with(jax_attention_draws(key), STEP_IDX, t(bank))
    assert img.shape == (ATT_BATCH, ATT_SIZE, ATT_SIZE, 3)
    # the cluster mapper's map is at its cluster tap's size (32²), the
    # other's at the blend size (16²)
    side = 32 if mapper.endswith("ClusterLin") else 16
    assert amap.shape == (ATT_BATCH, side, side, 1)
    assert all(aux_j[k] != 0.0 for k in ("consist", "perceptual", "delta", "reg", "tv"))
    assert any(n.startswith("attention_first") for n in tr.param_names)
    assert all(is_attention_param(n) == n.startswith("attention")
               for n in tr.param_names)
    compare_attention_step(aux_t, aux_j, tr, grads_j)


def test_torch_attention_freeze_mask_and_lr0(models):
    """The reference's freeze: attention*/initial* parameters bitwise
    unchanged after a step at lr > 0, every other one moved; nothing moves
    at step 0 (lr 0); the unused S-space modulation weights take no
    gradient and no optimizer state; the generator is frozen."""
    tr = cheap_trainer(models)
    bank = t(_bank(7))
    start = {n: p.detach().clone() for n, p in tr.mapper.named_parameters()}
    tr.step(0, bank)
    assert all(torch.equal(p, start[n]) for n, p in tr.mapper.named_parameters())
    tr.step(1, bank)
    for n, p in tr.mapper.named_parameters():
        if is_attention_param(n):
            assert torch.equal(p, start[n]), n
        else:
            assert not torch.equal(p, start[n]), n
    mods = [n for n, _ in tr.mapper.named_parameters() if ".conv.modulation." in n]
    assert mods and not set(mods) & set(tr.param_names)
    assert all(p.grad is None for n, p in tr.mapper.named_parameters() if n in mods)
    assert all(not p.requires_grad for p in tr.generator.parameters())
    assert len(tr.opt.mu) == len(tr.param_names)


@pytest.mark.parametrize("counts", [(0, 1, 60)])
def test_torch_mapper_adam_matches_optax(counts):
    """From the same gradients, after the updates at counts 0 (lr 0), 1 and
    60 of the StyleCLIP schedule."""
    rng = np.random.default_rng(8)
    shapes = [(5, 3), (7,), (2, 2, 4)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(max(counts) + 1)]
    opt = optax.adam(jat.styleclip_lr_schedule(0.1, 300))
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    tp = [t(p) for p in params]
    adam = MapperAdam(tp, styleclip_lr_schedule(0.1, 300))
    for count, gs in enumerate(grads):
        upd, state = opt.update([jnp.asarray(g) for g in gs], state, jp)
        jp = optax.apply_updates(jp, upd)
        adam.step([t(g) for g in gs])
        if count in counts:
            for a, b in zip(tp, jp):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    assert adam.count == max(counts) + 1


def test_torch_attention_nan_guard_rolls_back_and_aborts(models):
    tr = cheap_trainer(models)
    tr.cfg.step = 3
    bank = t(_bank(9))
    perceptual = tr.perceptual
    bad_steps = {1}

    class Poisoned:
        vgg = perceptual.vgg

        def __call__(self, a, b):
            loss = perceptual(a, b)
            return loss * float("nan") if tr.draws_taken - 1 in bad_steps else loss

    tr.perceptual = Poisoned()
    hist = tr.run(bank, log_every=1)
    # step 1 is rejected and rolled back; step 2 starts from step 0's state
    assert [i for i, _ in hist] == [0, 2] and tr.steps_completed == 3
    assert tr.opt.count == 2
    bad_steps.update(range(3, 6))
    before = [p.detach().clone() for p in tr.params]
    tr.cfg.step = 6
    with pytest.raises(FloatingPointError, match="3 consecutive"):
        tr.run(bank, log_every=1, start_step=3)
    assert all(torch.equal(a, b) for a, b in zip(before, tr.params))
    assert tr.opt.count == 2


def test_torch_attention_resume_is_bitwise(models):
    """A run stopped after 1 step and continued by a fresh trainer from
    ``start_step=1`` (its draws fast-forwarded; no draw state copied) ends
    where an uninterrupted 3-step run ends, bit for bit."""
    bank = t(_bank(10))
    full = cheap_trainer(models)
    full.cfg.step = 3
    full.run(bank, log_every=1)
    first = cheap_trainer(models)
    first.cfg.step = 3
    first.run(bank, log_every=1, stop_fn=lambda: first.steps_completed == 1)
    assert first.steps_completed == 1
    second = cheap_trainer(models)
    second.cfg.step = 3
    second.mapper.load_state_dict(copy.deepcopy(first.mapper.state_dict()))
    second.opt.load_state_dict(copy.deepcopy(first.opt.state_dict()))
    second.run(bank, log_every=1, start_step=1)
    assert second.opt.count == full.opt.count == 3
    for a, b in zip(full.params, second.params):
        assert torch.equal(a, b)

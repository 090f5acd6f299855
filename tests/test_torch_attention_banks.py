"""The port's region-attention step in its two bank modes against the JAX
``_step`` (where2edit_tpu/train/attention_trainer.py) on the same weights
and draws (``torch_parity.attention_models``): ``--latent_path`` (random
rows of a W+ bank, no truncation) and ``--text_condition`` (random rows of
a text-encoding bank as the condition, no conditioning synthesis), both in
one step at step 60 of 300. Loss terms within 1e-4 relative, the mapper's
gradient within 1e-3 (whole model) and 5e-2 (per tensor) relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np

from torch_parity import (
    ATT_PROMPTS,
    attention_models,
    attention_trainer,
    compare_attention_step,
    jax_attention_draws,
    jax_attention_step,
    t,
)


def test_torch_attention_step_with_banks_matches_jax():
    models = attention_models()
    rng = np.random.default_rng(6)
    lat = (rng.standard_normal((5, 8, 512)) * 0.5).astype(np.float32)
    text = rng.standard_normal((4, 512)).astype(np.float32)
    bank = rng.standard_normal((ATT_PROMPTS, 512)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    aux_j, grads_j = jax_attention_step(models, key, 60, bank, jnp.asarray(lat),
                                        jnp.asarray(text))
    tr = attention_trainer(models, freeze=0.0, latent_bank=t(lat), text_bank=t(text))
    draws = jax_attention_draws(key, n_bank=5, n_text=4)
    assert draws.cond.dtype == draws.target.dtype == draws.att_idx.dtype
    aux_t, _, _ = tr.step_with(draws, 60, t(bank))
    compare_attention_step(aux_t, aux_j, tr, grads_j)

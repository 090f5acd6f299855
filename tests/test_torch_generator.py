"""The port's Generator against the JAX package's at size 32, on the same
(perturbed) weights and stored noise buffers: image, style vectors and
every tap; z input with truncation; S-space input; the masked blend with
the to_rgb coupling; tap_subsample / tap_indices.

Tolerances follow tests/test_generator.py: 2e-3 for images and taps (fp32
through up to 11 layers), 1e-4 for latents and styles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from where2edit_tpu_torch.models.stylegan2 import blend_tap_indices as t_bti
from where2edit_tpu.models.stylegan2 import blend_tap_indices as j_bti

from torch_parity import close, jax_generator, t, torch_generator

SIZE = 32
IMG_TOL = 2e-3
STYLE_TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jgen, np_vars = jax_generator(SIZE, seed=1)
    return jgen, np_vars, torch_generator(np_vars, SIZE)


def _japply(jgen, np_vars, *args, **kw):
    fn = jax.jit(lambda v, *a: jgen.apply(v, *a, **kw))
    return fn(jax.tree.map(jnp.asarray, np_vars), *args)


def _wplus(jgen, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, jgen.n_latent, 512)).astype(np.float32)


def test_torch_generator_wplus_features(pair):
    jgen, np_vars, tgen = pair
    w = _wplus(jgen, 0)
    want = _japply(jgen, np_vars, [jnp.asarray(w)], input_is_latent=True,
                   randomize_noise=False, return_features=True)
    with torch.no_grad():
        got = tgen([t(w)], input_is_latent=True, randomize_noise=False,
                   return_features=True)
    close(got.image, want.image, IMG_TOL)
    assert len(got.style_vector) == len(want.style_vector) == 11
    for gs, ws in zip(got.style_vector, want.style_vector):
        close(gs, ws, STYLE_TOL)
    assert len(got.feature_map) == len(want.feature_map)
    for gf, wf in zip(got.feature_map, want.feature_map):
        close(gf, wf, IMG_TOL)


def test_torch_generator_z_truncation(pair):
    jgen, np_vars, tgen = pair
    rng = np.random.default_rng(1)
    z = rng.standard_normal((2, 512)).astype(np.float32)
    mean = rng.standard_normal((1, 512)).astype(np.float32) * 0.1
    want = jax.jit(lambda v, z, m: jgen.apply(
        v, [z], return_latents=True, truncation=0.7, truncation_latent=m,
        randomize_noise=False))(
        jax.tree.map(jnp.asarray, np_vars), jnp.asarray(z), jnp.asarray(mean))
    with torch.no_grad():
        got = tgen([t(z)], return_latents=True, truncation=0.7,
                   truncation_latent=t(mean), randomize_noise=False)
    close(got.latent, want.latent, STYLE_TOL)
    close(got.image, want.image, IMG_TOL)


def test_torch_generator_stylespace(pair):
    jgen, np_vars, tgen = pair
    rng = np.random.default_rng(2)
    dims = [512, 512] + [512, 512, 512] * 3
    styles = [rng.standard_normal((2, d)).astype(np.float32) for d in dims]
    want = _japply(jgen, np_vars, [jnp.asarray(s) for s in styles],
                   input_is_stylespace=True, randomize_noise=False)
    with torch.no_grad():
        got = tgen([t(s) for s in styles], input_is_stylespace=True,
                   randomize_noise=False)
    close(got.image, want.image, IMG_TOL)


@pytest.mark.parametrize("attention_layer", [1, 3, 5, 7])
def test_torch_generator_attention_blend(pair, attention_layer):
    jgen, np_vars, tgen = pair
    w1, w2 = _wplus(jgen, 10 + attention_layer), _wplus(jgen, 20 + attention_layer)
    mask = np.random.default_rng(attention_layer).random((2, 8, 8, 1)).astype(np.float32)
    j_feats = _japply(jgen, np_vars, [jnp.asarray(w1)], input_is_latent=True,
                      randomize_noise=False, return_features=True).feature_map
    want = jax.jit(lambda v, w, m, f: jgen.apply(
        v, [w], input_is_latent=True, randomize_noise=False,
        attention_layer=attention_layer, attention_map=m, feature_map=f))(
        jax.tree.map(jnp.asarray, np_vars), jnp.asarray(w2), jnp.asarray(mask),
        j_feats)
    with torch.no_grad():
        t_feats = tgen([t(w1)], input_is_latent=True, randomize_noise=False,
                       return_features=True).feature_map
        got = tgen([t(w2)], input_is_latent=True, randomize_noise=False,
                   attention_layer=attention_layer, attention_map=t(mask),
                   feature_map=t_feats)
    close(got.image, want.image, IMG_TOL)
    assert t_bti(attention_layer) == j_bti(attention_layer)


def test_torch_generator_tap_controls(pair):
    jgen, np_vars, tgen = pair
    w = _wplus(jgen, 3)
    keep = (0, 3, 6, 9)
    want = _japply(jgen, np_vars, [jnp.asarray(w)], input_is_latent=True,
                   randomize_noise=False, return_features=True,
                   tap_subsample=8, tap_indices=keep)
    with torch.no_grad():
        got = tgen([t(w)], input_is_latent=True, randomize_noise=False,
                   return_features=True, tap_subsample=8, tap_indices=keep)
    for i, (gf, wf) in enumerate(zip(got.feature_map, want.feature_map)):
        if i in keep:
            assert gf.shape[1] <= 8
            close(gf, wf, IMG_TOL)
        else:
            assert gf is None and wf is None

"""The port's CLIP image tower, whole CLIP and the CLIP loss's resize
against the JAX package's (where2edit_tpu/models/clip_model.py,
losses/clip_loss.py) on the same weights and inputs.

A small CLIP (width 64, 2 blocks, 32² patches of a 224² image) keeps the
test fast; its LayerNorm parameters are perturbed so every key carries
weight. Weights cross through ``convert.clip_state_dict`` (the inverse of
where2edit_tpu/convert/clip.py), which also round-trips an OpenAI-layout
state dict bit for bit. Image features and logits agree to 1e-4 (fp32,
two blocks), the resize to 1e-6 (one banded matrix per axis).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from where2edit_tpu.convert.clip import convert_clip_params
from where2edit_tpu.losses.clip_loss import _resize_matrix as j_matrix
from where2edit_tpu.losses.clip_loss import clip_image_resize as j_resize
from where2edit_tpu.models.clip_model import CLIP as JCLIP
from where2edit_tpu.models.clip_model import normalize_image as j_normalize
from where2edit_tpu_torch import convert
from where2edit_tpu_torch.losses.clip_loss import (
    CLIPLoss,
    _resize_matrix,
    clip_image_resize,
)
from where2edit_tpu_torch.models.clip_model import (
    CLIP,
    clip_from_state_dict,
    load_clip_state,
    normalize_image,
)

from torch_parity import close, np_tree, t

TOL = 1e-4
SMALL = dict(embed_dim=32, image_resolution=224, vision_width=64, vision_layers=2,
             vision_patch_size=32, text_width=64, text_heads=2, text_layers=2,
             vision_heads=2)


def _perturb_ln(tree, rng):
    def visit(node, path):
        if isinstance(node, dict):
            return {k: visit(v, path + (k,)) for k, v in node.items()}
        if any(p.startswith("ln") for p in path):
            return (np.asarray(node) + 0.2 * rng.standard_normal(node.shape)).astype(np.float32)
        return node
    return visit(tree, ())


@pytest.fixture(scope="module")
def clips():
    jm = JCLIP(**SMALL)
    v = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
                                jnp.zeros((1, 77), jnp.int32)))()
    v = {"params": _perturb_ln(np_tree(v["params"]), np.random.default_rng(0))}
    tm = load_clip_state(CLIP(**SMALL), convert.clip_state_dict(v))
    return jm, v, tm.eval()


def _inputs(seed=0, b=2, size=224):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)
    tokens = np.zeros((b, 77), np.int32)
    for i in range(b):
        n = 3 + i
        tokens[i, 0] = 49406
        tokens[i, 1:n] = rng.integers(1, 500, n - 1)
        tokens[i, n] = 49407
    return img, tokens


def test_torch_clip_image_features_match_jax(clips):
    jm, v, tm = clips
    img, _ = _inputs()
    want = jm.apply(jax.tree.map(jnp.asarray, v), jnp.asarray(img),
                    method=jm.encode_image)
    with torch.no_grad():
        got = tm.encode_image(t(img))
    assert got.shape == (2, 32)
    close(got, want, TOL)


def test_torch_clip_logits_match_jax(clips):
    jm, v, tm = clips
    img, tokens = _inputs(seed=1)
    want_i, want_t = jm.apply(jax.tree.map(jnp.asarray, v), jnp.asarray(img),
                              jnp.asarray(tokens))
    with torch.no_grad():
        got_i, got_t = tm(t(img), torch.from_numpy(tokens).long())
    close(got_i, want_i, TOL)
    close(got_t, want_t, TOL)


def test_torch_clip_state_dict_round_trips_openai_layout():
    """A random OpenAI-layout state dict → JAX params (the JAX converter) →
    ``convert.clip_state_dict`` gives it back bit for bit, and the port
    loads it as it is, sized from its shapes."""
    tm = CLIP(**SMALL, rng=torch.Generator().manual_seed(3))
    sd = {k: v.clone() for k, v in tm.state_dict().items()}
    sd["input_resolution"] = torch.tensor(224)  # TorchScript archives carry these
    jv = convert_clip_params({k: v.numpy() for k, v in sd.items()},
                             vision_layers=2, text_layers=2)
    back = convert.clip_state_dict(jv)
    assert set(back) == set(sd) - {"input_resolution"}
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k
    built = clip_from_state_dict(sd)
    assert built.visual.patch_size == 32 and len(built.visual.transformer.resblocks) == 2
    for k, v in built.state_dict().items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("size", [16, 32, 64, 1024])
def test_torch_clip_image_resize_matches_jax(size):
    img = np.random.default_rng(size).uniform(-1, 1, (1, size, size, 3)).astype(np.float32)
    want = np.asarray(j_resize(jnp.asarray(img), size))
    got = clip_image_resize(t(img), size).numpy()
    assert got.shape == (1, 224, 224, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if size >= 32:  # the banded matrix itself, bit for bit
        np.testing.assert_array_equal(_resize_matrix(size, 7, size // 32).numpy(),
                                      j_matrix(size, 7, size // 32))


def test_torch_clip_loss_and_normalize(clips):
    jm, v, tm = clips
    img, tokens = _inputs(seed=2, size=64)
    np.testing.assert_allclose(normalize_image(t(img * 0.5 + 0.5)).numpy(),
                               np.asarray(j_normalize(jnp.asarray(img * 0.5 + 0.5))),
                               rtol=1e-6, atol=1e-6)
    loss = CLIPLoss(tm, 64)
    with torch.no_grad():
        got = loss(t(img), torch.from_numpy(tokens).long())
        feats = loss.encode_image(t(img))
    want_i, _ = jm.apply(jax.tree.map(jnp.asarray, v), j_resize(jnp.asarray(img), 64),
                         jnp.asarray(tokens))
    close(got, 1.0 - np.asarray(want_i) / 100.0, TOL)
    assert feats.shape == (2, 32)

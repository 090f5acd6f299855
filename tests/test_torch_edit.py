"""The whole slice on the CPU: the port's EditSession.load_latent + edit
against the JAX package's capture + one_text_edit at size 32
(attention_layer = cluster_layer = 7), on the same generator and mapper
weights, the same W+ and the same text features. The seeded path differs
by construction (torch and JAX random streams), so W+ comes from numpy.

Tolerances: image 2e-3 (two syntheses, as tests/test_generator.py),
edited styles and attention map 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from where2edit_tpu.demo.api import one_text_edit as j_one_text_edit
from where2edit_tpu.editing.attention_mappers import (
    FullSpaceMapperFEATClusterLinStyle as JMapper,
)
from where2edit_tpu.editing.attention_mappers import tap_controls
from where2edit_tpu_torch import convert
from where2edit_tpu_torch.demo.api import EditSession
from where2edit_tpu_torch.editing.attention_mappers import (
    FullSpaceMapperFEATClusterLinStyle as TMapper,
)
from where2edit_tpu_torch.kernels import modconv1x1 as k3
from where2edit_tpu_torch.kernels import modconv3x3 as k1
from where2edit_tpu_torch.models.stylegan2 import Generator

from torch_parity import close, jax_generator, np_tree, perturb, t, torch_generator

SIZE, LAYER = 32, 7


def _random_models(seed):
    """Generator and mapper from seeded random weights (the text tower is
    stubbed in these tests)."""
    rng = torch.Generator().manual_seed(seed)
    gen = Generator(SIZE, rng=rng)
    mapper = TMapper(layers=gen.n_latent, attention_layer=LAYER,
                     cluster_layer=LAYER, generator_size=SIZE, rng=rng)
    return gen.eval(), mapper.eval()


@pytest.fixture(scope="module")
def setup():
    jgen, gvars = jax_generator(SIZE, seed=3)
    jg = jax.tree.map(jnp.asarray, gvars)
    rng = np.random.default_rng(3)
    wplus = rng.standard_normal((2, jgen.n_latent, 512)).astype(np.float32)
    text = rng.standard_normal((2, 512)).astype(np.float32)
    att = rng.standard_normal((2, 512)).astype(np.float32)
    blend, keep = tap_controls(SIZE, LAYER, LAYER)
    cap = jax.jit(lambda v, w: jgen.apply(
        v, [w], input_is_latent=True, randomize_noise=False,
        return_features=True, tap_subsample=blend, tap_indices=keep))(
        jg, jnp.asarray(wplus))
    const = jnp.broadcast_to(jg["params"]["input"]["input"], (2, 4, 4, 512))
    feats = list(cap.feature_map) + [const]
    jm = JMapper(layers=jgen.n_latent, attention_layer=LAYER,
                 cluster_layer=LAYER, generator_size=SIZE)
    mv = jax.jit(lambda *a: jm.init({"params": jax.random.PRNGKey(1)}, *a,
                                    blend, deterministic_noise=True))(
        jnp.asarray(text), cap.style_vector, feats)
    mv = {k: dict(x) for k, x in np_tree(mv).items()}
    mv["params"] = perturb(mv["params"], rng)
    mv["params"]["initial_bias"] = np.zeros((1,), np.float32)
    return jgen, jg, jm, mv, cap, feats, wplus, text, att


def test_torch_edit_session_matches_one_text_edit(setup):
    jgen, jg, jm, mv, cap, feats, wplus, text, att = setup
    img, new_lat, amap, _ = jax.jit(lambda g, m, tx, a, lat, f: j_one_text_edit(
        generator=jgen, gen_vars=g, mapper=jm, mapper_vars=m, text_features=tx,
        attention_text_features=a, latent=lat, feature_map=f,
        attention_layer=LAYER, strength_alpha=0.2, attention_threshold=0.6))(
        jg, jax.tree.map(jnp.asarray, mv), jnp.asarray(text), jnp.asarray(att),
        cap.style_vector, feats)

    tgen = torch_generator(jax.tree.map(np.asarray, jg), SIZE)
    tm = TMapper(layers=tgen.n_latent, attention_layer=LAYER,
                 cluster_layer=LAYER, generator_size=SIZE)
    convert.load_converted(tm, convert.mapper_state_dict(mv))
    # a stub text encoder: token row [i] reads feature row i
    table = t(np.concatenate([text, att]))
    prompt, region = np.array([[0], [1]]), np.array([[2], [3]])
    session = EditSession(generator=tgen, mapper=tm.eval(),
                          clip_encode_text=lambda tok: table[tok[:, 0]],
                          attention_layer=LAYER)
    n1, n3 = k1.launches, k3.launches
    orig = session.load_latent(t(wplus))
    close(orig, cap.image, 2e-3)
    text_t, att_t = session.encode(prompt, region)
    got_lat, got_map = session.predict(text_t, att_t, strength_alpha=0.2,
                                       attention_threshold=0.6)
    for gs, ws in zip(got_lat, new_lat):
        close(gs, ws, 1e-4)
    close(got_map, amap, 1e-4)
    got_img, got_map2 = session.edit(prompt, region, strength_alpha=0.2,
                                     attention_threshold=0.6)
    assert torch.equal(got_map, got_map2)
    close(got_img, img, 2e-3)
    assert (k1.launches, k3.launches) == (n1, n3)  # CPU: plain path only


def test_torch_edit_prompt_sweep_broadcasts(setup):
    """One loaded face, two prompt rows: a batch-2 edit whose rows equal
    the two single-prompt edits."""
    *_, wplus, text, att = setup
    gen, mapper = _random_models(0)
    table = t(text)
    session = EditSession(generator=gen, mapper=mapper,
                          clip_encode_text=lambda tok: table[tok[:, 0]],
                          attention_layer=LAYER)
    session.load_latent(t(wplus[:1]))
    both, maps = session.edit(np.array([[0], [1]]), strength_alpha=0.3)
    one, map_a = session.edit(np.array([[0]]), strength_alpha=0.3)
    two, map_b = session.edit(np.array([[1]]), strength_alpha=0.3)
    assert both.shape == (2, SIZE, SIZE, 3) and maps.shape[0] == 2
    close(both[:1], one, 1e-5)
    close(both[1:], two, 1e-5)
    close(maps, torch.cat([map_a, map_b]), 1e-6)


def test_torch_one_text_edit_and_subsample(setup):
    """The functional one_text_edit equals the session's edit, and
    subsample_for_mapper matches the JAX package's."""
    from where2edit_tpu.demo.api import subsample_for_mapper as j_sub  # noqa: PLC0415
    from where2edit_tpu_torch.demo.api import (  # noqa: PLC0415
        one_text_edit,
        subsample_for_mapper,
    )

    *_, wplus, text, att = setup
    gen, mapper = _random_models(1)
    table = t(np.concatenate([text, att]))
    session = EditSession(generator=gen, mapper=mapper,
                          clip_encode_text=lambda tok: table[tok[:, 0]],
                          attention_layer=LAYER)
    session.load_latent(t(wplus))
    prompt, region = np.array([[0], [1]]), np.array([[2], [3]])
    img, amap = session.edit(prompt, region, strength_alpha=0.2)
    with torch.no_grad():
        img2, _, amap2 = one_text_edit(
            generator=gen, mapper=mapper, text_features=t(text),
            attention_text_features=t(att), latent=session.latent,
            feature_map=session.feature_map, attention_layer=LAYER,
            strength_alpha=0.2)
    close(img2, img, 1e-5)
    close(amap2, amap, 1e-6)

    rng = np.random.default_rng(9)
    feats = [rng.standard_normal((1, r, r, 4)).astype(np.float32)
             for r in (4, 8, 16, 32, 4)]
    keep = {1, 3}
    got = subsample_for_mapper([t(f) for f in feats], 8, keep)
    want = j_sub([jnp.asarray(f) for f in feats], 8, keep)
    for g_, w_ in zip(got, want):
        assert (g_ is None) == (w_ is None)
        if g_ is not None:
            close(g_, w_, 0.0)


def test_torch_edit_cli_writes_pngs(tmp_path):
    from where2edit_tpu_torch.cli import edit  # noqa: PLC0415

    results = edit.main(["--seed", "3", "--text", "grey hair", "red lips",
                         "--batch_prompts", "--stylegan_size", str(SIZE),
                         "--attention_layer", str(LAYER), "--cluster_layer",
                         str(LAYER), "--device", "cpu", "--output_dir",
                         str(tmp_path)])
    assert [r["text"] for r in results] == ["grey hair", "red lips"]
    assert (tmp_path / "original.png").exists()
    for r in results:
        assert os.path.exists(r["edit"]) and os.path.exists(r["attention_map"])

"""The W+ edit on the CPU: the port's ``EditSession(work_in_stylespace=
False)`` (capture, the W+ cluster mapper at inference, ``latent + delta``,
the blended synthesis from the new W+) against the JAX package's capture
and ``one_text_edit(work_in_stylespace=False)`` at generator size 32
(attention_layer = cluster_layer = 7), on the same generator and mapper
weights, the same W+ and the same text features.

Tolerances: the captured image 2e-3 (as tests/test_torch_edit.py), the new
W+ and the attention map 1e-4; the edited image 1e-4 from the same taps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from where2edit_tpu.demo.api import one_text_edit as j_one_text_edit
from where2edit_tpu.editing.attention_mappers import (
    FullSpaceMapperFEATClusterLin as JMapper,
)
from where2edit_tpu.editing.attention_mappers import tap_controls
from where2edit_tpu_torch import convert
from where2edit_tpu_torch.demo.api import EditSession, one_text_edit
from where2edit_tpu_torch.editing.attention_mappers import (
    FullSpaceMapperFEATClusterLin as TMapper,
)
from where2edit_tpu_torch.editing.attention_mappers import (
    FullSpaceMapperFEATLin,
)

from torch_parity import close, jax_generator, np_tree, position_centres, t, torch_generator

SIZE, LAYER = 32, 7


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(2)
    jgen, gvars = jax_generator(SIZE, seed=5)
    jg = jax.tree.map(jnp.asarray, gvars)
    rng = np.random.default_rng(5)
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
    mv = jm.init({"params": jax.random.PRNGKey(2)}, jnp.asarray(text),
                 jnp.asarray(wplus), feats, blend)
    mv = {k: dict(x) for k, x in np_tree(mv).items()}
    # the head's bias at 1 (not 5), so the map crosses the thresholds
    mv["params"]["att"] = dict(mv["params"]["att"])
    mv["params"]["att"]["attention_last"] = dict(
        mv["params"]["att"]["attention_last"], bias=np.ones((1,), np.float32))
    mv["clusters"] = {"initial_state": position_centres(rng)}
    tgen = torch_generator(gvars, SIZE)
    tm = TMapper(layers=tgen.n_latent, attention_layer=LAYER, cluster_layer=LAYER,
                 generator_size=SIZE)
    tm.load_state_dict(convert.feat_mapper_state_dict(mv))
    return dict(jgen=jgen, jg=jg, jm=jm, mv=mv, cap=cap, feats=feats, wplus=wplus,
                text=text, att=att, tgen=tgen, tm=tm.eval())


def _jax_edit(s, feats, threshold=0.6):
    return jax.jit(lambda g, m, tx, a, lat, f: j_one_text_edit(
        generator=s["jgen"], gen_vars=g, mapper=s["jm"], mapper_vars=m,
        text_features=tx, attention_text_features=a, latent=lat, feature_map=f,
        attention_layer=LAYER, work_in_stylespace=False,
        attention_threshold=threshold))(
        s["jg"], jax.tree.map(jnp.asarray, s["mv"]), jnp.asarray(s["text"]),
        jnp.asarray(s["att"]), jnp.asarray(s["wplus"]), feats)


def _session(s, mapper=None):
    table = t(np.concatenate([s["text"], s["att"]]))
    return EditSession(generator=s["tgen"], mapper=mapper or s["tm"],
                       clip_encode_text=lambda tok: table[tok[:, 0]],
                       attention_layer=LAYER, work_in_stylespace=False)


def test_torch_wplus_edit_session_matches_jax(setup):
    s = setup
    img, new_lat, amap, _ = _jax_edit(s, s["feats"])
    session = _session(s)
    orig = session.load_latent(t(s["wplus"]))
    close(orig, s["cap"].image, 2e-3)
    assert torch.equal(session.latent, t(s["wplus"]))  # the W+ is kept
    prompt, region = np.array([[0], [1]]), np.array([[2], [3]])
    text_t, att_t = session.encode(prompt, region)
    got_lat, got_map = session.predict(text_t, att_t, attention_threshold=0.6)
    assert got_lat.shape == (2, s["tgen"].n_latent, 512)
    close(got_lat, new_lat, 1e-4)
    assert got_map.shape == amap.shape == (2, 16, 16, 1)
    close(got_map, amap, 1e-4)
    amap_np = np.asarray(amap)
    assert 0.0 < float((amap_np > 0).mean()) < 1.0  # the threshold cuts
    got_img, got_map2 = session.edit(prompt, region, attention_threshold=0.6)
    assert torch.equal(got_map, got_map2)
    close(got_img, img, 2e-3)


def test_torch_wplus_one_text_edit_from_the_same_taps(setup):
    """From JAX's own captured taps: the port's one synthesis against
    JAX's, image and map within 1e-4."""
    s = setup
    img, new_lat, amap, _ = _jax_edit(s, s["feats"], threshold=0.75)
    with torch.no_grad():
        got_img, got_lat, got_map = one_text_edit(
            generator=s["tgen"], mapper=s["tm"], text_features=t(s["text"]),
            attention_text_features=t(s["att"]), latent=t(s["wplus"]),
            feature_map=[t(f) for f in s["feats"]], attention_layer=LAYER,
            work_in_stylespace=False)
    close(got_lat, new_lat, 1e-4)
    close(got_map, amap, 1e-4)
    close(got_img, img, 1e-4)


def test_torch_wplus_prompt_sweep_and_mapper_without_clusters(setup):
    """One W+ face and two prompt rows give the two single edits; a mapper
    without ``cluster_layer`` (``FullSpaceMapperFEATLin``) captures at the
    attention layer's taps."""
    s = setup
    session = _session(s)
    session.load_latent(t(s["wplus"][:1]))
    both, maps = session.edit(np.array([[0], [1]]))
    one, map_a = session.edit(np.array([[0]]))
    two, map_b = session.edit(np.array([[1]]))
    close(both[:1], one, 1e-5)
    close(both[1:], two, 1e-5)
    close(maps, torch.cat([map_a, map_b]), 1e-6)
    lin = FullSpaceMapperFEATLin(layers=s["tgen"].n_latent, attention_layer=LAYER,
                                 generator_size=SIZE,
                                 rng=torch.Generator().manual_seed(3)).eval()
    assert not hasattr(lin, "cluster_layer")
    plain = _session(s, lin)
    plain.load_latent(t(s["wplus"][:1]))
    img, amap = plain.edit(np.array([[0]]))
    assert img.shape == (1, SIZE, SIZE, 3) and bool(torch.isfinite(img).all())
    assert amap.shape == (1, 16, 16, 1)

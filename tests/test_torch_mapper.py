"""The port's FullSpaceMapperFEATClusterLinStyle against the JAX package's
at generator size 32 with attention_layer = cluster_layer = 7 (a conv tap
at 16² with 512 channels, so cluster_dim stays 576), deterministic noise,
on the same weights.

The cluster tap is built from well-separated prototypes (squared distance
~9000 between prototypes against < 300 from the position channels), so the
cluster ids must match exactly. Styles, attention map and losses agree to
1e-4 (fp32, short sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from where2edit_tpu.editing.attention_mappers import (
    FullSpaceMapperFEATClusterLinStyle as JMapper,
)
from where2edit_tpu.editing.attention_mappers import attention_tables as j_tables
from where2edit_tpu.editing.attention_mappers import tap_controls as j_controls
from where2edit_tpu.editing.clustering import assign_clusters as j_assign
from where2edit_tpu_torch import convert
from where2edit_tpu_torch.editing.attention_mappers import (
    FullSpaceMapperFEATClusterLinStyle as TMapper,
)
from where2edit_tpu_torch.editing.attention_mappers import attention_tables
from where2edit_tpu_torch.editing.attention_mappers import tap_controls
from where2edit_tpu_torch.editing.clustering import assign_clusters

from torch_parity import close, np_tree, perturb, t

SIZE, LAYER, BLEND, K = 32, 7, 16, 10
TOL = 1e-4


def _inputs(batch=2, seed=0):
    rng = np.random.default_rng(seed)
    tab = j_tables(SIZE)
    res = [4, 4] + [r for k in range(3) for r in [8 * 2 ** k] * 3]
    feats = [rng.standard_normal((batch, r, r, c)).astype(np.float32)
             for r, c in zip(res, tab["tap_channels"])]
    protos = (rng.standard_normal((K, 512)) * 3.0).astype(np.float32)
    which = rng.integers(0, K, (batch, BLEND, BLEND))
    feats[LAYER - 1] = (protos[which] + 0.1 * rng.standard_normal(
        (batch, BLEND, BLEND, 512))).astype(np.float32)
    feats.append(rng.standard_normal((batch, 4, 4, 512)).astype(np.float32))
    centers = np.concatenate([protos, np.zeros((K, 64), np.float32)], axis=1)
    styles = [rng.standard_normal((batch, d)).astype(np.float32)
              for d in tab["stylespace_dims"]]
    text = rng.standard_normal((batch, 512)).astype(np.float32)
    att = rng.standard_normal((batch, 512)).astype(np.float32)
    return feats, centers, styles, text, att


@pytest.fixture(scope="module")
def mappers():
    feats, centers, styles, text, _ = _inputs()
    jm = JMapper(layers=8, attention_layer=LAYER, cluster_layer=LAYER,
                 generator_size=SIZE)
    v = jax.jit(lambda *a: jm.init({"params": jax.random.PRNGKey(0)}, *a,
                                   BLEND, deterministic_noise=True))(
        jnp.asarray(text), [jnp.asarray(s) for s in styles],
        [jnp.asarray(f) for f in feats])
    v = {k: dict(x) for k, x in np_tree(v).items()}
    v["params"] = perturb(v["params"], np.random.default_rng(1))
    v["params"]["initial_bias"] = np.zeros((1,), np.float32)
    v["clusters"] = {"initial_state": centers}
    tm = TMapper(layers=8, attention_layer=LAYER, cluster_layer=LAYER,
                 generator_size=SIZE)
    convert.load_converted(tm, convert.mapper_state_dict(v))
    return jm, v, tm.eval()


def test_torch_mapper_tables_match():
    for size in (32, 1024):
        assert attention_tables(size) == j_tables(size)
    for layer in (7, 13):
        assert tap_controls(1024, layer, layer) == j_controls(1024, layer, layer)


def test_torch_mapper_cluster_ids_exact(mappers):
    _, v, _ = mappers
    feats, centers, *_ = _inputs()
    want = np.asarray(j_assign(jnp.asarray(feats[LAYER - 1]), jnp.asarray(centers)))
    got = assign_clusters(t(feats[LAYER - 1]), t(centers)).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > K  # both samples, many clusters each


@pytest.mark.parametrize("finalize", [False, True])
def test_torch_mapper_styles_and_map(mappers, finalize):
    jm, v, tm = mappers
    feats, _, styles, text, att = _inputs(seed=0)
    want = jax.jit(lambda vv, tx, s, f, a: jm.apply(
        vv, tx, s, f, BLEND, attention_text=a, strength_alpha=0.2,
        pooled_map=True, finalize=finalize, deterministic_noise=True))(
        jax.tree.map(jnp.asarray, v), jnp.asarray(text),
        [jnp.asarray(s) for s in styles], [jnp.asarray(f) for f in feats],
        jnp.asarray(att))
    with torch.no_grad():
        got = tm(t(text), [t(s) for s in styles], [t(f) for f in feats], BLEND,
                 attention_text=t(att), strength_alpha=0.2, pooled_map=True,
                 finalize=finalize, deterministic_noise=True)
    assert len(got.latents) == len(want.latents)
    for gs, ws in zip(got.latents, want.latents):
        close(gs, ws, TOL)
    assert got.attention_map.shape == (2, BLEND, BLEND, 1)
    close(got.attention_map, want.attention_map, TOL)
    for gl, wl in zip(got.losses, want.losses):
        close(gl, wl, TOL)


def test_torch_mapper_random_noise_needs_generator(mappers):
    _, _, tm = mappers
    feats, _, styles, text, _ = _inputs(batch=1, seed=3)
    args = (t(text), [t(s) for s in styles], [t(f) for f in feats], BLEND)
    with pytest.raises(ValueError), torch.no_grad():
        tm(*args)
    with torch.no_grad():
        a = tm(*args, rng=torch.Generator().manual_seed(5)).attention_map
        b = tm(*args, rng=torch.Generator().manual_seed(5)).attention_map
    assert torch.equal(a, b)

"""The port's W+ FEAT mappers and their S-space twin against the JAX
package's (where2edit_tpu/editing/attention_mappers.py) at generator size
32 on the same weights: ``FullSpaceMapperFEATLin``,
``FullSpaceMapperFEATClusterLin`` (W+) and ``FullSpaceMapperFEATLinStyle``
(S-space, no clusters), with ``train`` True and False.

Weights cross both ways: JAX variables through ``convert.
feat_mapper_state_dict`` into the port, and the port's ``state_dict()``
(reference keys) through the JAX package's own readers
(``convert_feat_cluster_lin``, ``convert_fullspace_featlin``,
``convert_featlin_style``) into JAX. The cluster tap is built from
well-separated prototypes, so the k-means ids match exactly. Latents, maps
and loss terms agree to 1e-4 (fp32, short sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from where2edit_tpu.convert import mappers as jconv
from where2edit_tpu.editing import attention_mappers as jam
from where2edit_tpu_torch import convert
from where2edit_tpu_torch.editing import attention_mappers as tam

from torch_parity import close, np_tree, t

SIZE, LAYER, BLEND, K, N_LATENT = 32, 7, 16, 10, 8
TOL = 1e-4


def _inputs(batch=2, seed=0):
    """Taps (the const input appended), centres, W+, styles, text."""
    rng = np.random.default_rng(seed)
    tab = jam.attention_tables(SIZE)
    res = [4, 4] + [r for k in range(3) for r in [8 * 2 ** k] * 3]
    feats = [rng.standard_normal((batch, r, r, c)).astype(np.float32)
             for r, c in zip(res, tab["tap_channels"])]
    protos = (rng.standard_normal((K, 512)) * 3.0).astype(np.float32)
    which = rng.integers(0, K, (batch, BLEND, BLEND))
    feats[LAYER - 1] = (protos[which] + 0.1 * rng.standard_normal(
        (batch, BLEND, BLEND, 512))).astype(np.float32)
    feats.append(rng.standard_normal((batch, 4, 4, 512)).astype(np.float32))
    centers = np.concatenate([protos, np.zeros((K, 64), np.float32)], axis=1)
    wplus = rng.standard_normal((batch, N_LATENT, 512)).astype(np.float32)
    styles = [rng.standard_normal((batch, d)).astype(np.float32)
              for d in tab["stylespace_dims"]]
    text = rng.standard_normal((batch, 512)).astype(np.float32)
    return feats, centers, wplus, styles, text


def _jn(tree):
    return jax.tree.map(jnp.asarray, tree)


def _randomise_biases(params, rng):
    """Every bias random (a fresh init leaves them at 0, the trunk's head
    at 5: its sigmoid would sit above the 0.8 threshold everywhere)."""
    def visit(node, name):
        if isinstance(node, dict):
            return {k: visit(v, k) for k, v in node.items()}
        if name == "bias":
            return (rng.standard_normal(node.shape) * 0.5).astype(np.float32)
        return node
    return visit(params, "")


JAX_CLASSES = {
    "FullSpaceMapperFEATLin": dict(attention_layer=LAYER),
    "FullSpaceMapperFEATClusterLin": dict(attention_layer=LAYER, cluster_layer=LAYER),
    "FullSpaceMapperFEATLinStyle": dict(attention_layer=LAYER),
}


def _pair(name, seed=0):
    """(JAX module, numpy variables, port module loaded from them)."""
    feats, centers, wplus, styles, text = _inputs()
    kw = JAX_CLASSES[name]
    jm = getattr(jam, name)(layers=N_LATENT, generator_size=SIZE, **kw)
    latent = ([jnp.asarray(s) for s in styles] if name.endswith("Style")
              else jnp.asarray(wplus))
    v = jm.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(text), latent,
                [jnp.asarray(f) for f in feats], BLEND)
    v = {k: dict(x) for k, x in np_tree(v).items()}
    v["params"] = _randomise_biases(v["params"], np.random.default_rng(seed + 1))
    if "clusters" in v:
        v["clusters"] = {"initial_state": centers}
    tm = getattr(tam, name)(layers=N_LATENT, generator_size=SIZE, **kw)
    tm.load_state_dict(convert.feat_mapper_state_dict(v))
    return jm, v, tm.eval()


def _compare(name, train):
    jm, v, tm = _pair(name)
    feats, _, wplus, styles, text = _inputs(seed=4)
    style = name.endswith("Style")
    jlat = [jnp.asarray(s) for s in styles] if style else jnp.asarray(wplus)
    want = jm.apply(_jn(v), jnp.asarray(text), jlat,
                    [jnp.asarray(f) for f in feats], BLEND, train=train)
    tlat = [t(s) for s in styles] if style else t(wplus)
    with torch.no_grad():
        got = tm(t(text), tlat, [t(f) for f in feats], BLEND, train=train)
    if style:
        assert len(got.latents) == len(want.latents)
        for g, w in zip(got.latents, want.latents):
            close(g, w, TOL)
    else:
        assert got.latents.shape == (2, N_LATENT, 512)
        close(got.latents, want.latents, TOL)
    assert got.attention_map.shape == want.attention_map.shape == (2, BLEND, BLEND, 1)
    close(got.attention_map, want.attention_map, TOL)
    for g, w in zip(got.losses, want.losses):
        close(g, w, TOL)
    return got


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", sorted(JAX_CLASSES))
def test_torch_feat_mappers_match_jax(name, train):
    got = _compare(name, train)
    if name != "FullSpaceMapperFEATLinStyle":  # no delta above the mapper layer
        mapper_layer = jam.attention_tables(SIZE)["w_code_num"][LAYER]
        assert float(got.latents[:, mapper_layer:].abs().max()) == 0.0


def test_torch_feat_cluster_map_pools_only_in_training():
    _, _, tm = _pair("FullSpaceMapperFEATClusterLin")
    feats, _, wplus, _, text = _inputs(seed=4)
    args = (t(text), t(wplus), [t(f) for f in feats], 999)
    with torch.no_grad():
        pooled = tm(*args, train=True)
        raw = tm(*args, train=False)
    # the size comes from the cluster tap, not from the caller
    assert pooled.attention_map.shape == raw.attention_map.shape == (2, BLEND, BLEND, 1)
    assert float(raw.loss_reg) == 0.0 and float(pooled.loss_reg) >= 0.0
    assert not torch.equal(pooled.attention_map, raw.attention_map)
    assert torch.equal(pooled.latents, raw.latents)
    assert tm.coverage_threshold == 0.8


@pytest.mark.parametrize("name,reader", [
    ("FullSpaceMapperFEATClusterLin", "convert_feat_cluster_lin"),
    ("FullSpaceMapperFEATLin", "convert_fullspace_featlin"),
])
def test_torch_wplus_keys_read_by_jax_converters(name, reader):
    """The port's state dict, as it is, through the JAX package's reader
    of reference checkpoints gives back the JAX variables bitwise."""
    jm, v, tm = _pair(name)
    tree = getattr(jconv, reader)(
        {k: x.clone() for k, x in tm.state_dict().items()}, attention_layer=LAYER)
    flat = jax.tree_util.tree_flatten_with_path(np_tree(tree))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(v)[0])
    assert {p for p, _ in flat} == set(want)
    for path, leaf in flat:
        np.testing.assert_array_equal(leaf, want[path])


def test_torch_featlin_style_keys_read_by_jax_converter():
    """``convert_featlin_style`` reads the reference's 1024² tap list, so
    the key check runs at 1024² (no forward): every entry it reads is the
    port's parameter, bitwise, and it reads all of them."""
    tm = tam.FullSpaceMapperFEATLinStyle(layers=18, attention_layer=13,
                                         rng=torch.Generator().manual_seed(0))
    sd = tm.state_dict()
    tree = np_tree(jconv.convert_featlin_style(dict(sd), attention_layer=13))
    back = convert.feat_mapper_state_dict(tree)
    assert set(back) == set(sd)
    for k, x in sd.items():
        assert torch.equal(back[k], x), k
    assert {k.split(".")[0] for k in sd if k.startswith("mapper_")} == {
        f"mapper_{c}" for c in range(13)}


def test_torch_wplus_tables_match_jax():
    assert tam.wplus_dim_table(2) == jam.wplus_dim_table(2)
    assert tam.style_dim_table(1) == jam.style_dim_table(1)
    assert tam.wplus_dim_table(2) == tam.attention_tables(1024)["wplus_dims"]


def test_torch_feat_trunk_composes_the_unfused_convs():
    """The composed trunk equals the reference's order of operations: each
    tap's 1x1 conv to 32 channels, the concat, the 32·L → 1 conv."""
    _, _, tm = _pair("FullSpaceMapperFEATLin")
    feats, *_ = _inputs(seed=6)
    fm = [t(f).double() for f in feats]
    tm = tm.double()
    taps = [(fm[-1], tm.attention_first)]
    taps += [(fm[tm.layer_num[c]], getattr(tm, f"attention_{c}"))
             for c in range(N_LATENT - 1)]
    with torch.no_grad():
        maps = [tam._conv_then_resize(conv, f, BLEND) for f, conv in taps]
        want = tm.attention_last(torch.cat(maps, dim=-1))
        got = tam._feat_trunk(tm, fm, BLEND)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10, atol=1e-10)


def test_torch_cluster_mapper_without_centres_refuses():
    _, _, tm = _pair("FullSpaceMapperFEATClusterLin")
    tm.initial_state = None
    feats, _, wplus, _, text = _inputs()
    with pytest.raises(RuntimeError, match="no k-means centres"):
        tm(t(text), t(wplus), [t(f) for f in feats], BLEND, train=False)
    assert "initial_state" not in tm.state_dict()

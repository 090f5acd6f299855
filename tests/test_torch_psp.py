"""The port's pSp composite and the real-photo edit path against the JAX
package's, on the CPU at stylegan_size 32 (8 W+ rows), e4e input 64²,
batch 2. One checkpoint dict in the reference layout (``encoder.*`` drawn
with numpy, ``decoder.*`` converted from the JAX generator's perturbed
variables, ``latent_avg``) loads into both ``PSp``s.

Tolerances: W+ 1e-4 (as tests/test_torch_encoders.py); images 2e-3 and
edited styles and attention map 1e-4 (as tests/test_torch_edit.py).
"""

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
from where2edit_tpu.models.psp import PSp as JPSp
from where2edit_tpu_torch import convert
from where2edit_tpu_torch.demo.api import EditSession
from where2edit_tpu_torch.editing.attention_mappers import (
    FullSpaceMapperFEATClusterLinStyle as TMapper,
)
from where2edit_tpu_torch.models.encoders import Encoder4Editing
from where2edit_tpu_torch.models.psp import PSp, get_keys

from test_torch_encoders import numpy_state_dict
from torch_parity import close, jax_generator, np_tree, perturb, t

SIZE, LAYER, N_LATENT = 32, 7, 8
W_TOL, IMG_TOL, TOL = 1e-4, 2e-3, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the tier-1 run puts six test processes on the
    machine's cores, where more threads per process spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jgen, gvars = jax_generator(SIZE, seed=3)
    enc = numpy_state_dict(lambda: Encoder4Editing(stylegan_size=SIZE), seed=7)
    dec = convert.generator_state_dict(gvars, SIZE)
    state = {**{f"encoder.{k}": v for k, v in enc.items()},
             **{f"decoder.{k}": v for k, v in dec.items()}}
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    avg = {1: rng.standard_normal(512).astype(np.float32),
           2: rng.standard_normal((N_LATENT, 512)).astype(np.float32)}
    jpsp = JPSp.from_torch_checkpoint({"state_dict": state}, stylegan_size=SIZE)
    return jgen, gvars, state, x, avg, jpsp


def _psps(setup, ndim):
    """(port PSp loaded with a ``latent_avg`` of ``ndim`` dims (0: none),
    the JAX PSp with the same average)."""
    _, _, state, _, avg, jpsp = setup
    ckpt = {"state_dict": state}
    if ndim:
        ckpt["latent_avg"] = torch.from_numpy(avg[ndim])
    jpsp.latent_avg = jnp.asarray(avg[ndim]) if ndim else None
    return PSp.from_state_dict(ckpt, stylegan_size=SIZE, device="cpu"), jpsp


def test_torch_psp_get_keys():
    d = {"state_dict": {"encoder.a": 1, "encoder.b.c": 2, "decoder.a": 3}}
    assert get_keys(d, "encoder") == {"a": 1, "b.c": 2}
    assert get_keys(d["state_dict"], "decoder") == {"a": 3}


@pytest.mark.parametrize("ndim", [0, 1, 2])
def test_torch_psp_encode_latent_avg(setup, ndim):
    x = setup[3]
    tpsp, jpsp = _psps(setup, ndim)
    got = tpsp.encode(t(x))
    want = jpsp.encode(jnp.asarray(x))
    assert tuple(got.shape) == want.shape == (2, N_LATENT, 512)
    close(got, want, W_TOL)


@pytest.mark.parametrize("kw", [
    {},                                                       # encode, decode, 256² pool
    {"latent_mask": [1, 3], "inject": True, "alpha": 0.3,
     "resize": False},                                        # blended injection
    {"latent_mask": [2], "inject": True, "resize": False},    # plain injection
    {"latent_mask": [0, 5], "resize": False},                 # rows zeroed
    {"input_code": True, "resize": False},                    # codes as z
])
def test_torch_psp_call(setup, kw):
    x = setup[3]
    tpsp, jpsp = _psps(setup, 2)
    kw = dict(kw)
    inject = np.random.default_rng(9).standard_normal(
        (2, N_LATENT, 512)).astype(np.float32) if kw.pop("inject", False) else None
    inp = x
    if kw.get("input_code"):
        inp = np.asarray(jpsp.encode(jnp.asarray(x)))
    got, got_lat, _ = tpsp(t(inp), inject_latent=None if inject is None else t(inject),
                           return_latents=True, **kw)
    want, want_lat, _ = jpsp(jnp.asarray(inp), inject_latent=None if inject is None
                             else jnp.asarray(inject), return_latents=True, **kw)
    assert got.shape == want.shape
    assert got.shape[1] == (SIZE if kw.get("resize") is False else 256)
    close(got, want, IMG_TOL)
    close(got_lat, want_lat, W_TOL)


def test_torch_real_photo_path(setup):
    """encode -> load_latent -> edit, against the JAX chain (encode ->
    capture -> one_text_edit) on the same weights and text features."""
    jgen, gvars, _, x, _, _ = setup
    tpsp, jpsp = _psps(setup, 2)
    jg = jax.tree.map(jnp.asarray, gvars)
    rng = np.random.default_rng(10)
    text = rng.standard_normal((2, 512)).astype(np.float32)
    att = rng.standard_normal((2, 512)).astype(np.float32)
    blend, keep = tap_controls(SIZE, LAYER, LAYER)
    w = jpsp.encode(jnp.asarray(x))
    cap = jax.jit(lambda v, w: jgen.apply(
        v, [w], input_is_latent=True, randomize_noise=False,
        return_features=True, tap_subsample=blend, tap_indices=keep))(jg, w)
    feats = list(cap.feature_map) + [
        jnp.broadcast_to(jg["params"]["input"]["input"], (2, 4, 4, 512))]
    jm = JMapper(layers=N_LATENT, attention_layer=LAYER, cluster_layer=LAYER,
                 generator_size=SIZE)
    mv = jax.jit(lambda *a: jm.init({"params": jax.random.PRNGKey(1)}, *a,
                                    blend, deterministic_noise=True))(
        jnp.asarray(text), cap.style_vector, feats)
    mv = {k: dict(v) for k, v in np_tree(mv).items()}
    mv["params"] = perturb(mv["params"], rng)
    mv["params"]["initial_bias"] = np.zeros((1,), np.float32)
    img, new_lat, amap, _ = jax.jit(lambda g, m, tx, a, lat, f: j_one_text_edit(
        generator=jgen, gen_vars=g, mapper=jm, mapper_vars=m, text_features=tx,
        attention_text_features=a, latent=lat, feature_map=f,
        attention_layer=LAYER, strength_alpha=0.2, attention_threshold=0.6))(
        jg, jax.tree.map(jnp.asarray, mv), jnp.asarray(text), jnp.asarray(att),
        cap.style_vector, feats)

    tm = TMapper(layers=N_LATENT, attention_layer=LAYER, cluster_layer=LAYER,
                 generator_size=SIZE)
    convert.load_converted(tm, convert.mapper_state_dict(mv))
    table = t(np.concatenate([text, att]))  # token row [i] reads feature row i
    session = EditSession(generator=tpsp.decoder, mapper=tm.eval(),
                          clip_encode_text=lambda tok: table[tok[:, 0]],
                          attention_layer=LAYER)
    wt = tpsp.encode(t(x))
    close(wt, w, W_TOL)
    close(session.load_latent(wt), cap.image, IMG_TOL)
    prompt, region = np.array([[0], [1]]), np.array([[2], [3]])
    text_t, att_t = session.encode(prompt, region)
    got_lat, got_map = session.predict(text_t, att_t, strength_alpha=0.2,
                                       attention_threshold=0.6)
    for gs, ws in zip(got_lat, new_lat):
        close(gs, ws, TOL)
    close(got_map, amap, TOL)
    close(session.render(got_lat, got_map), img, IMG_TOL)

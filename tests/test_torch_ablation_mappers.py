"""The reference's ablation mapper nets and ``editing/modules.py`` of the
port against the JAX package's, on the CPU, on the same weights.

The port's ``state_dict()`` (the reference's keys) goes through the JAX
package's own readers of reference checkpoints
(``where2edit_tpu/convert/mappers.py``) into JAX variables, which also
proves the keys are the reference's; the three building blocks go through
the readers' block helpers. Widths are cut (64-wide latents, 64-wide text)
except where a class fixes them. Random draws (the attention jitter, the
Gumbel noise, the strength jitter, CANet's reparametrisation) come from one
numpy stream that both packages read in the same order. Outputs and loss
terms agree to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from where2edit_tpu.convert import mappers as jconv
from where2edit_tpu.editing import attention_mappers as jam
from where2edit_tpu.editing import modules as jmod
from where2edit_tpu_torch import editing
from where2edit_tpu_torch.editing import attention_mappers as tam
from where2edit_tpu_torch.editing import modules as tmod

from torch_parity import close, t

TOL = 1e-4
LAT, TXT, LAYERS, BATCH = 64, 64, 4, 2


class _Stream:
    """Numpy draws in call order: ``normal`` and ``uniform`` of a shape."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def normal(self, shape):
        return self.rng.standard_normal(tuple(shape)).astype(np.float32)

    def uniform(self, shape):
        return self.rng.uniform(size=tuple(shape)).astype(np.float32)


class _JaxRandom:
    def __init__(self, stream):
        self.stream = stream

    def __getattr__(self, name):
        return getattr(jax.random, name)

    def normal(self, key, shape=(), dtype=jnp.float32):
        return jnp.asarray(self.stream.normal(shape), dtype)

    def uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(self.stream.uniform(shape), dtype)


class _Jax:
    """``jax`` with its random draws read from a ``_Stream``."""

    def __init__(self, stream):
        self.random = _JaxRandom(stream)

    def __getattr__(self, name):
        return getattr(jax, name)


@pytest.fixture
def streams(monkeypatch):
    """Both packages' draws from the same numpy stream (seed 7)."""
    js, ts = _Stream(7), _Stream(7)
    shim = _Jax(js)
    monkeypatch.setattr(jmod, "jax", shim)
    monkeypatch.setattr(jam, "jax", shim)

    def normal(shape, rng, like):
        return torch.from_numpy(ts.normal(shape)).to(like)

    def uniform(shape, rng, like):
        return torch.from_numpy(ts.uniform(shape)).to(like)

    monkeypatch.setattr(tmod, "normal", normal)
    monkeypatch.setattr(tmod, "uniform", uniform)
    monkeypatch.setattr(tam, "uniform", uniform)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return {"text": rng.standard_normal((BATCH, TXT)).astype(np.float32),
            "wplus": rng.standard_normal((BATCH, LAYERS, LAT)).astype(np.float32),
            "rng": rng}


def _spatial_inputs(d, size=8):
    """14 W+ rows, and the 13 taps the net reads (its 1024² cm-1 tap list),
    all at 8²; the others None. The text is ``LAT`` wide (``proj_text``)."""
    rng = d["rng"]
    feats = [None] * 19
    for c, i in enumerate(tam.FullSpaceMapperSpatialLin.LAYER_NUM):
        feats[i] = rng.standard_normal(
            (BATCH, size, size, tam.FullSpaceMapperSpatialLin.DIMS[c])).astype(np.float32)
    wplus = rng.standard_normal((BATCH, 14, LAT)).astype(np.float32)
    return wplus, feats, size


def _att_lin_style_styles(d, layers=6):
    total = layers + (layers - 2) // 2
    return [d["rng"].standard_normal((BATCH, tam.FullSpaceMapperAttLinStyle.DIMS[c]))
            .astype(np.float32) for c in range(total)]


def _block(reader, prefix="m"):
    """A JAX block reader on the port's block keys, under one prefix."""
    def read(sd):
        return {"params": reader({f"{prefix}.{k}": v for k, v in sd.items()}, prefix)}
    return read


# name: (port kwargs, JAX reader of the port's state dict, takes ``train``)
CASES = {
    "MapperNet": (dict(in_dim=TXT + LAT, latent_dim=LAT), _block(jconv._mapper_net), False),
    "MapperConNet": (dict(in_dim=TXT + LAT, latent_dim=LAT),
                     _block(jconv._mapper_con_net), False),
    "MapperConLinNet": (dict(in_dim=TXT + LAT, latent_dim=LAT),
                        _block(jconv._mapper_conlin_net), False),
    "FullSpaceMapper": (dict(layers=LAYERS, in_dim=TXT + LAT, latent_dim=LAT),
                        jconv.convert_fullspace, False),
    "FullSpaceMapperCon": (dict(layers=LAYERS, in_dim=TXT + LAT, latent_dim=LAT),
                           jconv.convert_fullspace_con, False),
    "FullSpaceMapperAtt": (dict(layers=LAYERS, in_dim=TXT + LAT, latent_dim=LAT),
                           jconv.convert_fullspace_att, True),
    "FullSpaceMapperAttLin": (dict(layers=LAYERS, in_dim=TXT + LAT, latent_dim=LAT),
                              jconv.convert_fullspace_attlin, True),
    "FullSpaceMapperSpatialLin": (dict(layers=14, in_dim=2 * LAT, latent_dim=LAT),
                                  jconv.convert_fullspace_spatiallin, True),
    "FullSpaceMapperAttLinStyle": (dict(layers=6, in_dim=TXT + LAT, latent_dim=LAT),
                                   jconv.convert_attlin_style, True),
}


def _randomise(module, seed):
    """Non-zero biases (a fresh init leaves them at 0)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for n, p in module.named_parameters():
            if n.endswith("bias"):
                p.copy_(0.3 * torch.randn(p.shape, generator=g))
    return module


def _call(name, module, d, train, package):
    """Run ``module`` (JAX: ``(jax module, variables)``) on ``d``."""
    if package == "jax":
        jm, v = module
        conv = jnp.asarray

        def run(*args, **kw):
            return jm.apply(v, *args, rngs={"noise": jax.random.PRNGKey(0)}, **kw)
    else:
        conv = t

        def run(*args, **kw):
            with torch.no_grad():
                return module(*args, **kw)
    kw = {"train": train} if CASES[name][2] else {}
    text, wplus = conv(d["text"]), conv(d["wplus"])
    if name == "MapperNet":
        x = np.concatenate([d["text"][:, None], d["wplus"][:, :1]], axis=-1)
        return run(conv(x))
    if name in ("MapperConNet", "MapperConLinNet"):
        return run(conv(d["text"][:, None]), conv(d["wplus"][:, :1]))
    if name == "FullSpaceMapperSpatialLin":
        w, feats, size = d["spatial"]
        text = conv(d["rng_text_lat"])
        return run(text, conv(w), [None if f is None else conv(f) for f in feats],
                   size, **kw)
    if name == "FullSpaceMapperAttLinStyle":
        return run(text, [conv(s) for s in d["styles"]], **kw)
    return run(text, wplus, **kw)


@pytest.mark.parametrize("name,train", [
    (name, train) for name, (_, _, takes_train) in CASES.items()
    for train in ((False, True) if takes_train else (False,))])
def test_torch_ablation_mappers_match_jax(name, train, streams):
    kw, reader, _ = CASES[name]
    port = _randomise(getattr(tam, name)(**kw, rng=torch.Generator().manual_seed(1)),
                      2).eval()
    jm = getattr(jam, name)(**kw)
    variables = jax.tree.map(jnp.asarray,
                             reader({k: v.clone() for k, v in port.state_dict().items()}))
    d = _data(3)
    d["spatial"] = _spatial_inputs(d)
    d["rng_text_lat"] = d["rng"].standard_normal((BATCH, LAT)).astype(np.float32)
    d["styles"] = _att_lin_style_styles(d)
    want = _call(name, (jm, variables), d, train, "jax")
    got = _call(name, port, d, train, "torch")
    if name.startswith("Mapper"):
        close(got, want, TOL)
        return
    if isinstance(want.latents, (list, tuple)):
        assert len(got.latents) == len(want.latents)
        for g, w in zip(got.latents, want.latents):
            close(g, w, TOL)
    else:
        close(got.latents, want.latents, TOL)
    assert (got.attention_map is None) == (want.attention_map is None)
    if want.attention_map is not None:
        close(got.attention_map, want.attention_map, TOL)
    for g, w in zip(got.losses, want.losses):
        close(g, w, TOL)
    # every parameter of the port is read by the JAX reader
    n_jax = sum(np.asarray(x).size for x in jax.tree.leaves(variables))
    assert n_jax == sum(p.numel() for p in port.parameters())


def test_torch_ablation_mappers_exported_and_draw_from_the_generator():
    """The classes are exported from ``editing`` as in the JAX package; the
    training-time draws come from the ``torch.Generator`` given."""
    for name in CASES:
        assert getattr(editing, name) is getattr(tam, name)
    m = tam.FullSpaceMapperAtt(layers=LAYERS, in_dim=TXT + LAT, latent_dim=LAT,
                               rng=torch.Generator().manual_seed(0)).eval()
    d = _data(4)
    args = (t(d["text"]), t(d["wplus"]))
    with torch.no_grad():
        a = m(*args, train=True, rng=torch.Generator().manual_seed(3)).latents
        b = m(*args, train=True, rng=torch.Generator().manual_seed(3)).latents
        c = m(*args, train=True, rng=torch.Generator().manual_seed(4)).latents
        e = m(*args, train=False).latents
        f = m(*args, train=False).latents
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.equal(e, f)


def test_torch_editing_modules_match_jax(streams):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((7, 6)).astype(np.float32)
    b = rng.standard_normal((3, 6)).astype(np.float32)
    close(tmod.pairwise_distance(t(a), t(b)),
          jmod.pairwise_distance(jnp.asarray(a), jnp.asarray(b)), 1e-5)
    x = rng.standard_normal((2, 3, 8)).astype(np.float32)
    close(tmod.Multiply(2.5)(t(x)), jmod.Multiply(2.5).apply({}, jnp.asarray(x)), 0.0)
    close(tmod.GLU()(t(x)), jmod.GLU().apply({}, jnp.asarray(x)), 1e-6)
    mu, lv = rng.standard_normal((2, 2, 4)).astype(np.float32)
    close(tmod.kl_loss(t(mu), t(lv)), jmod.kl_loss(jnp.asarray(mu), jnp.asarray(lv)), 1e-6)
    key = {"noise": jax.random.PRNGKey(0)}
    for train in (False, True):
        close(tmod.AddNoise(0.5)(t(x), train=train),
              jmod.AddNoise(0.5).apply({}, jnp.asarray(x), train=train, rngs=key), 1e-6)
        close(tmod.GumbelSoftmax(0.7)(t(x), train=train),
              jmod.GumbelSoftmax(0.7).apply({}, jnp.asarray(x), train=train, rngs=key),
              1e-5)
    canet = tmod.CANet(16, 4, rng=torch.Generator().manual_seed(0))
    jc = jmod.CANet(16, 4)
    v = {"params": {"fc": {"kernel": jnp.asarray(canet.fc.weight.detach().numpy().T),
                           "bias": jnp.asarray(0.1 + canet.fc.bias.detach().numpy())}}}
    with torch.no_grad():
        canet.fc.bias.add_(0.1)
    emb = rng.standard_normal((2, 16)).astype(np.float32)
    for train in (False, True):
        with torch.no_grad():
            got = canet(t(emb), train=train)
        want = jc.apply(v, jnp.asarray(emb), train=train, rngs=key)
        for g, w in zip(got, want):
            close(g, w, 1e-5)
    assert set(canet.state_dict()) == {"fc.weight", "fc.bias"}
    hard = tmod.GumbelSoftmax()(t(x), train=False)
    assert torch.equal(hard.sum(-1), torch.ones(2, 3))

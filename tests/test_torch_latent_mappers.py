"""The port's StyleCLIP latent mappers (``editing/latent_mappers.py``,
``editing/styleclip_mapper.py``) against the JAX package's, on the CPU.

JAX inits each mapper; its biases are perturbed (a fresh init leaves them
at zero) and the variables reach the port through
``convert.latent_mapper_state_dict``. Inputs come from one numpy seed: a
W+ batch at the 64² generator's 10 rows (every ``LevelsMapper`` group has
rows) whose rows differ in scale, and that generator's 14 style vectors.
Outputs within 1e-5 of their largest magnitude (fp32 both sides, four
512-wide linears summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from where2edit_tpu.editing import latent_mappers as jlm
from where2edit_tpu.editing.styleclip_mapper import build_mapper as jbuild
from where2edit_tpu_torch import convert
from where2edit_tpu_torch.editing import latent_mappers as tlm
from where2edit_tpu_torch.editing.styleclip_mapper import StyleCLIPMapper, build_mapper
from where2edit_tpu_torch.nn.layers import PixelNorm

from torch_parity import jax_generator, np_tree, t, torch_generator

TOL = 1e-5
SIZE, ROWS, N_STYLES, BATCH = 64, 10, 14, 3

CASES = [
    ("SingleMapper", {}),
    ("LevelsMapper", {}),
    ("LevelsMapper", {"no_coarse_mapper": True}),
    ("LevelsMapper", {"no_medium_mapper": True}),
    ("LevelsMapper", {"no_fine_mapper": True}),
    ("FullStyleSpaceMapper", {}),
    ("WithoutToRGBStyleSpaceMapper", {}),
]


def _wplus(rng) -> np.ndarray:
    """(BATCH, ROWS, 512) with row r scaled by 3^(r/3): the row-axis
    PixelNorm sees rows of different norms."""
    scale = 3.0 ** (np.arange(ROWS) / 3.0)
    return (rng.standard_normal((BATCH, ROWS, 512)) * scale[None, :, None]).astype(np.float32)


def _styles(rng) -> list:
    return [rng.standard_normal((BATCH, tlm.STYLESPACE_DIMENSIONS[c])).astype(np.float32)
            for c in range(N_STYLES)]


def _jax_mapper(mapper_type: str, flags: dict, x, seed: int = 0) -> dict:
    """(flax mapper, numpy variables with N(0, 30) biases: lr_mul 0.01
    takes them to 0.3 at run time)."""
    rng = np.random.default_rng(seed)
    jm = jbuild(mapper_type, **flags)
    arg = [jnp.asarray(s) for s in x] if isinstance(x, list) else jnp.asarray(x)
    variables = np_tree(jax.jit(lambda a: jm.init({"params": jax.random.PRNGKey(seed)}, a))(arg))

    def visit(node, name=""):
        if isinstance(node, dict):
            return {k: visit(v, k) for k, v in node.items()}
        return ((rng.standard_normal(node.shape) * 30).astype(np.float32)
                if name == "bias" else node)
    return jm, {"params": visit(dict(variables["params"]))}


def _close(got: torch.Tensor, want, tol: float = TOL):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


@pytest.mark.parametrize("mapper_type,flags", CASES,
                         ids=[f"{m}-{'-'.join(f) or 'all'}" for m, f in CASES])
def test_torch_latent_mapper_matches_jax(mapper_type, flags):
    rng = np.random.default_rng(1)
    stylespace = "StyleSpace" in mapper_type
    x = _styles(rng) if stylespace else _wplus(rng)
    jm, jvars = _jax_mapper(mapper_type, flags, x)
    arg = [jnp.asarray(s) for s in x] if stylespace else jnp.asarray(x)
    want = jax.jit(jm.apply)(jvars, arg)

    tm = build_mapper(mapper_type, n_styles=N_STYLES, **flags)
    tm.load_state_dict(convert.latent_mapper_state_dict(jvars, mapper_type, **flags))
    with torch.no_grad():
        got = tm([t(s) for s in x] if stylespace else t(x))
    if stylespace:
        assert len(got) == len(want) == N_STYLES
        for c, (g, w) in enumerate(zip(got, want)):
            if isinstance(tm, tlm.WithoutToRGBStyleSpaceMapper) and c % 3 == 1:
                assert not g.any() and not np.asarray(w).any(), c
            else:
                _close(g, w)
    else:
        _close(got, want)
        for flag, rows in (("no_coarse_mapper", slice(0, 4)),
                           ("no_medium_mapper", slice(4, 8)),
                           ("no_fine_mapper", slice(8, ROWS))):
            assert (not got[:, rows].any()) == bool(flags.get(flag)), flag


def test_torch_mapper_pixel_norm_runs_over_rows():
    """The reference's ``PixelNorm`` in the StyleCLIP ``Mapper`` normalises
    ``dim=1``, the W+ rows: a per-feature scale of the input leaves the
    output as it is, a per-row scale does not; on a (B, C) style vector
    ``dim=1`` is the feature axis."""
    rng = np.random.default_rng(2)
    x = t(_wplus(rng))
    m = tlm.Mapper(rng=torch.Generator().manual_seed(0))
    norm = m.mapping[0]
    assert isinstance(norm, PixelNorm) and norm.dim == 1
    want = x * torch.rsqrt(x.square().mean(1, keepdim=True) + 1e-8)
    torch.testing.assert_close(norm(x), want, rtol=0, atol=0)
    per_feature = t(rng.uniform(0.5, 2.0, (1, 1, 512)))
    per_row = t(rng.uniform(0.5, 2.0, (1, ROWS, 1)))
    with torch.no_grad():
        base = m(x)
        torch.testing.assert_close(m(x * per_feature), base, rtol=1e-5, atol=1e-5)
        assert (m(x * per_row) - base).abs().max() > 1e-2
        s = x[:, 0]
        torch.testing.assert_close(norm(s), s * torch.rsqrt(s.square().mean(1, keepdim=True)
                                                             + 1e-8))


@pytest.mark.parametrize("mapper_type", ["SingleMapper", "LevelsMapper", "FullStyleSpaceMapper",
                                         "WithoutToRGBStyleSpaceMapper"])
def test_torch_latent_mapper_keys_are_the_reference_names(mapper_type):
    """The state-dict keys of the reference's ``mapper/latent_mappers.py``
    at 1024²: ``mapping.{1..4}`` under each ``Mapper`` (index 0 is the
    PixelNorm)."""
    def mapper_keys(prefix):
        return {f"{prefix}.mapping.{i}.{p}" for i in range(1, 5) for p in ("weight", "bias")}

    groups = {
        "SingleMapper": ["mapping"],
        "LevelsMapper": ["course_mapping", "medium_mapping", "fine_mapping"],
        "FullStyleSpaceMapper": [f"mapper_{c}" for c in range(26)],
        "WithoutToRGBStyleSpaceMapper": [f"mapper_{c}" for c in range(26) if c % 3 != 1],
    }[mapper_type]
    assert tlm.STYLESPACE_DIMENSIONS == jlm.STYLESPACE_DIMENSIONS
    assert tlm.STYLESPACE_INDICES_WITHOUT_TORGB == jlm.STYLESPACE_INDICES_WITHOUT_TORGB
    with torch.device("meta"):
        sd = build_mapper(mapper_type).state_dict()
    assert set(sd) == set().union(*map(mapper_keys, groups))
    if "StyleSpace" in mapper_type:
        for c in (0, 15, 18, 21, 24, 25):
            if f"mapper_{c}.mapping.1.weight" in sd:
                width = tlm.STYLESPACE_DIMENSIONS[c]
                assert tuple(sd[f"mapper_{c}.mapping.1.weight"].shape) == (width, width)
    with torch.device("meta"):
        levels = build_mapper("LevelsMapper", no_medium_mapper=True, n_styles=3,
                              unrelated_option=1).state_dict()
    assert not any(k.startswith("medium_mapping") for k in levels)


def test_torch_generator_stylespace_equals_style_vector():
    """``Generator.stylespace(w)`` is the forward's ``style_vector``, bit
    for bit, without the synthesis."""
    _, gvars = jax_generator(SIZE)
    gen = torch_generator(gvars, SIZE)
    w = t(_wplus(np.random.default_rng(3)))
    with torch.no_grad():
        want = gen([w], input_is_latent=True, randomize_noise=False,
                   return_latents=True).style_vector
        got = gen.stylespace(w)
    assert len(got) == len(want) == tlm.stylespace_count(SIZE) == N_STYLES
    for g, v in zip(got, want):
        assert torch.equal(g, v)


def test_torch_styleclip_mapper_edit_matches_jax():
    """``StyleCLIPMapper.edit`` in W+: ``w + 0.1·mapper(w)`` and its image
    with fixed noise, against the JAX composite; the face pool is 256²."""
    from where2edit_tpu.editing.styleclip_mapper import StyleCLIPMapper as JComposite  # noqa: PLC0415

    gen, gvars = jax_generator(SIZE)
    w = _wplus(np.random.default_rng(4)) / 3
    jm, jvars = _jax_mapper("LevelsMapper", {}, w)
    jnet = JComposite(mapper=jm, mapper_params=jvars["params"], generator=gen,
                      generator_vars=jax.tree.map(jnp.asarray, gvars))
    img_j, w_hat_j = jnet.edit(jnp.asarray(w))
    tm = build_mapper("LevelsMapper")
    tm.load_state_dict(convert.latent_mapper_state_dict(jvars, "LevelsMapper"))
    net = StyleCLIPMapper(tm, torch_generator(gvars, SIZE))
    with torch.no_grad():
        img, w_hat = net.edit(t(w))
    _close(w_hat, w_hat_j)
    _close(img, img_j, 1e-4)
    assert tuple(net.face_pool(img).shape) == (BATCH, 256, 256, 3)

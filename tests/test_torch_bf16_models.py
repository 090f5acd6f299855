"""The port's bf16 generator and discriminator against the JAX package's on
the same weights, inputs and noise (JAX ``Generator(dtype=bfloat16)``,
``Discriminator(dtype=bfloat16)``): both round activations to bf16 at
every layer, in other places, so neither is held to the other; each is
held to JAX fp32, the port's bf16 no further from it than JAX's own bf16:

- bar 1: max |port bf16 − JAX fp32| ≤ 1.5 · max |JAX bf16 − JAX fp32| + 1e-3;
- bar 2: SSIM(port bf16 image, JAX fp32 image) > 0.99 (JAX's own bar for
  its bf16 policy, tests/test_utils_extra.py::test_bf16_policy_ssim).

Also: the image of a bf16 generator is fp32 (the RGB chain stays fp32),
its taps bf16; the parameters stay fp32; the discriminator's score is fp32.
64² generator (channel multiplier 2, as JAX's SSIM test), 32²
discriminator (channel multiplier 1), batch 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from where2edit_tpu_torch import convert
from where2edit_tpu_torch.eval.ssim import ssim
from where2edit_tpu_torch.models.stylegan2 import Discriminator, Generator

from torch_parity import jax_generator, np_tree

BF = torch.bfloat16
RATIO, SLACK, SSIM_BAR = 1.5, 1e-3, 0.99


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _max_abs(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def test_torch_bf16_generator_tracks_jax():
    from where2edit_tpu.models.stylegan2 import Generator as JaxGenerator  # noqa: PLC0415

    size = 64
    jg32, variables = jax_generator(size, seed=3)
    jg16 = JaxGenerator(size=size, dtype=jnp.bfloat16)
    z = np.random.default_rng(5).standard_normal((2, 512)).astype(np.float32)
    want32 = np.asarray(jg32.apply(variables, [jnp.asarray(z)], randomize_noise=False).image)
    jax16 = jg16.apply(variables, [jnp.asarray(z)], randomize_noise=False).image
    assert jax16.dtype == jnp.float32
    jax16 = np.asarray(jax16)

    gen = Generator(size, dtype=BF)
    convert.load_converted(gen, convert.generator_state_dict(variables, size))
    gen.eval()
    assert all(p.dtype == torch.float32 for p in gen.parameters())
    with torch.no_grad():
        out = gen([torch.from_numpy(z)], randomize_noise=False, return_features=True)
    assert out.image.dtype == torch.float32
    assert out.feature_map[0].dtype == BF  # the taps in the compute dtype
    got = out.image.numpy()
    err_port, err_jax = _max_abs(got, want32), _max_abs(jax16, want32)
    assert 0 < err_port <= RATIO * err_jax + SLACK, (err_port, err_jax)
    score = float(ssim(out.image, torch.from_numpy(want32)))
    assert score > SSIM_BAR, score


def test_torch_bf16_discriminator_tracks_jax():
    from where2edit_tpu.models.stylegan2 import Discriminator as JaxDiscriminator  # noqa: PLC0415

    size, cm = 32, 1
    jd32 = JaxDiscriminator(size=size, channel_multiplier=cm)
    jd16 = JaxDiscriminator(size=size, channel_multiplier=cm, dtype=jnp.bfloat16)
    dv = np_tree(jax.jit(lambda: jd32.init({"params": jax.random.PRNGKey(4)},
                                           jnp.zeros((1, size, size, 3))))())
    x = np.random.default_rng(6).uniform(-1, 1, (4, size, size, 3)).astype(np.float32)
    want32 = np.asarray(jd32.apply(dv, jnp.asarray(x)))
    jax16 = np.asarray(jd16.apply(dv, jnp.asarray(x)), np.float32)

    d = Discriminator(size, cm, dtype=BF)
    convert.load_converted(d, convert.discriminator_state_dict(dv, size, cm))
    with torch.no_grad():
        got = d(torch.from_numpy(x))
    assert got.dtype == torch.float32
    err_port, err_jax = _max_abs(got.numpy(), want32), _max_abs(jax16, want32)
    assert 0 < err_port <= RATIO * err_jax + SLACK, (err_port, err_jax)


def test_torch_bf16_discriminator_remat_is_exact():
    """``remat`` recomputes each ResBlock in the backward pass: the score,
    the parameter gradients and R1's gradient of a gradient are bitwise
    those of the same discriminator without it."""
    torch.manual_seed(0)
    x = torch.rand(4, 16, 16, 3) * 2 - 1
    grads = []
    for remat in (False, True):
        d = Discriminator(16, 1, rng=torch.Generator().manual_seed(2), dtype=BF,
                          remat=remat)
        xr = x.clone().requires_grad_(True)
        score = d(xr)
        (gx,) = torch.autograd.grad(score.sum(), xr, create_graph=True)
        (score.sum() + gx.square().sum()).backward()
        grads.append([score.detach()] + [p.grad.clone() for p in d.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)

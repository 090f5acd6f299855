"""The port's discriminator layers and ``Discriminator`` against the JAX
package on the same weights (``where2edit_tpu_torch.convert``), on the
output and on the input gradient ∇ₓ.

The layers run in float64 on both sides (JAX under ``jax.enable_x64``):
their input gradients pass leaky-ReLU kinks, where a pre-activation that
rounds to opposite signs in two float32 computations takes the other slope,
an O(1) change at that element; in float64 that does not happen, so the
bar is 1e-9 relative to the largest magnitude. The whole discriminator runs
at 8² (its tower is 512 channels wide at any size up to 32²) in float32,
with the port's 1e-4 bar: at that size a pre-activation within float32
rounding of zero is improbable.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from where2edit_tpu_torch import convert
from where2edit_tpu_torch.models.stylegan2 import Discriminator
from where2edit_tpu_torch.nn.layers import ConvLayer, Downsample, EqualConv2d, ResBlock

from torch_parity import close, np_tree, perturb, t

TOL64 = 1e-9
TOL = 1e-4


def _jax_f64(module, x, seed=0):
    """(output, ∇ₓ Σ output·r, numpy params, r) of a flax layer in float64,
    activation biases perturbed away from their zero init, every parameter
    a float32 value (the converters hand the port float32 tensors)."""
    with jax.enable_x64(True):
        xj = jnp.asarray(x, jnp.float64)
        params = perturb(np_tree(jax.jit(module.init)(jax.random.PRNGKey(seed), xj)),
                         np.random.default_rng(seed), scale=0.5)
        params = jax.tree.map(
            lambda a: jnp.asarray(np.asarray(a, np.float32), jnp.float64), params)
        out = jax.jit(module.apply)(params, xj)
        r = np.random.default_rng(seed + 1).standard_normal(out.shape)
        grad = jax.jit(jax.grad(lambda v: jnp.sum(module.apply(params, v) * r)))(xj)
        return np.asarray(out), np.asarray(grad), np_tree(params), r


def _torch_f64(module, state_dict, x, r):
    module.double().load_state_dict(state_dict)
    xt = torch.from_numpy(np.asarray(x, np.float64)).requires_grad_(True)
    out = module(xt)
    (grad,) = torch.autograd.grad((out * torch.from_numpy(r)).sum(), xt)
    return out.detach().numpy(), grad.numpy()


def _rel_close(got, want, tol):
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


@pytest.mark.parametrize("k,stride,padding,bias", [
    (3, 1, 1, True), (1, 1, 0, True), (3, 2, 0, False), (3, 1, 1, False)])
def test_torch_equal_conv2d_matches_jax(k, stride, padding, bias):
    from where2edit_tpu.nn.layers import EqualConv2d as JEqualConv2d  # noqa: PLC0415

    x = np.random.default_rng(2).standard_normal((2, 9, 9, 5))
    out, grad, p, r = _jax_f64(JEqualConv2d(5, 6, k, stride=stride,
                                            padding=padding, use_bias=bias), x)
    sd = {"weight": t(np.asarray(p["params"]["weight"]).transpose(3, 2, 0, 1))}
    if bias:
        sd["bias"] = t(p["params"]["bias"])
    got, got_grad = _torch_f64(EqualConv2d(5, 6, k, stride=stride, padding=padding,
                                           bias=bias), sd, x, r)
    _rel_close(got, out, TOL64)
    _rel_close(got_grad, grad, TOL64)


@pytest.mark.parametrize("k,downsample,bias,activate", [
    (3, False, True, True),     # one K2 call: conv + activation bias + lrelu
    (3, True, True, True),      # blur, stride-2 conv, lrelu
    (3, False, True, False),    # K2 with the conv's own bias, no activation
    (1, True, False, False),    # the ResBlock skip
    (3, False, False, True),    # ScaledLeakyReLU
    (1, False, True, True),     # the discriminator's conv_in
])
def test_torch_conv_layer_matches_jax(k, downsample, bias, activate):
    from where2edit_tpu.nn.layers import ConvLayer as JConvLayer  # noqa: PLC0415

    x = np.random.default_rng(3).standard_normal((2, 8, 8, 5))
    out, grad, p, r = _jax_f64(JConvLayer(5, 6, k, downsample=downsample,
                                          use_bias=bias, activate=activate), x)
    sd = convert._conv_layer(p["params"], "m", downsample=downsample)
    sd = {key[2:]: v for key, v in sd.items()}
    got, got_grad = _torch_f64(ConvLayer(5, 6, k, downsample=downsample, bias=bias,
                                         activate=activate), sd, x, r)
    _rel_close(got, out, TOL64)
    _rel_close(got_grad, grad, TOL64)


def test_torch_downsample_matches_jax():
    from where2edit_tpu.nn.layers import Downsample as JDownsample  # noqa: PLC0415

    x = np.random.default_rng(6).standard_normal((2, 9, 8, 3))
    out, grad, _, r = _jax_f64(JDownsample(), x)
    got, got_grad = _torch_f64(Downsample(), Downsample().state_dict(), x, r)
    assert got.shape == (2, 4, 4, 3)
    _rel_close(got, out, TOL64)
    _rel_close(got_grad, grad, TOL64)


def test_torch_resblock_matches_jax():
    from where2edit_tpu.nn.layers import ResBlock as JResBlock  # noqa: PLC0415

    x = np.random.default_rng(4).standard_normal((2, 8, 8, 6))
    out, grad, p, r = _jax_f64(JResBlock(6, 8), x)
    sd = {}
    for name, down in (("conv1", False), ("conv2", True), ("skip", True)):
        sd.update(convert._conv_layer(p["params"][name], name, downsample=down))
    got, got_grad = _torch_f64(ResBlock(6, 8), sd, x, r)
    assert got.shape == (2, 4, 4, 8)
    _rel_close(got, out, TOL64)
    _rel_close(got_grad, grad, TOL64)


@pytest.fixture(scope="module")
def discriminators():
    from where2edit_tpu.models.stylegan2 import Discriminator as JDiscriminator  # noqa: PLC0415

    size = 8
    jd = JDiscriminator(size=size, channel_multiplier=1)
    variables = jax.jit(lambda: jd.init({"params": jax.random.PRNGKey(0)},
                                        jnp.zeros((1, size, size, 3))))()
    variables = perturb(np_tree(variables), np.random.default_rng(0))
    td = Discriminator(size, channel_multiplier=1)
    convert.load_converted(td, convert.discriminator_state_dict(variables, size, 1))
    return jd, variables, td


def test_torch_discriminator_matches_jax(discriminators):
    """Batch 8: two samples per minibatch-stddev group of 4."""
    jd, variables, td = discriminators
    x = np.random.default_rng(5).uniform(-1, 1, (8, 8, 8, 3)).astype(np.float32)

    def pred_sum(v):
        out = jd.apply(variables, v)
        return jnp.sum(out), out

    (_, want), want_grad = jax.jit(jax.value_and_grad(pred_sum, has_aux=True))(
        jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    got = td(xt)
    (got_grad,) = torch.autograd.grad(got.sum(), xt)
    assert got.shape == (8, 1)
    close(got, want, TOL)
    _rel_close(got_grad.numpy(), np.asarray(want_grad), TOL)


def test_torch_discriminator_state_dict_layout(discriminators):
    """The converted state dict is the reference's key layout, one entry per
    parameter and FIR buffer of the port, and refuses a wrong width."""
    _, variables, td = discriminators
    sd = convert.discriminator_state_dict(variables, 8, 1)
    assert set(sd) == set(td.state_dict())
    assert {"convs.0.0.weight", "convs.0.1.bias", "convs.1.conv1.0.weight",
            "convs.1.conv2.0.kernel", "convs.1.skip.1.weight",
            "final_conv.1.bias", "final_linear.1.weight"} <= set(sd)
    assert tuple(sd["final_conv.0.weight"].shape) == (512, 513, 3, 3)
    with pytest.raises(ValueError, match="channel_multiplier"):
        convert.discriminator_state_dict(variables, 64, 1)

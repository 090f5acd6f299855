"""The port's StyleGAN2 layers against the JAX package's, on the same
weights: every ModulatedConv2d branch the edit path uses, StyledConv with
explicit noise, ToRGB with a skip.

Tolerance 1e-4: fp32 on both sides; the up-conv sums 9·C products.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from where2edit_tpu.nn import layers as jl
from where2edit_tpu_torch import convert
from where2edit_tpu_torch.kernels import modconv3x3 as k1
from where2edit_tpu_torch.kernels.common import tc_prepared_plain
from where2edit_tpu_torch.nn import layers as tl

from torch_parity import close, np_tree, perturb, t

TOL = 1e-4


def _init(module, *args, **kw):
    key = jax.random.PRNGKey(0)
    v = module.init({"params": key, "noise": key}, *args, **kw)
    return np_tree(v)["params"]


def _sd(fn, p, **kw):
    """A convert helper's keys with their prefix stripped."""
    return {k[len("m."):]: v for k, v in fn(p, "m", **kw).items()}


def _mod_conv_sd(p):
    sd = {"weight": convert._mod_conv_w(p["weight"])}
    if "modulation" in p:
        sd["modulation.weight"] = convert._lin_w(p["modulation"]["weight"])
        sd["modulation.bias"] = t(p["modulation"]["bias"])
    return sd


@pytest.mark.parametrize("k,demod,up,stylespace", [
    (3, True, False, False),
    (3, False, False, False),
    (3, True, True, False),
    (1, True, False, False),
    (1, False, False, False),
    (3, True, False, True),
    (1, True, False, True),
])
def test_torch_modulated_conv2d(k, demod, up, stylespace):
    rng = np.random.default_rng(k * 10 + demod + 2 * up + 4 * stylespace)
    cin, cout, sdim = 8, 12, 16
    x = rng.standard_normal((2, 6, 6, cin)).astype(np.float32)
    style = rng.standard_normal((2, cin if stylespace else sdim)).astype(np.float32)
    jm = jl.ModulatedConv2d(cin, cout, k, sdim, demodulate=demod, upsample=up)
    p = _init(jm, jnp.asarray(x), jnp.asarray(style),
              input_is_stylespace=stylespace)
    want, want_s = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(style),
                            input_is_stylespace=stylespace)
    tm = tl.ModulatedConv2d(cin, cout, k, sdim, demodulate=demod, upsample=up)
    missing, _ = tm.load_state_dict(_mod_conv_sd(p), strict=False)
    assert set(missing) <= {"modulation.weight", "modulation.bias",
                            "blur.kernel"}
    got, got_s = tm(t(x), t(style), input_is_stylespace=stylespace)
    assert got.shape == want.shape
    close(got, want, TOL)
    close(got_s, want_s, TOL)


@pytest.mark.parametrize("k,up", [(3, False), (3, True), (1, False)])
def test_torch_styled_conv_explicit_noise(k, up):
    rng = np.random.default_rng(20 + k + up)
    cin, cout, sdim = 8, 12, 16
    x = rng.standard_normal((2, 6, 6, cin)).astype(np.float32)
    style = rng.standard_normal((2, sdim)).astype(np.float32)
    r = 12 if up else 6
    noise = rng.standard_normal((1, r, r, 1)).astype(np.float32)
    jm = jl.StyledConv(cin, cout, k, sdim, upsample=up)
    p = _init(jm, jnp.asarray(x), jnp.asarray(style), noise=jnp.asarray(noise))
    p = perturb({"sc": p}, rng)["sc"]
    want, _ = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(style),
                       noise=jnp.asarray(noise))
    tm = tl.StyledConv(cin, cout, k, sdim, upsample=up)
    tm.load_state_dict(_sd(convert._styled_conv, p, upsample=up))
    got, _ = tm(t(x), t(style), noise=t(noise))
    close(got, want, TOL)


def test_torch_to_rgb_with_skip():
    rng = np.random.default_rng(30)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    style = rng.standard_normal((2, 24)).astype(np.float32)
    skip = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    jm = jl.ToRGB(16, 24)
    p = _init(jm, jnp.asarray(x), jnp.asarray(style), jnp.asarray(skip))
    p = perturb({"to_rgb": p}, rng)["to_rgb"]
    want, _ = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(style),
                       jnp.asarray(skip))
    tm = tl.ToRGB(16, 24)
    tm.load_state_dict(_sd(convert._to_rgb, p, upsample=True))
    got, _ = tm(t(x), t(style), t(skip))
    close(got, want, TOL)
    with torch.no_grad():
        no_skip, _ = tm(t(x), t(style))
    want_ns, _ = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(style))
    close(no_skip, want_ns, TOL)


def test_torch_equal_linear_and_pixel_norm():
    rng = np.random.default_rng(40)
    x = rng.standard_normal((3, 10)).astype(np.float32)
    for act in (None, "fused_lrelu"):
        jm = jl.EqualLinear(10, 6, lr_mul=0.5, bias_init=0.2, activation=act)
        p = _init(jm, jnp.asarray(x))
        tm = tl.EqualLinear(10, 6, lr_mul=0.5, activation=act)
        tm.load_state_dict(_sd(convert._equal_linear, p))
        close(tm(t(x)), jm.apply({"params": p}, jnp.asarray(x)), TOL)
    close(tl.pixel_norm(t(x)), jl.pixel_norm(jnp.asarray(x)), TOL)


@pytest.mark.parametrize("k,up", [(3, False), (1, False), (3, True)])
def test_torch_modulated_conv2d_prepared_weight_follows_updates(k, up, monkeypatch):
    """Inference reuses the kernel-layout weight, the demod norm and K1's
    prepared buffer until the weight changes (load_state_dict, an in-place
    update); with autograd on they are rebuilt each call, so gradients reach
    the weight, and K1 prepares its own. The buffer is None on the CPU; with
    its plain twin standing in for the card's preparation it follows the
    updates."""
    g = torch.Generator().manual_seed(k + 2 * up)
    m = tl.ModulatedConv2d(8, 12, k, 16, upsample=up, rng=g)
    x, style = torch.randn(2, 6, 6, 8, generator=g), torch.randn(2, 16, generator=g)
    with torch.no_grad():
        m(x, style)
        first = m.prepared_weight()
        assert m.prepared_weight() is first
        assert len(first) == 3 and first[2] is None
    monkeypatch.setattr(k1, "prepare_weight", tc_prepared_plain)
    updates = [lambda: m.load_state_dict({**m.state_dict(),
                                          "weight": torch.randn(m.weight.shape,
                                                                generator=g)}),
               lambda: m.weight.mul_(0.5)]
    for update in updates:
        with torch.no_grad():
            update()
            got, _ = m(x, style)
            assert m.prepared_weight() is not first
            first = m.prepared_weight()
            if k == 3 and not up:
                assert torch.equal(first[2], tc_prepared_plain(
                    m.weight[0].permute(2, 3, 1, 0)))
            else:
                assert first[2] is None
        want, _ = m(x, style)  # autograd on: built afresh
        assert m.prepared_weight()[2] is None
        assert torch.equal(got, want)
    want.square().sum().backward()
    assert m.weight.grad is not None and bool(m.weight.grad.abs().sum() > 0)

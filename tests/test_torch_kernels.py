"""K1, K2 and K3: the plain PyTorch versions against the TPU kernels they
replace, run the way tests/test_tools.py runs them: the tools/ modules
loaded by path, the Pallas kernels under pltpu.force_tpu_interpret_mode(),
and against their XLA/jnp references. Also the CPU dispatch of the
wrappers (plain version, no launch counted).

Tolerance 1e-4: fp32 everywhere, sums of at most 9·16 products.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from where2edit_tpu_torch.kernels import conv3x3 as k2
from where2edit_tpu_torch.kernels import modconv1x1 as k3
from where2edit_tpu_torch.kernels import modconv3x3 as k1

from torch_parity import close, t

TOL = 1e-4
TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "tools")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def k1_inputs():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 16, 16)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    style = (rng.random((2, 16)) + 0.5).astype(np.float32)
    demod = (rng.random((2, 16)) + 0.5).astype(np.float32)
    return x, w, bias, style, demod


@pytest.fixture(scope="module")
def k3_inputs():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 64, 32)).astype(np.float32)
    s = (rng.random((2, 32)) + 0.5).astype(np.float32)
    w = (rng.standard_normal((32, 3)) * 0.2).astype(np.float32)
    demod = (rng.random((2, 3)) + 0.5).astype(np.float32)
    return x, s, w, demod


def test_torch_k1_plain_matches_pallas_kernel(k1_inputs):
    x, w, bias, style, demod = k1_inputs
    mod = _load("conv3x3_bench")
    with pltpu.force_tpu_interpret_mode():
        want = mod.conv3x3_mod_fused(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(bias), jnp.asarray(style),
                                     jnp.asarray(demod), th=8)
    got = k1.modconv3x3_plain(t(x), t(style), t(w), t(demod), bias=t(bias),
                              act=True)
    close(got, want, TOL)
    close(got, mod.conv3x3_mod_xla(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(bias), jnp.asarray(style),
                                   jnp.asarray(demod)), TOL)


def test_torch_k2_plain_matches_pallas_kernel(k1_inputs):
    x, w, bias, _, _ = k1_inputs
    mod = _load("conv3x3_bench")
    with pltpu.force_tpu_interpret_mode():
        want = mod.conv3x3_fused(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(bias), th=8)
    got = k2.conv3x3_plain(t(x), t(w), 1.0, t(bias), True)
    close(got, want, TOL)
    close(got, mod.conv3x3_xla(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(bias)), TOL)


@pytest.mark.parametrize("with_demod", [True, False])
def test_torch_k3_plain_matches_pallas_kernel(k3_inputs, with_demod):
    x, s, w, demod = k3_inputs
    mod = _load("pallas_bench")
    d = demod if with_demod else None
    with pltpu.force_tpu_interpret_mode():
        want = mod.modulated_conv1x1(jnp.asarray(x), jnp.asarray(s),
                                     jnp.asarray(w),
                                     None if d is None else jnp.asarray(d),
                                     tile=32)
    got = k3.modconv1x1_plain(t(x), t(s), t(w), None if d is None else t(d))
    close(got, want, TOL)
    ones = np.ones((2, 3), np.float32)
    close(got, mod._jnp_reference(jnp.asarray(x), jnp.asarray(s),
                                  jnp.asarray(w),
                                  jnp.asarray(ones if d is None else d)), TOL)


def test_torch_k3_plain_epilogue_order(k3_inputs):
    """act(demod·conv + w_noise·noise + bias) + residual, per element."""
    x, s, w, demod = k3_inputs
    rng = np.random.default_rng(4)
    noise = rng.standard_normal((1, 64)).astype(np.float32)
    bias = rng.standard_normal(3).astype(np.float32)
    res = rng.standard_normal((2, 64, 3)).astype(np.float32)
    nw = np.float32(0.7)
    y = np.einsum("bpi,bi,io->bpo", x, s, w) * demod[:, None, :]
    y = y + nw * noise[..., None] + bias
    want = np.where(y >= 0, y, 0.2 * y) * np.sqrt(2.0) + res
    got = k3.modconv1x1_plain(t(x), t(s), t(w), t(demod), t(noise),
                              torch.tensor([nw]), t(bias), True, t(res))
    close(got, want, TOL)


def test_torch_cpu_wrappers_take_plain_path(k1_inputs, k3_inputs):
    x, w, bias, style, demod = k1_inputs
    n1, n3 = k1.launches, k3.launches
    noise = np.random.default_rng(5).standard_normal((2, 8, 8)).astype(np.float32)
    args = (t(x), t(style), t(w), t(demod), t(noise), torch.tensor([0.3]),
            t(bias), True)
    assert torch.equal(k1.modconv3x3(*args), k1.modconv3x3_plain(*args))
    xs, s, w3, d3 = k3_inputs
    args3 = (t(xs), t(s), t(w3), t(d3))
    assert torch.equal(k3.modconv1x1(*args3), k3.modconv1x1_plain(*args3))
    assert (k1.launches, k3.launches) == (n1, n3)


def test_torch_wrappers_refuse_other_devices():
    x = torch.empty(1, 4, 4, 4, device="meta")
    with pytest.raises(ValueError):
        k1.modconv3x3(x, torch.empty(1, 4, device="meta"),
                      torch.empty(3, 3, 4, 4, device="meta"))
    with pytest.raises(ValueError):
        k3.modconv1x1(x.reshape(1, 16, 4), torch.empty(1, 4, device="meta"),
                      torch.empty(4, 3, device="meta"))

"""The bf16 forms of K1, K2 and K3: each plain bf16 twin against the TPU
kernel it stands for, run on bf16 inputs as tests/test_torch_kernels.py
runs the fp32 ones (the tools/ modules loaded by path, the Pallas kernels
under pltpu.force_tpu_interpret_mode()); K3 with fp32 and with bf16
output, K2 at a Cin that is not a multiple of 8 (the one-value staging
path of the card's kernel); the CPU wrappers on bf16 tensors (the twins,
no launch counted); the bf16 weight layout's plain twin.

Bar: max |Δ| ≤ 8e-3 · max |Pallas|, one bf16 step at the largest value:
both round the same bf16 operands and sum in fp32 in another order, so a
value near a rounding boundary may land one step apart; K3's twin folds
s·w in fp32 where the Pallas kernel rounds x·s to bf16 first, which moves
the result by less than one step.
"""

import importlib.util
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from where2edit_tpu_torch.kernels import conv3x3 as k2
from where2edit_tpu_torch.kernels import modconv1x1 as k3
from where2edit_tpu_torch.kernels import modconv3x3 as k1
from where2edit_tpu_torch.kernels.common import tc_prepared_plain

REL = 8e-3
BF = torch.bfloat16
TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "tools")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16(a: np.ndarray) -> tuple:
    """The same bf16 values as a JAX array and a torch tensor."""
    rounded = a.astype(ml_dtypes.bfloat16)
    return (jnp.asarray(rounded),
            torch.from_numpy(rounded.astype(np.float32)).to(BF))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _check(got: torch.Tensor, want) -> None:
    want = np.asarray(want, dtype=np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= REL * np.abs(want).max(), (err, np.abs(want).max())


def _inputs(cin: int, cout: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    style = (rng.random((2, cin)) + 0.5).astype(np.float32)
    demod = (rng.random((2, cout)) + 0.5).astype(np.float32)
    return x, w, bias, style, demod


@pytest.mark.parametrize("cin,cout", [(16, 16), (24, 8)])
def test_torch_k1_bf16_twin_matches_pallas_kernel(cin, cout):
    x, w, bias, style, demod = _inputs(cin, cout, seed=cin)
    xj, xt = _bf16(x)
    mod = _load("conv3x3_bench")
    with pltpu.force_tpu_interpret_mode():
        want = mod.conv3x3_mod_fused(xj, jnp.asarray(w), jnp.asarray(bias),
                                     jnp.asarray(style), jnp.asarray(demod), th=8)
    assert want.dtype == jnp.bfloat16
    got = k1.modconv3x3_plain(xt, _t(style), _t(w), _t(demod), bias=_t(bias), act=True)
    assert got.dtype == BF
    _check(got, want)


@pytest.mark.parametrize("cin,cout", [(16, 16), (13, 8), (9, 12)])
def test_torch_k2_bf16_twin_matches_pallas_kernel(cin, cout):
    """The twin rounds scale·w to bf16 (the scale first, as the JAX layer
    casts it); the Pallas kernel is handed w·scale and rounds it."""
    x, w, bias, _, _ = _inputs(cin, cout, seed=100 + cin)
    scale = np.float32(1.0 / np.sqrt(9 * cin))
    w = w * np.float32(np.sqrt(9 * cin))  # unit-scale weights, as the layer keeps them
    xj, xt = _bf16(x)
    mod = _load("conv3x3_bench")
    with pltpu.force_tpu_interpret_mode():
        want = mod.conv3x3_fused(xj, jnp.asarray(w * scale), jnp.asarray(bias), th=8)
    assert want.dtype == jnp.bfloat16
    got = k2.conv3x3_plain(xt, _t(w), float(scale), _t(bias), True)
    assert got.dtype == BF
    _check(got, want)


@pytest.mark.parametrize("out_dtype", [torch.float32, BF])
@pytest.mark.parametrize("with_demod", [True, False])
def test_torch_k3_bf16_twin_matches_pallas_kernel(out_dtype, with_demod):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 64, 40)).astype(np.float32)
    s = (rng.random((2, 40)) + 0.5).astype(np.float32)
    w = (rng.standard_normal((40, 3)) * 0.2).astype(np.float32)
    d = (rng.random((2, 3)) + 0.5).astype(np.float32) if with_demod else None
    xj, xt = _bf16(x)
    mod = _load("pallas_bench")
    with pltpu.force_tpu_interpret_mode():
        want = mod.modulated_conv1x1(xj, jnp.asarray(s), jnp.asarray(w),
                                     None if d is None else jnp.asarray(d), tile=32)
    assert want.dtype == jnp.bfloat16
    got = k3.modconv1x1_plain(xt, _t(s), _t(w), None if d is None else _t(d),
                              out_dtype=out_dtype)
    assert got.dtype == out_dtype
    _check(got, want)


def test_torch_bf16_twins_round_as_the_kernels():
    """One rounding of the fp32 result: the twin equals the fp32 arithmetic
    on the rounded operands, rounded once (K1: x·round(style) rounded,
    round(w); K3: no rounding of the fold)."""
    x, w, bias, style, demod = _inputs(16, 8, seed=3)
    _, xt = _bf16(x)
    xm = (xt.float() * _t(style).to(BF).float()[:, None, None, :]).to(BF).float()
    want = k1.modconv3x3_plain(xm, None, _t(w).to(BF).float(), _t(demod),
                               bias=_t(bias), act=True).to(BF)
    got = k1.modconv3x3_plain(xt, _t(style), _t(w), _t(demod), bias=_t(bias), act=True)
    assert torch.equal(got, want)
    x3, s3, w3 = xt.reshape(2, 64, 16), _t(style), _t(w[1, 1])
    want3 = torch.einsum("bpi,bi,io->bpo", x3.float(), s3, w3)
    assert torch.equal(k3.modconv1x1_plain(x3, s3, w3, out_dtype=torch.float32), want3)
    assert torch.equal(k3.modconv1x1_plain(x3, s3, w3), want3.to(BF))


def test_torch_cpu_wrappers_take_bf16_twins():
    x, w, bias, style, demod = _inputs(16, 16, seed=5)
    _, xt = _bf16(x)
    counters = [(k, k.launches, k.launches_bf16) for k in (k1, k2, k3)]
    noise = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 8, 8)).astype(np.float32))
    args = (xt, _t(style), _t(w), _t(demod), noise, torch.tensor([0.3]), _t(bias), True)
    assert torch.equal(k1.modconv3x3(*args), k1.modconv3x3_plain(*args))
    assert torch.equal(k2.conv3x3(xt, _t(w), 0.2, _t(bias), True),
                       k2.conv3x3_plain(xt, _t(w), 0.2, _t(bias), True))
    args3 = (xt.reshape(2, 64, 16), _t(style), _t(w[0, 0][:, :3]))
    for out_dtype in (None, torch.float32):
        got = k3.modconv1x1(*args3, out_dtype=out_dtype)
        assert got.dtype == (out_dtype or BF)
        assert torch.equal(got, k3.modconv1x1_plain(*args3, out_dtype=out_dtype))
    assert all((k.launches, k.launches_bf16) == (n, nb) for k, n, nb in counters)
    assert k1.prepare_weight(_t(w), dtype=BF) is None  # the twin needs no layout


@pytest.mark.parametrize("cin,cout", [(16, 32), (13, 70), (40, 8)])
def test_torch_bf16_prepared_layout(cin, cout):
    """The bf16 weight layout's twin holds round(scale·w) of every weight
    once, zeros in the padding, in the order the kernel's fragments read:
    K position 8·kh + j of a chunk holds channel 4·(j // 2) + 2·kh + j % 2."""
    rng = np.random.default_rng(cin * cout)
    w = torch.from_numpy(rng.standard_normal((3, 3, cin, cout)).astype(np.float32))
    flat = tc_prepared_plain(w, 0.5, dtype=BF)
    assert flat.dtype == BF
    bn = 32 if cout <= 32 else 64 if cout <= 64 else 128
    chunks, tiles = -(-cin // 16), -(-cout // bn)
    assert flat.numel() == tiles * chunks * 9 * bn * 16
    # [tile][chunk][tap][nb][kh][r][j]
    v = flat.reshape(tiles, chunks, 9, bn // 8, 2, 8, 8)
    for tap, ci, n in [(0, 0, 0), (4, cin - 1, cout - 1), (8, min(5, cin - 1), 1)]:
        chunk, c = divmod(ci, 16)
        q, rest = divmod(c, 4)
        kh, lo = divmod(rest, 2)
        tile, nn = divmod(n, bn)
        nb, r = divmod(nn, 8)
        got = v[tile, chunk, tap, nb, kh, r, 2 * q + lo]
        assert got == (w[tap // 3, tap % 3, ci, n] * 0.5).to(BF)
    want = torch.sort((w * 0.5).to(BF).float().flatten()).values
    nonzero = flat.float()[flat.float() != 0]
    assert torch.equal(torch.sort(nonzero).values, want[want != 0])

"""The bf16 forms of K1, K2 and K3: each plain bf16 twin against the TPU
kernel it stands for, run on bf16 inputs as tests/test_torch_kernels.py
runs the fp32 ones (the tools/ modules loaded by path, the Pallas kernels
under pltpu.force_tpu_interpret_mode()); K3 with fp32 and with bf16
output, K2 at a Cin that is not a multiple of 8 (which the card's wrapper
pads with zero channels); the CPU wrappers on bf16 tensors (the twins, no
launch counted); the bf16 core's weight layout and work decomposition
through their plain twins.

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
from where2edit_tpu_torch.kernels.common import plain_epilogue, tc_prepared_plain, upcast

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


def _core_plan(b: int, h: int, w: int, cin: int, cout: int, splits: int = 1,
               modulated: bool = False) -> dict:
    """How the bf16 core (``csrc/conv3x3_bf16.cuh``, ``make_plan``) cuts a
    call: with ``sums`` (Cin > 128: each pair of K steps summed in a fresh
    accumulator) a Cout tile of ``bn`` = 32, 64 or 128 channels and pixel
    tiles of at most 128 · 128 / bn pixels; without, ``bn`` up to 256 and
    512, 256, 256 (K1's, ``modulated``: 128) or 128 pixels at bn 32, 64, 128
    or 256. A tile holds ``ni`` images of ``th`` x ``tw`` pixels (``tw`` at
    most an eighth of them, ``th`` at most 254; several whole images only
    where one image is the tile, at most 8); K runs in ``steps`` = 9 taps x
    ``slices`` of ``kc`` input channels, split into ``splits`` ranges of
    ``steps_per_split`` steps."""
    sums = cin > 128
    bn = 32 if cout <= 32 else 64 if cout <= 64 else 128 if cout <= 128 or sums else 256
    mb = 128 // bn if sums or (modulated and bn == 128) else {32: 4, 64: 2, 128: 2, 256: 1}[bn]
    bm = 128 * mb
    tw = min(w, 16 * mb)
    th = min(h, bm // tw, 254)
    ni = max(1, min(8, bm // (h * w))) if (th == h and tw == w) else 1
    kc = 32 if cin <= 32 else 64
    slices = -(-cin // kc)
    steps = 9 * slices
    splits = max(1, splits)
    return {"tw": tw, "th": th, "ni": ni, "tiles_w": -(-w // tw), "tiles_h": -(-h // th),
            "m_tiles": -(-b // ni) * -(-h // th) * -(-w // tw), "kc": kc, "slices": slices,
            "steps": steps, "bn": bn, "n_tiles": -(-cout // bn), "splits": splits,
            "steps_per_split": -(-steps // splits), "sums": sums}


def _core_twin(x: torch.Tensor, wp: torch.Tensor, cin: int, cout: int,
               style: torch.Tensor | None = None, splits: int = 1,
               modulated: bool = False) -> torch.Tensor:
    """A twin of the bf16 core's work decomposition: the raw fp32 sums
    (B,H,W,Cout) of x (B,H,W,Cin) bf16 and the prepared weights ``wp``
    (``tc_prepared_plain(..., dtype=bf16)``), computed as the kernel cuts
    them. x·round(style) is rounded to bf16 (K1's modulation); each work
    unit (Cout tile fastest, then pixel tile, then K split) takes its TMA
    box, the halo'd patch of its tile with zeros outside the image and past
    B and Cin, and runs its K steps in order: per 64-channel slice (32 where
    Cin ≤ 32) the 9 taps, each the tap-shifted rows of the box times that
    (tap, slice)'s weight tile; with ``sums`` each pair of steps is summed
    apart and added to the unit's sum, else every step adds to it; the
    split ranges' sums are added in split order, as the reduce pass adds
    them. ``modulated``: K1's tiles."""
    b, h, w = x.shape[:3]
    p = _core_plan(b, h, w, cin, cout, splits, modulated)
    tw, th, ni, kc, bn = p["tw"], p["th"], p["ni"], p["kc"], p["bn"]
    xm = upcast(x)
    if style is not None:
        xm = (xm * style.to(torch.bfloat16).float()[:, None, None, :]).to(torch.bfloat16).float()
    bp, hp, wpad = -(-b // ni) * ni, p["tiles_h"] * th, p["tiles_w"] * tw
    # the input as the boxes see it: one zero row and column around the
    # image, zeros past the last tile, past B and past Cin
    xp = torch.zeros(bp, hp + 2, wpad + 2, p["slices"] * kc)
    xp[:b, 1:h + 1, 1:w + 1, :cin] = xm
    wt = wp.float().reshape(p["n_tiles"], p["slices"], 9, bn, kc)
    parts = torch.zeros(p["splits"], bp, hp, wpad, p["n_tiles"] * bn)
    for u in range(p["n_tiles"] * p["m_tiles"] * p["splits"]):
        nt, rest = u % p["n_tiles"], u // p["n_tiles"]
        mt, split = rest % p["m_tiles"], rest // p["m_tiles"]
        w0 = (mt % p["tiles_w"]) * tw
        h0 = ((mt // p["tiles_w"]) % p["tiles_h"]) * th
        b0 = (mt // (p["tiles_w"] * p["tiles_h"])) * ni
        box = xp[b0:b0 + ni, h0:h0 + th + 2, w0:w0 + tw + 2]
        total = torch.zeros(ni * th * tw, bn)
        kb = split * p["steps_per_split"]
        ke = min(p["steps"], kb + p["steps_per_split"])
        run = 2 if p["sums"] else ke - kb
        for k0 in range(kb, ke, run):
            pair = torch.zeros(ni * th * tw, bn)
            for k in range(k0, min(k0 + run, ke)):
                sl, tap = divmod(k, 9)
                ky, kx = divmod(tap, 3)
                a = box[:, ky:ky + th, kx:kx + tw, sl * kc:(sl + 1) * kc].reshape(-1, kc)
                pair = pair + a @ wt[nt, sl, tap].T
            total = total + pair
        parts[split, b0:b0 + ni, h0:h0 + th, w0:w0 + tw, nt * bn:(nt + 1) * bn] = \
            total.reshape(ni, th, tw, bn)
    y = parts[0]
    for s in range(1, p["splits"]):
        y = y + parts[s]
    return y[:b, :h, :w, :cout]


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


@pytest.mark.parametrize("cin,cout", [(16, 32), (13, 70), (40, 8), (24, 300), (130, 300)])
def test_torch_bf16_prepared_layout(cin, cout):
    """The bf16 weight layout's twin holds round(scale·w) of every weight
    once, zeros in the padding, in the order the bf16 core's TMA loads
    read: [Cout tile][slice][tap][n][k], K-major, output channel tile·BN +
    n, input channel slice·KC + k (KC 32 where Cin ≤ 32, else 64; BN 32, 64,
    128, or 256 where Cin ≤ 128)."""
    rng = np.random.default_rng(cin * cout)
    w = torch.from_numpy(rng.standard_normal((3, 3, cin, cout)).astype(np.float32))
    flat = tc_prepared_plain(w, 0.5, dtype=BF)
    assert flat.dtype == BF
    bn = 32 if cout <= 32 else 64 if cout <= 64 else 128 if cout <= 128 or cin > 128 else 256
    kc = 32 if cin <= 32 else 64
    slices, tiles = -(-cin // kc), -(-cout // bn)
    assert flat.numel() == tiles * slices * 9 * bn * kc
    v = flat.reshape(tiles, slices, 9, bn, kc)
    for tap, ci, n in [(0, 0, 0), (4, cin - 1, cout - 1), (8, min(5, cin - 1), 1)]:
        sl, k = divmod(ci, kc)
        tile, nn = divmod(n, bn)
        assert v[tile, sl, tap, nn, k] == (w[tap // 3, tap % 3, ci, n] * 0.5).to(BF)
    want = torch.sort((w * 0.5).to(BF).float().flatten()).values
    nonzero = flat.float()[flat.float() != 0]
    assert torch.equal(torch.sort(nonzero).values, want[want != 0])


@pytest.mark.parametrize("b,h,w,cin,cout,styled,splits", [
    (3, 5, 7, 13, 8, True, 1),
    (3, 5, 7, 70, 70, True, 3),
    (3, 5, 7, 513, 513, True, 4),
    (3, 5, 7, 513, 8, False, 1),
    (3, 5, 7, 13, 513, False, 2),
    (3, 5, 7, 70, 70, False, 5),
    (2, 20, 33, 40, 36, True, 2),
    (2, 20, 33, 96, 100, True, 1),
    (2, 20, 33, 96, 100, False, 2),
    (2, 9, 40, 200, 130, True, 3),
    (1, 300, 1, 32, 32, True, 1),
])
def test_torch_bf16_core_decomposition_twin(b, h, w, cin, cout, styled, splits):
    """The twin of the bf16 core's work decomposition (per-unit TMA boxes of
    the halo'd patch with zeros outside the image and past B and Cin,
    64- or 32-channel slices, the 9 taps of a slice in order, pairs of
    steps summed apart where Cin > 128, split ranges added in order, on the
    prepared layout) against the plain versions on
    the same rounded operands, in fp32: max |Δ| ≤ 1e-5 · max |plain| (the
    same products summed in another order). Ragged shapes: several whole
    images per tile (5x7: 3 a tile), a partial last tile (20x33), a column
    taller than a box may be (300x1: tiles of 254 rows), Cin and
    Cout off every tile size; K1 with its epilogue, K2 without style."""
    rng = np.random.default_rng(b * h * w + cin + cout)
    x = torch.from_numpy(rng.standard_normal((b, h, w, cin)).astype(np.float32)).to(BF)
    wt = _t(rng.standard_normal((3, 3, cin, cout)))
    scale = 1.0 / np.sqrt(9 * cin)
    style = _t(rng.random((b, cin)) + 0.5) if styled else None
    raw = _core_twin(x, tc_prepared_plain(wt, scale, dtype=BF), cin, cout, style, splits,
                     modulated=styled)
    xm = x.float() if style is None else \
        (x.float() * style.to(BF).float()[:, None, None, :]).to(BF).float()
    w_r = (wt * scale).to(BF).float()
    if styled:  # K1: demod, noise, bias and the activation after the sums
        demod = _t(rng.random((b, cout)) + 0.5)
        noise, nw, bias = _t(rng.standard_normal((b, h, w))), _t([0.3]), _t(rng.random(cout))
        got = plain_epilogue(raw * demod[:, None, None, :], noise, nw, bias, True)
        want = k1.modconv3x3_plain(xm, None, w_r, demod, noise, nw, bias, True)
    else:  # K2
        bias = _t(rng.random(cout))
        got = plain_epilogue(raw, None, None, bias, True)
        want = k2.conv3x3_plain(xm, w_r, 1.0, bias, True)
    assert got.shape == want.shape == (b, h, w, cout)
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err

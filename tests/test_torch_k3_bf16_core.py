"""The bf16 K3 core (``csrc/modconv1x1.cu``, ``w2e_modconv1x1_bf16``) on the
CPU: a plain emulation of its arithmetic held against the plain twin
``modconv1x1_plain`` and the TPU kernel it replaces (Pallas
``tools/pallas_bench.py::modulated_conv1x1`` in interpret mode, loaded by
path as tests/test_torch_kernels_bf16.py loads it), and the Python mirror
of its work plan (``tests/torch_parity.py::k3_bf16_plan``, which the card
test holds against the kernel's own ``w2e_modconv1x1_bf16_plan``).

The emulation, in the core's two forms. On the tensor cores (a bf16
output, or fp32 with Cout > 8): x's channels padded with zeros to the
core's K (slices of 32 channels where Cin rounded up to 8 is ≤ 32, else
64); the style·weight fold made in fp32 and split into two bf16 parts,
hi = round(s·w) and lo = round(s·w - hi); each 16-wide K step's products
summed in fp32 and added to each part's sum in the kernel's order; the
parts added as hi + lo. The FMA form (an fp32 output of
at most 8 channels, the ToRGBs'): the fp32 fold; per output, L lanes (32
where Cin ≥ 128, 16 where ≥ 64, else 8) each a chain of fmaf over its
8-channel units g, g + L, ...; the lanes added in the butterfly's tree.
Then the epilogue in fp32: demod, noise, bias, lrelu(0.2)·√2, the
residual.

Bars: the emulation against the twin ≤ 1e-5 of max |twin| before the
output's rounding (the fold's parts keep each product to 2^-16 of the
fp32 fold's; the sums run in another order); against the Pallas kernel
≤ 8e-3 of max |Pallas| (one bf16 step at the largest value: the Pallas
kernel rounds x·s to bf16 before its dot, the core does not).
"""

import importlib.util
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_parity import K3_BF16_MAX_SMEM, k3_bf16_plan

from where2edit_tpu_torch.kernels import modconv1x1 as k3
from where2edit_tpu_torch.kernels.common import plain_epilogue

BF = torch.bfloat16
SMS = 132  # the H100 SXM's SMs
TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "tools")


def _pallas_bench():
    spec = importlib.util.spec_from_file_location(
        "pallas_bench", os.path.join(TOOLS, "pallas_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fma_order(xf: torch.Tensor, fold: torch.Tensor) -> torch.Tensor:
    """The FMA form's sums: xf (B,P,Cx) and fold (B,Cx,Cout) fp32, Cx a
    multiple of 8; lane g of L chains fmaf over units g, g + L, ... (one
    rounding of each x·f + acc: the product is exact in float64), then the
    lanes add pairwise, g and g + L / 2 first."""
    cx = xf.shape[2]
    lanes = 32 if cx >= 128 else 16 if cx >= 64 else 8
    parts = []
    for g in range(lanes):
        acc = torch.zeros(xf.shape[0], xf.shape[1], fold.shape[2])
        for i in (i for q in range(g, cx // 8, lanes) for i in range(8 * q, 8 * q + 8)):
            acc = (xf[:, :, i, None].double() * fold[:, None, i].double() + acc.double()).float()
        parts.append(acc)
    while len(parts) > 1:
        half = len(parts) // 2
        parts = [parts[g] + parts[g + half] for g in range(half)]
    return parts[0]


def _core_emulation(x, style, w, demod=None, noise=None, noise_weight=None, bias=None,
                    act=False, residual=None, fma=False) -> torch.Tensor:
    """The core's result in fp32, before the output's rounding: x (B,P,Cin)
    bf16, the rest as ``modconv1x1_plain`` takes them; on the tensor cores
    with the fold in two bf16 parts, or in the FMA form where ``fma`` (an
    fp32 output of at most 8 channels)."""
    b, p, cin = x.shape
    cx = -(-cin // 8) * 8
    kc = 32 if cx <= 32 else 64
    k = -(-cx // kc) * kc
    xf = torch.zeros(b, p, k)
    xf[..., :cin] = x.float()
    rest = style[:, :, None] * w[None]                    # the fold (B, Cin, Cout), fp32
    if fma:
        fold = torch.zeros(b, k, w.shape[1])
        fold[:, :cin] = rest
        y = _fma_order(xf, fold)
        if demod is not None:
            y = y * demod[:, None, :]
        return plain_epilogue(y, noise, noise_weight, bias, act, residual)
    split = torch.zeros(2, b, k, w.shape[1])
    for i in range(2):                                    # hi, lo
        split[i, :, :cin] = rest.to(BF).float()
        rest = rest - split[i, :, :cin]
    sums = torch.zeros(2, b, p, w.shape[1])
    for k0 in range(0, k, 16):                            # one MMA per 16 channels
        sums = sums + xf[None, :, :, k0:k0 + 16] @ split[:, :, k0:k0 + 16]
    y = sums[0] + sums[1]                                 # hi + lo
    if demod is not None:
        y = y * demod[:, None, :]
    return plain_epilogue(y, noise, noise_weight, bias, act, residual)


def _inputs(b, p, cin, cout, seed, to_rgb):
    """A ToRGB's operands (bias and an fp32 residual) where ``to_rgb``, else
    a mapper conv's (demod, shared noise, bias, the activation); x bf16."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    x = t(b, p, cin).to(BF)
    style = t(b, cin, scale=1.0 / np.sqrt(cin))
    w = t(cin, cout)
    if to_rgb:
        return dict(x=x, style=style, w=w, bias=t(cout), residual=t(b, p, cout))
    demod = torch.from_numpy((rng.random((b, cout)) + 0.5).astype(np.float32))
    return dict(x=x, style=style, w=w, demod=demod, noise=t(1, p), noise_weight=t(1),
                bias=t(cout), act=True)


@pytest.mark.parametrize("cout", [1, 3, 32])
@pytest.mark.parametrize("cin", [32, 64, 128, 512, 576])
def test_torch_k3_bf16_core_emulation_matches_twin(cin, cout):
    args = _inputs(2, 77, cin, cout, seed=cin * cout, to_rgb=cout == 3)
    got = _core_emulation(**args, fma=cout == 3)  # fp32 ToRGB, bf16 mapper
    want = k3.modconv1x1_plain(**args, out_dtype=torch.float32)
    assert got.shape == want.shape == (2, 77, cout)
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


@pytest.mark.parametrize("cout", [1, 3, 32])
@pytest.mark.parametrize("cin", [32, 64, 128, 512, 576])
def test_torch_k3_bf16_core_emulation_matches_pallas_kernel(cin, cout):
    """The Pallas kernel's function (demod only, bf16 out) against the
    emulation rounded once to bf16."""
    rng = np.random.default_rng(7 * cin + cout)
    x = rng.standard_normal((2, 64, cin)).astype(np.float32).astype(ml_dtypes.bfloat16)
    s = (rng.random((2, cin)) + 0.5).astype(np.float32)
    w = (rng.standard_normal((cin, cout)) / np.sqrt(cin)).astype(np.float32)
    d = (rng.random((2, cout)) + 0.5).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = _pallas_bench().modulated_conv1x1(
            jnp.asarray(x), jnp.asarray(s), jnp.asarray(w), jnp.asarray(d), tile=32)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want, dtype=np.float32)
    got = _core_emulation(torch.from_numpy(x.astype(np.float32)).to(BF), torch.from_numpy(s),
                          torch.from_numpy(w), torch.from_numpy(d)).to(BF).float().numpy()
    err = np.abs(got - want).max()
    assert err <= 8e-3 * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("cin", [32, 128, 512])
def test_torch_k3_bf16_core_fp32_out_on_tensor_cores(cin):
    """An fp32 output of more than 8 channels (bias and an fp32 residual)
    sums on the tensor cores with the two-part fold, as a bf16 one does:
    within 1e-5 of max |twin| (the other tests' bar)."""
    args = _inputs(4, 256, cin, 32, seed=11 * cin, to_rgb=True)
    want = k3.modconv1x1_plain(**args, out_dtype=torch.float32)
    got = _core_emulation(**args)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("cin", [32, 64, 128, 512])
def test_torch_k3_bf16_core_fma_form(cin):
    """The FMA form (a ToRGB: fp32 out, Cout 3) is its twin to fp32
    rounding, and its tree of lanes is the butterfly's: with every lane's
    chain but one zero, the result is that chain exactly."""
    args = _inputs(2, 40, cin, 3, seed=13 * cin, to_rgb=True)
    want = k3.modconv1x1_plain(**args, out_dtype=torch.float32)
    got = _core_emulation(**args, fma=True)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    x = torch.zeros(2, 40, cin)
    x[..., 8:16] = args["x"][..., 8:16].float()  # unit 1: lane 1's alone
    fold = torch.randn(2, cin, 3)
    chain = torch.zeros(2, 40, 3)
    for i in range(8, 16):
        chain = (x[..., i, None].double() * fold[:, None, i].double() + chain.double()).float()
    assert torch.equal(_fma_order(x, fold), chain)


@pytest.mark.parametrize("cin", [7, 33, 40])
def test_torch_k3_bf16_core_zero_channels(cin):
    """A Cin that is not a multiple of 8 reaches the core padded with zero
    channels (the wrapper pads x; the fold is 0 past Cin): the same result
    as the unpadded twin."""
    args = _inputs(3, 50, cin, 5, seed=cin, to_rgb=False)  # bf16 out: two parts
    padded = torch.nn.functional.pad(args["x"], (0, -cin % 8))
    args_p = {**args, "x": padded,
              "style": torch.nn.functional.pad(args["style"], (0, -cin % 8)),
              "w": torch.nn.functional.pad(args["w"], (0, 0, 0, -cin % 8))}
    got = _core_emulation(**args_p)
    want = k3.modconv1x1_plain(**args, out_dtype=torch.float32)
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


def _block_runs(units: int, grid: int) -> list:
    """The kernel's split of the units into each block's contiguous run."""
    return [range(i * units // grid, (i + 1) * units // grid) for i in range(grid)]


@pytest.mark.parametrize("p", [16, 64, 77, 300])
@pytest.mark.parametrize("b,cin,cout,out_size,res_size", [
    (2, 40, 3, 4, 4),      # a ToRGB: fp32 out and residual
    (8, 512, 32, 2, 0),    # a mapper conv: bf16 out, no residual
    (3, 576, 1, 2, 2),     # attention_last with a bf16 residual
    (1, 33, 5, 2, 2),      # ragged channels
    (2, 576, 3, 4, 4),     # the FMA form: nine slices, all staged at once
])
def test_torch_k3_bf16_plan_mirror(p, b, cin, cout, out_size, res_size):
    """The work plan: units of one sample x one tile, tiles never crossing
    a sample, every pixel in exactly one unit (the tail's rows where P is
    not a whole number of tiles), the blocks' contiguous runs covering
    every unit; the ring and the folds within the card's shared memory;
    per unit, its residual by one bulk copy or value by value, its output in
    16-byte stores or value by value, by the alignment of its first value
    and (the residual) its length."""
    plan = k3_bf16_plan(b, p, cin, cout, out_size, res_size, SMS)
    tile = plan["tile"]
    assert tile == 64  # P <= 64, or too few 128-pixel units to fill the SMs
    assert plan["tiles"] == -(-p // tile) and plan["units"] == b * plan["tiles"]
    assert plan["grid"] == min(plan["units"], SMS)
    runs = _block_runs(plan["units"], plan["grid"])
    assert [u for r in runs for u in r] == list(range(plan["units"])) and all(runs)
    covered = np.zeros((b, p), dtype=int)
    for u in range(plan["units"]):
        s, t = divmod(u, plan["tiles"])
        rows = min(tile, p - t * tile)
        covered[s, t * tile:t * tile + rows] += 1
        first, n = (s * p + t * tile) * cout, rows * cout
        res = res_size > 0 and (first * res_size) % 16 == 0 and (n * res_size) % 16 == 0
        out = (first * out_size) % 16 == 0
        assert plan["unit_flags"][u] == int(res) | int(out) << 1, u
    assert (covered == 1).all()
    assert plan["kc"] == (32 if -(-cin // 8) * 8 <= 32 else 64)
    assert plan["slices"] * plan["kc"] >= cin > (plan["slices"] - 1) * plan["kc"]
    assert plan["nc"] == (8 if cout <= 8 else 32)
    fma = out_size == 4 and cout <= 8
    assert 2 <= plan["stages"] <= max(8, plan["slices"]) and plan["fold_slots"] in (1, 2)
    assert not fma or plan["stages"] >= plan["slices"]
    assert plan["ring_off"] == plan["fold_slots"] * plan["fold_bytes"]
    assert plan["stage_bytes"] >= plan["x_bytes"] + tile * cout * res_size
    assert plan["smem"] <= K3_BF16_MAX_SMEM


def test_torch_k3_bf16_plan_tails_and_tiles():
    """Which units move how, by hand: P = 77 in 64-pixel tiles (a 13-row
    tail), and P = 300 in 128-pixel tiles at a batch that fills the card
    (a 44-row tail); 256-pixel tiles at the 1024² ToRGB; 128 at 512²."""
    flags = k3_bf16_plan(2, 77, 40, 3, 4, 4, SMS)["unit_flags"]
    # sample 0: rows 0-63 (both aligned), 64-76 (12-byte rows: 156 bytes of
    # residual, no bulk copy); sample 1 starts at value 231 (924 bytes: not
    # 16-byte aligned), then 64 rows on (value 423: 1692 bytes, neither)
    assert flags == [3, 2, 0, 0]
    plan = k3_bf16_plan(200, 300, 64, 3, 2, 2, SMS)
    assert (plan["tile"], plan["tiles"]) == (128, 3)
    # bf16 values, 1800 bytes a sample: unit 2 of sample 0 starts at value
    # 768 (1536 bytes) and holds 44 rows (264 bytes: no bulk copy); sample
    # 1's units start 1800, 2568 and 3336 bytes in (none 16-byte aligned)
    assert plan["unit_flags"][:6] == [3, 3, 2, 0, 0, 0]
    assert k3_bf16_plan(8, 1 << 20, 32, 3, 4, 4, SMS)["tile"] == 256
    assert k3_bf16_plan(8, 1 << 18, 64, 3, 4, 4, SMS)["tile"] == 128
    assert k3_bf16_plan(8, 256, 512, 32, 2, 0, SMS)["tile"] == 64
    fma = k3_bf16_plan(8, 4096, 512, 3, 4, 4, SMS)  # the FMA form over Cin 128
    assert fma["tile"] == 64 and fma["stages"] >= fma["slices"] == 8


@pytest.mark.parametrize("b,p,cin,cout", [(1, 16, 8, 33), (1, 16, 4096, 32), (0, 16, 8, 3)])
def test_torch_k3_bf16_plan_refuses(b, p, cin, cout):
    """Cout over 32, a fold over the shared memory, or an empty batch: the
    core does not take the shape (the wrapper raises)."""
    assert k3_bf16_plan(b, p, cin, cout, 2, 0, SMS) is None

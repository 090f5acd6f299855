"""Why K1 and K2 (``csrc/conv3x3_tc.cuh``) take each fp32 product as three
TF32 products ("3xTF32") on the tensor cores, checked on the CPU, and the
layout their weight preparation writes.

The tensor cores read fp32 operands as TF32 (10 explicit mantissa bits). The
kernel splits each operand v into big = tf32(v), rounded to nearest with
ties away from zero as ``cvt.rna.tf32.f32`` does, and small = tf32(v - big),
and sums a_small·b_big + a_big·b_big + a_big·b_small into an fp32
accumulator. Each of those products is exact in fp32 (11 × 11 significant
bits), so plain fp32 convolutions of the split operands reproduce what the
tensor cores compute, up to the order of the fp32 sums. One 3x3 conv at
K = 9·512, the discriminator's and the generator's widest, against float64:
3xTF32 within 1e-5 of the output's largest magnitude, one TF32 product
(1xTF32) beyond 1e-4, which is why the split is needed for the port's fp32
policy (phase 3 of ``chip_smoke.py`` holds K1 and K2 to 1e-4). K1 multiplies
the input by its style before the split, and demodulates after the sum.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from where2edit_tpu_torch.kernels.common import tc_prepared_plain, tf32_rna


def split(t: torch.Tensor):
    big = tf32_rna(t)
    return big, tf32_rna(t - big)


def conv(x, w):
    """x (B,H,W,Cin), w (3,3,Cin,Cout), NHWC, stride 1, pad 1."""
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                    padding=1).permute(0, 2, 3, 1)


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 8, 8, 512)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 512, 16)).astype(np.float32))
    return x, w, conv(x.double(), w.double())


def _rel(got, ref):
    return float((got.double() - ref).abs().max() / ref.abs().max())


def test_torch_tf32_rounding_matches_cvt_rna():
    one = 1.0 + 2.0 ** -10  # the next TF32 value above 1
    vals = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, one + 2.0 ** -11,
                         -(1.0 + 2.0 ** -11), 3.0 * 2.0 ** -20, 0.0],
                        dtype=torch.float32)
    want = torch.tensor([1.0, one, 1.0, one + 2.0 ** -10, -one, 3.0 * 2.0 ** -20, 0.0],
                        dtype=torch.float32)
    assert torch.equal(tf32_rna(vals), want)
    big, small = split(torch.randn(1000, generator=torch.Generator().manual_seed(1)))
    assert not (big.view(torch.int32) & 0x1FFF).any()  # 10 mantissa bits
    assert not (small.view(torch.int32) & 0x1FFF).any()


def test_torch_tf32_split_keeps_fp32_accuracy(operands):
    x, w, ref = operands
    (xb, xs), (wb, ws) = split(x), split(w)
    # the kernel's order: small terms first, then the big product
    three = conv(xs, wb) + conv(xb, ws) + conv(xb, wb)
    one = conv(xb, wb)
    err3, err1 = _rel(three, ref), _rel(one, ref)
    assert err3 <= 1e-5, err3
    assert err1 > 1e-4, err1
    # and the split keeps the operand to ~2^-22 of its magnitude
    assert float(((xb + xs) - x).abs().max() / x.abs().max()) < 2.0 ** -21


def test_torch_tf32_split_modulated(operands):
    """K1's products: x·s in fp32, then split; w split; the three TF32
    products summed; demod applied to the sum. Splitting x first and then
    multiplying by s would leave parts the tensor cores cannot read whole."""
    x, w, _ = operands
    rng = np.random.default_rng(1)
    s = torch.from_numpy((rng.standard_normal(512) / np.sqrt(9 * 512))
                         .astype(np.float32))
    xs64 = x.double() * s.double()
    ref0 = conv(xs64, w.double())
    demod = torch.rsqrt((w.double() * s.double()[:, None]).square().sum((0, 1, 2))
                        + 1e-8).float()
    ref = ref0 * demod.double()
    (xb, xsm), (wb, ws) = split(x * s), split(w)
    three = (conv(xsm, wb) + conv(xb, ws) + conv(xb, wb)) * demod
    one = conv(xb, wb) * demod
    err3, err1 = _rel(three, ref), _rel(one, ref)
    assert err3 <= 1e-5, err3
    assert err1 > 1e-4, err1
    late_big, late_small = (t * s for t in split(x))
    assert (late_big.view(torch.int32) & 0x1FFF).any()
    assert (late_small.view(torch.int32) & 0x1FFF).any()


@pytest.mark.parametrize("cin,cout,scale", [(13, 7, 1.0), (20, 40, 0.3),
                                            (16, 130, 1.0 / 12.0), (513, 512, 1.0)])
def test_torch_tc_prepared_layout(cin, cout, scale):
    """The plain twin of the kernels' weight preparation, read back with the
    index formula of ``conv3x3_tc_prep``: big + small gives w·scale to
    2^-21 of each value, both parts are TF32, and the padding past Cin and
    Cout is zero."""
    g = torch.Generator().manual_seed(cin + cout)
    w = torch.randn(3, 3, cin, cout, generator=g)
    flat = tc_prepared_plain(w, scale)
    bn = 32 if cout <= 32 else 64 if cout <= 64 else 128
    chunks, tiles = -(-cin // 8), -(-cout // bn)
    assert flat.shape == (tiles * chunks * 9 * 2 * bn * 8,)
    assert not (flat.view(torch.int32) & 0x1FFF).any()
    tap, ci, n = torch.meshgrid(torch.arange(9), torch.arange(chunks * 8),
                                torch.arange(tiles * bn), indexing="ij")
    nt, nb, r = n // bn, (n % bn) // 8, n % 8
    chunk, q, kh = ci // 8, (ci % 8) // 2, ci % 2
    base = ((nt * chunks + chunk) * 9 + tap) * 2 * bn * 8
    within = ((nb * 2 + kh) * 8 + r) * 4 + q
    big, small = flat[base + within], flat[base + bn * 8 + within]
    v = (w * scale).reshape(9, cin, cout)
    assert torch.equal(big[:, :cin, :cout], tf32_rna(v))
    err = (big[:, :cin, :cout] + small[:, :cin, :cout] - v).abs()
    assert bool((err <= 2.0 ** -21 * v.abs()).all())
    pad = torch.ones_like(big, dtype=torch.bool)
    pad[:, :cin, :cout] = False
    assert not big[pad].any() and not small[pad].any()

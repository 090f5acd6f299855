"""Why K2 (``csrc/conv3x3_tc.cuh``) takes each fp32 product as three TF32
products ("3xTF32") on the tensor cores, checked on the CPU.

The tensor cores read fp32 operands as TF32 (10 explicit mantissa bits). The
kernel splits each operand v into big = tf32(v), rounded to nearest with
ties away from zero as ``cvt.rna.tf32.f32`` does, and small = tf32(v - big),
and sums a_small·b_big + a_big·b_big + a_big·b_small into an fp32
accumulator. Each of those products is exact in fp32 (11 × 11 significant
bits), so plain fp32 convolutions of the split operands reproduce what the
tensor cores compute, up to the order of the fp32 sums. One 3x3 conv at
K = 9·512, the discriminator's widest, against float64: 3xTF32 within 1e-5
of the output's largest magnitude, one TF32 product (1xTF32) beyond 1e-4,
which is why the split is needed for the port's fp32 policy (phase 3 of
``chip_smoke.py`` holds K2 to 1e-4).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32, to nearest, ties away from zero: add half of the
    13 dropped bits to the magnitude, then clear them (the sign bit is apart,
    so this rounds the magnitude for either sign)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


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

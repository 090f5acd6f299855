"""The bf16 forms of K1, K2 and K3 on the card against their plain twins
(the bf16 operands upcast, the kernels' roundings, fp32 arithmetic, one
rounding of the result) at ragged shapes: Cin and Cout off the bf16 core's
32- and 64-channel slices and Cout tiles and off its 8-channel rows (which
the wrappers pad with zero channels), final_conv's 513 inputs and its input
gradient's 513 outputs, split and unsplit K ranges, several images per
tile, a column taller than a TMA box may be (300x1), weights resident in
shared memory or streamed, every optional
epilogue input on and off; two calls of one shape bitwise equal (split-K
shapes included); K3 with fp32 and with bf16 output (tiles at and under
the core's 64 rows, tail tiles, Cin 576 and the batch-8 ToRGB at 1024²,
two calls bitwise, its work plan against the Python mirror in
``tests/torch_parity.py``); K1's bf16 weight
preparation against its plain twin (bitwise) and a prepared call against
one that prepares (bitwise); the backward of the bf16 calls against
autograd through the twins. K5's bf16 form (``upfirdn2d``, bf16 in and out)
at the bf16 trainers' call sites (the up-conv's blur and the
discriminator's blurs at batch 8; the ToRGB skip stays fp32), at C not a
multiple of 8 and a non-separable FIR, two calls bitwise, one bf16 launch a
call, and its first and second derivatives; its twin is the plain version
on the upcast input, rounded once.

Marked ``cuda`` and skipped (by a fixture) without a CUDA device; on the
card run it with

    W2E_TEST_TPU=1 python -m pytest tests/test_torch_cuda_kernels_bf16.py -q

Bars: max |Δ| ≤ 8e-3 · max |twin| (one bf16 step at the largest value: the
two round fp32 sums taken in another order, so a value near a rounding
boundary may land one step apart); gradients rel L2 ≤ 1e-2 (the kernel's
bf16 input gradient against the twin's, both rounded once more in the
backward's bf16 dz).
"""

import pytest
import torch
from torch_parity import k3_bf16_plan

from where2edit_tpu_torch.kernels import conv3x3 as k2
from where2edit_tpu_torch.kernels import modconv1x1 as k3
from where2edit_tpu_torch.kernels import modconv3x3 as k1
from where2edit_tpu_torch.kernels import upfirdn2d as k5
from where2edit_tpu_torch.kernels.common import tc_prepared_plain
from where2edit_tpu_torch.ops.upfirdn2d import make_kernel, upfirdn2d, upfirdn2d_plain
from test_torch_cuda_kernels import NONSEP, k5_sites

pytestmark = pytest.mark.cuda

BF = torch.bfloat16
REL = 8e-3
GRAD_REL_L2 = 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _rel_l2(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


def _gen(dev, seed):
    g = torch.Generator(dev).manual_seed(seed)
    return lambda *s: torch.randn(*s, generator=g, device=dev)


@pytest.mark.parametrize("b,h,w,cin,cout,noise,bias,act", [
    (2, 5, 7, 16, 36, "batch", True, True),
    (1, 17, 33, 64, 64, "shared", True, True),
    (2, 6, 10, 100, 36, "batch", True, True),
    (2, 6, 9, 13, 7, "batch", True, True),
    (2, 9, 9, 8, 4, None, False, False),
    (1, 64, 64, 512, 512, "shared", True, True),
    (8, 8, 8, 512, 512, "batch", True, True),
    (8, 4, 4, 512, 512, "batch", True, True),
    (2, 4, 4, 513, 512, "batch", True, True),
    (8, 32, 32, 512, 512, "batch", True, True),
    (2, 20, 70, 32, 32, "batch", True, True),
    (1, 40, 66, 64, 64, "shared", True, True),
    (1, 66, 130, 128, 128, "batch", True, True),
    (1, 300, 1, 32, 32, "batch", True, True),
])
def test_torch_cuda_modconv3x3_bf16(dev, b, h, w, cin, cout, noise, bias, act):
    r = _gen(dev, cin + cout)
    n1, nb = k1.launches, k1.launches_bf16
    args = (r(b, h, w, cin).to(BF), r(b, cin) / (9 * cin) ** 0.5, r(3, 3, cin, cout),
            r(b, cout).abs() + 0.5,
            {"batch": r(b, h, w), "shared": r(1, h, w), None: None}[noise],
            r(1) if noise else None, r(cout) if bias else None, act)
    got = k1.modconv3x3(*args)
    torch.cuda.synchronize()
    assert got.dtype == BF
    assert (k1.launches, k1.launches_bf16) == (n1 + 1, nb + 1)
    assert _rel(got, k1.modconv3x3_plain(*args)) <= REL


@pytest.mark.parametrize("b,h,w,cin,cout,style", [
    (1, 4, 4, 512, 512, True), (2, 64, 64, 256, 256, True),
    (2, 6, 9, 13, 7, True), (2, 5, 7, 16, 36, False),
])
def test_torch_cuda_modconv3x3_bf16_prepared(dev, b, h, w, cin, cout, style):
    r = _gen(dev, 3 * cin + cout)
    wt = r(3, 3, cin, cout)
    wp = k1.prepare_weight(wt, dtype=BF)
    torch.cuda.synchronize()
    assert wp.dtype == BF
    assert torch.equal(wp.cpu(), tc_prepared_plain(wt, dtype=BF))
    args = (r(b, h, w, cin).to(BF), r(b, cin) if style else None, wt,
            r(b, cout).abs() + 0.5, r(b, h, w), r(1), r(cout), True)
    got = k1.modconv3x3(*args, prepared=wp)
    want = k1.modconv3x3(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert _rel(got, k1.modconv3x3_plain(*args)) <= REL


@pytest.mark.parametrize("b,h,w,cin,cout,bias,act", [
    (8, 4, 4, 513, 512, True, True),
    (2, 4, 4, 512, 513, False, False),
    (2, 9, 11, 5, 7, True, True),
    (3, 24, 40, 16, 96, True, True),
    (1, 40, 33, 200, 136, True, False),
    (8, 16, 16, 512, 512, True, True),
    (8, 64, 64, 256, 256, True, True),
    (1, 300, 1, 32, 32, True, True),
])
def test_torch_cuda_conv3x3_bf16(dev, b, h, w, cin, cout, bias, act):
    r = _gen(dev, cin + 2 * cout)
    n2, nb = k2.launches, k2.launches_bf16
    args = (r(b, h, w, cin).to(BF), r(3, 3, cin, cout), 1.0 / (9 * cin) ** 0.5,
            r(cout) if bias else None, act)
    got = k2.conv3x3(*args)
    torch.cuda.synchronize()
    assert got.dtype == BF
    assert (k2.launches, k2.launches_bf16) == (n2 + 1, nb + 1)
    assert _rel(got, k2.conv3x3_plain(*args)) <= REL


@pytest.mark.parametrize("cin,cout", [(13, 8), (70, 70), (513, 513), (13, 513),
                                       (513, 8), (70, 8)])
@pytest.mark.parametrize("styled", [True, False])
def test_torch_cuda_bf16_core_ragged(dev, cin, cout, styled):
    """K1-bf16 (with and without style) and K2-bf16 at batch 3 of 5x7
    images (3 whole images a tile, the last tile 2 of them over B): the
    shapes the CPU's decomposition twin runs."""
    r = _gen(dev, 11 * cin + cout + styled)
    b, h, w = 3, 5, 7
    args = (r(b, h, w, cin).to(BF), r(b, cin) / (9 * cin) ** 0.5 if styled else None,
            r(3, 3, cin, cout), r(b, cout).abs() + 0.5, r(b, h, w), r(1), r(cout), True)
    got = k1.modconv3x3(*args)
    args2 = (args[0], args[2], 1.0 / (9 * cin) ** 0.5, args[6], True)
    got2 = k2.conv3x3(*args2)
    torch.cuda.synchronize()
    assert _rel(got, k1.modconv3x3_plain(*args)) <= REL
    assert _rel(got2, k2.conv3x3_plain(*args2)) <= REL


@pytest.mark.parametrize("b,h,w,cin,cout", [
    (8, 4, 4, 512, 512), (8, 8, 8, 512, 512), (8, 16, 16, 512, 512), (2, 4, 4, 513, 512),
    (3, 5, 7, 513, 513), (8, 32, 32, 512, 512), (2, 64, 64, 64, 64), (2, 64, 64, 32, 32),
])
def test_torch_cuda_bf16_core_repeats_bitwise(dev, b, h, w, cin, cout):
    """Two calls of one shape give the same bits: the split-K sums are
    added in a fixed order, whatever order the blocks ran in."""
    r = _gen(dev, 13 * cin + cout)
    args = (r(b, h, w, cin).to(BF), r(b, cin) / (9 * cin) ** 0.5, r(3, 3, cin, cout),
            r(b, cout).abs() + 0.5, r(b, h, w), r(1), r(cout), True)
    args2 = (args[0], args[2], 1.0 / (9 * cin) ** 0.5, args[6], True)
    first, first2 = k1.modconv3x3(*args), k2.conv3x3(*args2)
    for _ in range(3):
        assert torch.equal(k1.modconv3x3(*args), first)
        assert torch.equal(k2.conv3x3(*args2), first2)
    assert _rel(first, k1.modconv3x3_plain(*args)) <= REL


@pytest.mark.parametrize("out_dtype", [torch.float32, BF])
@pytest.mark.parametrize("b,p,cin,cout,demod,noise,bias,act,res", [
    (2, 77, 40, 3, False, None, True, False, True),
    (2, 300, 33, 5, True, "batch", True, True, False),
    (1, 129, 576, 32, True, "shared", True, True, False),
    (2, 64, 7, 1, True, "shared", False, True, True),
    (1, 4096, 512, 3, False, None, True, False, True),
    (2, 256, 512, 32, True, "shared", True, True, False),
    (8, 16384, 64, 3, False, None, True, False, True),
    (8, 16, 512, 32, True, "batch", True, True, False),
    (1, 16, 576, 1, True, "shared", True, True, False),
    (3, 64, 128, 32, True, "batch", True, True, True),
    (8, 1048576, 32, 3, False, None, True, False, True),
])
def test_torch_cuda_modconv1x1_bf16(dev, out_dtype, b, p, cin, cout, demod, noise,
                                    bias, act, res):
    r = _gen(dev, cin * cout)
    n3, nb = k3.launches, k3.launches_bf16
    args = (r(b, p, cin).to(BF), r(b, cin) / cin ** 0.5, r(cin, cout),
            r(b, cout).abs() + 0.5 if demod else None,
            {"batch": r(b, p), "shared": r(1, p), None: None}[noise],
            r(1) if noise else None, r(cout) if bias else None, act,
            r(b, p, cout).to(out_dtype) if res else None)
    got = k3.modconv1x1(*args, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype
    assert (k3.launches, k3.launches_bf16) == (n3 + 1, nb + 1)
    assert _rel(got, k3.modconv1x1_plain(*args, out_dtype=out_dtype)) <= REL
    assert torch.equal(k3.modconv1x1(*args, out_dtype=out_dtype), got)
    size = torch.finfo(out_dtype).bits // 8
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert k3.plan_bf16(b, p, cin, cout, out_dtype, res, dev.index) == \
        k3_bf16_plan(b, p, cin, cout, size, size if res else 0, sms)


def _check_grads(fn, plain, tensors: dict, flags: dict, dy):
    def grads(f):
        leaves = {k: v.clone().requires_grad_(True) for k, v in tensors.items()}
        out = f(**leaves, **flags)
        return torch.autograd.grad(out, list(leaves.values()), dy.to(out.dtype))

    for name, got, want in zip(tensors, grads(fn), grads(plain)):
        assert got.dtype == tensors[name].dtype, name
        assert _rel_l2(got, want) <= GRAD_REL_L2, name


@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 6, 9, 13, 7), (8, 8, 8, 512, 512),
                                             (8, 64, 64, 256, 256), (2, 4, 4, 513, 512)])
def test_torch_cuda_modconv3x3_bf16_backward(dev, b, h, w, cin, cout):
    r = _gen(dev, 7 * cin + cout)
    nb = k1.launches_bf16
    tensors = {"x": r(b, h, w, cin).to(BF), "style": r(b, cin) / (9 * cin) ** 0.5,
               "w": r(3, 3, cin, cout), "demod": r(b, cout).abs() + 0.5,
               "noise": r(1, h, w), "noise_weight": r(1), "bias": r(cout)}
    _check_grads(k1.modconv3x3, k1.modconv3x3_plain, tensors, {"act": False},
                 r(b, h, w, cout))
    assert k1.launches_bf16 == nb + 2  # forward, then the input gradient


@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 4, 4, 513, 512), (2, 9, 11, 5, 7),
                                             (8, 16, 16, 512, 512), (8, 64, 64, 128, 256)])
def test_torch_cuda_conv3x3_bf16_backward(dev, b, h, w, cin, cout):
    r = _gen(dev, 5 * cin + cout)
    nb = k2.launches_bf16
    tensors = {"x": r(b, h, w, cin).to(BF), "w": r(3, 3, cin, cout), "bias": r(cout)}
    _check_grads(k2.conv3x3, k2.conv3x3_plain, tensors,
                 {"scale": 1.0 / (9 * cin) ** 0.5, "act": False}, r(b, h, w, cout))
    assert k2.launches_bf16 == nb + 2


def test_torch_cuda_wrappers_reject_mixed_dtypes(dev):
    x = torch.randn(1, 4, 4, 8, device=dev, dtype=BF)
    with pytest.raises(TypeError, match="float32"):
        k1.modconv3x3(x, torch.randn(1, 8, device=dev, dtype=BF),
                      torch.randn(3, 3, 8, 8, device=dev))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k2.conv3x3(x.half(), torch.randn(3, 3, 8, 8, device=dev), 1.0)
    with pytest.raises(TypeError):
        k3.modconv1x1(x.reshape(1, 16, 8), torch.randn(1, 8, device=dev),
                      torch.randn(8, 3, device=dev), out_dtype=torch.float16)


def _k5_twin(x, fir, up, down, pad):
    return upfirdn2d_plain(x.float(), fir, up, down, (*pad, *pad)).to(x.dtype)


K5_BF16_SITES = k5_sites(skip=False) + [
    ("ragged_c12", (2, 9, 7, 12), 1, 1, (2, 1), make_kernel([1, 3, 3, 1])),
    ("ragged_c5_up", (2, 9, 7, 5), 2, 1, (2, 1), make_kernel([1, 3, 3, 1]) * 4),
    ("nonseparable", (2, 9, 7, 16), 2, 1, (1, 2), NONSEP),
]


@pytest.mark.parametrize("name,shape,up,down,pad,fir", K5_BF16_SITES,
                         ids=[s[0] for s in K5_BF16_SITES])
def test_torch_cuda_upfirdn2d_bf16(dev, name, shape, up, down, pad, fir):
    x = _gen(dev, sum(shape))(*shape).to(BF)
    nb, n5 = k5.launches_bf16, k5.launches
    got = upfirdn2d(x, fir, up=up, down=down, pad=pad)
    again = upfirdn2d(x, fir, up=up, down=down, pad=pad)
    torch.cuda.synchronize()
    assert (k5.launches_bf16, k5.launches) == (nb + 2, n5 + 2)
    assert got.dtype == BF and torch.equal(got, again)
    assert _rel(got, _k5_twin(x, fir, up, down, pad)) <= REL


@pytest.mark.parametrize("shape,up,down,pad,fir", [
    ((8, 65, 65, 512), 1, 1, (1, 1), make_kernel([1, 3, 3, 1]) * 4),
    ((8, 128, 128, 256), 1, 1, (2, 2), make_kernel([1, 3, 3, 1])),
    ((2, 9, 7, 16), 2, 1, (1, 2), NONSEP),
])
def test_torch_cuda_upfirdn2d_bf16_backward(dev, shape, up, down, pad, fir):
    """bf16 dx and double backward against the twin's in fp32 (rel L2)."""
    r = _gen(dev, sum(shape) + 1)
    x = r(*shape).to(BF)
    dy = r(*_k5_twin(x, fir, up, down, pad).shape).to(BF)
    v = r(*shape).to(BF)

    def grads(fn, xs, dys, vs):
        xl, dyl = xs.clone().requires_grad_(True), dys.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad(fn(xl), xl, dyl, create_graph=True)
        (gdy,) = torch.autograd.grad(gx, dyl, vs)
        return gx, gdy

    nb = k5.launches_bf16
    got = grads(lambda t: upfirdn2d(t, fir, up=up, down=down, pad=pad), x, dy, v)
    torch.cuda.synchronize()
    assert k5.launches_bf16 == nb + 3
    want = grads(lambda t: upfirdn2d_plain(t, fir, up, down, (*pad, *pad)),
                 x.float(), dy.float(), v.float())
    for a, b in zip(got, want):
        assert a.dtype == BF and _rel_l2(a, b) <= GRAD_REL_L2

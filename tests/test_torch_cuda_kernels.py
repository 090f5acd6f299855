"""K1, K2 and K3 on the card against their plain versions at ragged shapes
the main paths do not reach (odd spatial sizes, Cout not a multiple of the
tile, Cin and Cout not multiples of 4 or of the staged chunk, batch 2 with a
broadcast noise, every optional epilogue input on and off), K1 and K2 both
with and without their K range split across blocks and at the widest K
(9·512, where a tensor-core sum carried through all of K would drift), K1
where a block holds several images (4² and 8²), K1 with its weights
prepared once against the call that prepares them (bitwise) and the
preparation against its plain twin (bitwise), K2 at odd counts of pixel and
Cout tiles, K3 at the few-block shapes of the edit path, and the backward
of the three autograd Functions against autograd through the plain
versions.
Marked ``cuda`` and skipped (by a fixture) without a CUDA device; on the
card run it with

    W2E_TEST_TPU=1 python -m pytest tests/test_torch_cuda_kernels.py -q

(``W2E_TEST_TPU=1`` keeps tests/conftest.py from importing JAX, which the
card's machine does not have). fp32, TF32 off; bar 1e-5 relative to the
output's largest magnitude, 1e-4 for the gradients (sums over every pixel
of the batch in another order); the backward cases run without the
activation, whose kink makes an elementwise bar ill-posed where the two
forwards round a pre-activation to opposite signs.
"""

import pytest
import torch

from where2edit_tpu_torch.kernels import conv3x3 as k2
from where2edit_tpu_torch.kernels import modconv1x1 as k3
from where2edit_tpu_torch.kernels import modconv3x3 as k1
from where2edit_tpu_torch.kernels.common import tc_prepared_plain

pytestmark = pytest.mark.cuda

REL = 1e-5
GRAD_REL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("b,h,w,cin,cout,demod,noise,bias,act", [
    (2, 5, 7, 12, 36, True, "batch", True, True),
    (1, 17, 33, 64, 64, True, "shared", True, True),
    (1, 4, 4, 512, 512, True, "shared", True, True),
    (2, 6, 10, 100, 36, True, "batch", True, True),
    (2, 9, 9, 8, 4, False, None, False, False),
    (1, 3, 40, 20, 128, True, "shared", False, True),
    (2, 6, 9, 13, 7, True, "batch", True, True),
    # K = 9·512 without split-K (64² at batch 1) and with it (8² at batch 8)
    (1, 64, 64, 512, 512, True, "shared", True, True),
    (8, 8, 8, 512, 512, True, "batch", True, True),
    # 4² at batch 8: a block holds 8 images, each with its own style and demod
    (8, 4, 4, 512, 512, True, "batch", True, True),
    # ragged Cin / Cout where a block holds several images
    (2, 4, 4, 13, 7, True, "batch", True, True),
    (2, 4, 4, 513, 512, True, "batch", True, True),
    # one noise shared by the batch
    (2, 16, 16, 64, 64, True, "shared", True, True),
])
def test_torch_cuda_modconv3x3(dev, b, h, w, cin, cout, demod, noise, bias, act):
    g = torch.Generator(dev).manual_seed(cin + cout)

    def r(*s):
        return torch.randn(*s, generator=g, device=dev)

    n1 = k1.launches
    args = (r(b, h, w, cin), r(b, cin), r(3, 3, cin, cout),
            r(b, cout).abs() + 0.5 if demod else None,
            {"batch": r(b, h, w), "shared": r(1, h, w), None: None}[noise],
            r(1) if noise else None, r(cout) if bias else None, act)
    got = k1.modconv3x3(*args)
    torch.cuda.synchronize()
    assert k1.launches == n1 + 1
    assert _rel(got, k1.modconv3x3_plain(*args)) <= REL


@pytest.mark.parametrize("b,p,cin,cout,demod,noise,bias,act,res", [
    (2, 77, 40, 3, False, None, True, False, True),
    (2, 300, 33, 5, True, "batch", True, True, False),
    (1, 129, 576, 32, True, "shared", True, True, False),
    (2, 64, 7, 1, True, "shared", False, True, True),
    # the edit path's few-block shapes: ToRGB 4², 16², 64² at Cin 512 with
    # the skip, the mapper's attention convs, attention_last
    (1, 16, 512, 3, False, None, True, False, True),
    (1, 256, 512, 3, False, None, True, False, True),
    (1, 4096, 512, 3, False, None, True, False, True),
    (1, 16, 512, 32, True, "shared", True, True, False),
    (2, 256, 512, 32, True, "shared", True, True, False),
    (1, 4096, 512, 32, True, "batch", True, True, False),
    (1, 4096, 576, 1, True, "shared", True, True, False),
    (2, 4096, 64, 32, True, "shared", True, True, False),
])
def test_torch_cuda_modconv1x1(dev, b, p, cin, cout, demod, noise, bias, act, res):
    g = torch.Generator(dev).manual_seed(cin * cout)

    def r(*s):
        return torch.randn(*s, generator=g, device=dev)

    n3 = k3.launches
    args = (r(b, p, cin), r(b, cin), r(cin, cout),
            r(b, cout).abs() + 0.5 if demod else None,
            {"batch": r(b, p), "shared": r(1, p), None: None}[noise],
            r(1) if noise else None, r(cout) if bias else None, act,
            r(b, p, cout) if res else None)
    got = k3.modconv1x1(*args)
    torch.cuda.synchronize()
    assert k3.launches == n3 + 1
    assert _rel(got, k3.modconv1x1_plain(*args)) <= REL


@pytest.mark.parametrize("b,h,w,cin,cout,bias,act", [
    (8, 4, 4, 513, 512, True, True),
    (2, 4, 4, 512, 513, False, False),
    (2, 9, 11, 5, 7, True, True),
    (1, 33, 20, 32, 32, True, False),
    (2, 16, 16, 64, 64, False, True),
    # odd pixel-tile and Cout-tile counts, a Cout tile mostly padding
    (3, 24, 40, 16, 96, True, True),
    (1, 40, 33, 200, 136, True, False),
    # K = 9·512 with and without split-K (16² and 8² split at batch 8)
    (2, 32, 32, 512, 512, True, True),
    (8, 16, 16, 512, 512, True, True),
    (8, 8, 8, 512, 512, True, True),
])
def test_torch_cuda_conv3x3(dev, b, h, w, cin, cout, bias, act):
    g = torch.Generator(dev).manual_seed(cin + 2 * cout)

    def r(*s):
        return torch.randn(*s, generator=g, device=dev)

    n2 = k2.launches
    args = (r(b, h, w, cin), r(3, 3, cin, cout), 1.0 / (9 * cin) ** 0.5,
            r(cout) if bias else None, act)
    got = k2.conv3x3(*args)
    torch.cuda.synchronize()
    assert k2.launches == n2 + 1
    assert _rel(got, k2.conv3x3_plain(*args)) <= REL


@pytest.mark.parametrize("b,h,w,cin,cout,style", [
    (1, 4, 4, 512, 512, True), (2, 8, 8, 512, 512, True), (1, 64, 64, 512, 512, True),
    (1, 128, 128, 256, 256, True), (1, 32, 48, 32, 32, True), (2, 6, 9, 13, 7, True),
    (2, 5, 7, 12, 36, False), (8, 4, 4, 64, 64, False),
])
def test_torch_cuda_modconv3x3_prepared(dev, b, h, w, cin, cout, style):
    """K1 with its weights prepared once (``prepared=``, as the edit path
    calls it) gives the same bits as the call that prepares them itself; the
    preparation equals its plain twin bit for bit; without a style the
    kernel reads a factor of 1."""
    g = torch.Generator(dev).manual_seed(3 * cin + cout)

    def r(*s):
        return torch.randn(*s, generator=g, device=dev)

    wt = r(3, 3, cin, cout)
    n1, np1 = k1.launches, k1.prepares
    wp = k1.prepare_weight(wt)
    torch.cuda.synchronize()
    assert k1.prepares == np1 + 1
    assert torch.equal(wp.cpu(), tc_prepared_plain(wt))
    args = (r(b, h, w, cin), r(b, cin) if style else None, wt,
            r(b, cout).abs() + 0.5, r(b, h, w), r(1), r(cout), True)
    got = k1.modconv3x3(*args, prepared=wp)
    want = k1.modconv3x3(*args)
    torch.cuda.synchronize()
    assert k1.launches == n1 + 2
    assert torch.equal(got, want)
    assert _rel(got, k1.modconv3x3_plain(*args)) <= REL


def _check_grads(fn, plain, tensors: dict, flags: dict, dy):
    def grads(f):
        leaves = {k: v.clone().requires_grad_(True) for k, v in tensors.items()}
        return torch.autograd.grad(f(**leaves, **flags), list(leaves.values()), dy)

    for name, got, want in zip(tensors, grads(fn), grads(plain)):
        assert _rel(got, want) <= GRAD_REL, name


@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 5, 7, 12, 36), (2, 4, 4, 64, 64),
                                             (2, 6, 9, 13, 7), (1, 64, 64, 512, 512),
                                             (8, 8, 8, 512, 512), (8, 4, 4, 512, 512),
                                             (2, 4, 4, 13, 7), (2, 4, 4, 513, 512)])
def test_torch_cuda_modconv3x3_backward(dev, b, h, w, cin, cout):
    g = torch.Generator(dev).manual_seed(7 * cin + cout)

    def r(*s):
        return torch.randn(*s, generator=g, device=dev)

    n1 = k1.launches
    tensors = {"x": r(b, h, w, cin), "style": r(b, cin), "w": r(3, 3, cin, cout),
               "demod": r(b, cout).abs() + 0.5, "noise": r(1, h, w),
               "noise_weight": r(1), "bias": r(cout)}
    _check_grads(k1.modconv3x3, k1.modconv3x3_plain, tensors, {"act": False},
                 r(b, h, w, cout))
    assert k1.launches == n1 + 2  # forward, then the input gradient


@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 4, 4, 513, 512), (2, 9, 11, 5, 7),
                                             (8, 4, 4, 513, 512), (4, 16, 16, 512, 512),
                                             (2, 24, 40, 64, 64)])
def test_torch_cuda_conv3x3_backward(dev, b, h, w, cin, cout):
    g = torch.Generator(dev).manual_seed(5 * cin + cout)

    def r(*s):
        return torch.randn(*s, generator=g, device=dev)

    n2 = k2.launches
    tensors = {"x": r(b, h, w, cin), "w": r(3, 3, cin, cout), "bias": r(cout)}
    _check_grads(k2.conv3x3, k2.conv3x3_plain, tensors,
                 {"scale": 1.0 / (9 * cin) ** 0.5, "act": False}, r(b, h, w, cout))
    assert k2.launches == n2 + 2


def test_torch_cuda_modconv1x1_backward(dev):
    g = torch.Generator(dev).manual_seed(11)

    def r(*s):
        return torch.randn(*s, generator=g, device=dev)

    tensors = {"x": r(2, 77, 40), "style": r(2, 40), "w": r(40, 3),
               "demod": r(2, 3).abs() + 0.5, "noise": r(2, 77),
               "noise_weight": r(1), "bias": r(3), "residual": r(2, 77, 3)}
    _check_grads(k3.modconv1x1, k3.modconv1x1_plain, tensors, {"act": False},
                 r(2, 77, 3))


def test_torch_cuda_wrappers_reject_bad_inputs(dev):
    x = torch.randn(1, 4, 4, 6, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        k1.modconv3x3(x.transpose(1, 2), torch.randn(1, 6, device=dev),
                      torch.randn(3, 3, 6, 8, device=dev))
    with pytest.raises(ValueError, match="shape"):
        k2.conv3x3(x, torch.randn(3, 3, 5, 8, device=dev), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        k3.modconv1x1(torch.randn(1, 8, 16, device=dev).transpose(1, 2),
                      torch.randn(1, 8, device=dev), torch.randn(8, 3, device=dev))
    with pytest.raises(ValueError, match="Cout"):
        k3.modconv1x1(torch.randn(1, 8, 4, device=dev), torch.randn(1, 4, device=dev),
                      torch.randn(4, 40, device=dev))

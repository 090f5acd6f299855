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
versions (also at the region-attention trainer's shapes: K3's weight
gradient at the mapper's attention convs, K1's style and demod gradients on
a frozen weight). K5 (``upfirdn2d``) against its plain version at every
call site of the 1024² models at batch 8 (the up-conv's blur at 8²-1024²
and its Cout, the ToRGB skip's 3 channels, the discriminator's two blurs),
on row bands as the SP path slices them (not contiguous across the batch),
at a C that is not a multiple of 4, a non-separable and a non-square FIR,
up and down together and a crop: one launch a call, two calls bitwise, the
dense form where the models' 4x4 blurs meet 16-byte vectors; and its first
and second derivatives (one launch each) against autograd through the plain
version. K4 (``upconv``) against its plain twin at the eight up-convs of
config-f (8² to 1024² out, Cin/Cout 512 to 64/32) at batch 8 and at a
ragged batch 3, at ragged Cin and Cout, without demod: one launch a call,
its prepared weights bitwise their plain twin and bitwise the call that
prepares its own; and its first and second derivatives against autograd
through the plain twin.
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
from where2edit_tpu_torch.kernels import upconv as k4
from where2edit_tpu_torch.kernels import upfirdn2d as k5
from where2edit_tpu_torch.kernels.common import tc_prepared_plain
from where2edit_tpu_torch.models.stylegan2 import channel_table
from where2edit_tpu_torch.ops.upfirdn2d import make_kernel, upfirdn2d, upfirdn2d_plain

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


# the region-attention mapper's 1x1 attention convs at 1024², blending at
# layer 8 (16²), batch 8: their weight is a trained parameter
@pytest.mark.parametrize("p,cin,cout", [(16, 512, 32), (64, 512, 32), (256, 512, 32),
                                        (256, 256, 32), (256, 128, 32), (256, 64, 32),
                                        (256, 32, 32), (256, 576, 1)])
def test_torch_cuda_modconv1x1_backward_weight_grad(dev, p, cin, cout):
    g = torch.Generator(dev).manual_seed(p + cin + cout)

    def r(*s):
        return torch.randn(*s, generator=g, device=dev)

    b = 8
    n3 = k3.launches
    tensors = {"x": r(b, p, cin), "style": r(b, cin) / cin ** 0.5, "w": r(cin, cout),
               "demod": r(b, cout).abs() + 0.5, "noise": r(b, p),
               "noise_weight": r(1), "bias": r(cout)}
    _check_grads(k3.modconv1x1, k3.modconv1x1_plain, tensors, {"act": False},
                 r(b, p, cout))
    assert k3.launches == n3 + 1  # the forward; the backward is plain


# the frozen generator's K1 at the layers whose styles the mapper edits
# (4²-16²), batch 8: style and demod gradients, no weight gradient
@pytest.mark.parametrize("h", [4, 8, 16])
def test_torch_cuda_modconv3x3_backward_frozen_weight(dev, h):
    g = torch.Generator(dev).manual_seed(h)

    def r(*s):
        return torch.randn(*s, generator=g, device=dev)

    b, c = 8, 512
    n1 = k1.launches
    tensors = {"x": r(b, h, h, c), "style": r(b, c) / (9 * c) ** 0.5,
               "demod": r(b, c).abs() + 0.5, "noise": r(b, h, h),
               "noise_weight": r(1), "bias": r(c)}
    _check_grads(k1.modconv3x3, k1.modconv3x3_plain, tensors,
                 {"w": r(3, 3, c, c), "act": False}, r(b, h, h, c))
    assert k1.launches == n1 + 2  # forward, then the input gradient


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


BLUR = make_kernel([1, 3, 3, 1])
NONSEP = torch.randn(3, 3, generator=torch.Generator().manual_seed(5)).numpy()
NONSQUARE = torch.randn(2, 4, generator=torch.Generator().manual_seed(6)).numpy()


def k5_sites(batch: int = 8, skip: bool = True) -> list:
    """(name, x shape, up, down, pad, FIR) of every upfirdn2d call of the
    1024² generator and discriminator (config-f channels) at ``batch``: the
    up-conv's blur at each output size and Cout, the ToRGB skip's Upsample
    (3 channels; ``skip``), the discriminator's blur before each ResBlock's
    3x3 and 1x1 stride-2 convs."""
    ch = channel_table(2)
    sites = [(f"g_blur_{r}", (batch, r + 1, r + 1, ch[r]), 1, 1, (1, 1), BLUR * 4)
             for r in (8, 16, 32, 64, 128, 256, 512, 1024)]
    if skip:
        sites += [(f"skip_{2 * r}", (batch, r, r, 3), 2, 1, (2, 1), BLUR * 4)
                  for r in (4, 8, 16, 32, 64, 128, 256, 512)]
    for r in (1024, 512, 256, 128, 64, 32, 16, 8):
        sites += [(f"d_blur_conv_{r}", (batch, r, r, ch[r]), 1, 1, (2, 2), BLUR),
                  (f"d_blur_skip_{r}", (batch, r, r, ch[r]), 1, 1, (1, 1), BLUR)]
    return sites


K5_SITES = k5_sites()


def _k5_pads(pad):
    return (pad[0], pad[1], pad[0], pad[1])


@pytest.mark.parametrize("name,shape,up,down,pad,fir", K5_SITES, ids=[s[0] for s in K5_SITES])
def test_torch_cuda_upfirdn2d_sites(dev, name, shape, up, down, pad, fir):
    g = torch.Generator(dev).manual_seed(sum(shape))
    x = torch.randn(*shape, generator=g, device=dev)
    n5 = k5.launches
    got = upfirdn2d(x, fir, up=up, down=down, pad=pad)
    again = upfirdn2d(x, fir, up=up, down=down, pad=pad)
    torch.cuda.synchronize()
    assert k5.launches == n5 + 2
    assert torch.equal(got, again)
    assert _rel(got, upfirdn2d_plain(x, fir, up, down, _k5_pads(pad))) <= REL
    plan = k5.plan(x, got.shape[1], got.shape[2], up, down, *fir.shape)
    assert plan["form"] == ("general" if shape[3] == 3 else "dense"), plan


@pytest.mark.parametrize("shape,up,down,pad,fir", [
    ((2, 9, 7, 5), 1, 1, (1, 1), BLUR),          # C not a multiple of 4
    ((2, 9, 7, 12), 1, 1, (2, 1), NONSEP),       # non-separable
    ((2, 9, 7, 8), 2, 1, (1, 2), NONSEP),
    ((1, 17, 13, 4), 1, 2, (1, 1), BLUR),        # Downsample
    ((2, 6, 5, 16), 2, 2, (1, 2), NONSQUARE),    # up and down together
    ((3, 11, 9, 8), 1, 1, (-1, 2), BLUR),        # a crop
    ((1, 70, 33, 64), 1, 1, (2, 2), BLUR),       # a run of rows past the last one
    ((8, 1, 1, 512), 2, 1, (2, 1), BLUR * 4),    # a 1x1 input, up 2
])
def test_torch_cuda_upfirdn2d_ragged(dev, shape, up, down, pad, fir):
    g = torch.Generator(dev).manual_seed(sum(shape) + up)
    x = torch.randn(*shape, generator=g, device=dev)
    n5 = k5.launches
    got = upfirdn2d(x, fir, up=up, down=down, pad=pad)
    torch.cuda.synchronize()
    assert k5.launches == n5 + 1
    assert _rel(got, upfirdn2d_plain(x, fir, up, down, _k5_pads(pad))) <= REL
    dense = up == down == 1 and fir.shape == (4, 4) and shape[3] % 4 == 0
    plan = k5.plan(x, got.shape[1], got.shape[2], up, down, *fir.shape)
    assert plan["form"] == ("dense" if dense else "general"), plan


@pytest.mark.parametrize("c,up,pad,fir", [(512, 1, (1, 1), BLUR * 4), (3, 2, (2, 1), BLUR * 4)])
def test_torch_cuda_upfirdn2d_row_band(dev, c, up, pad, fir):
    """A band of rows with its halo (``parallel/sp.py``): a slice along H of
    a batch-8 tensor, taken as it comes (no copy), as the whole band."""
    g = torch.Generator(dev).manual_seed(c)
    whole = torch.randn(8, 64, 64, c, generator=g, device=dev)
    band = whole[:, 15:33]
    assert not band.is_contiguous()
    got = upfirdn2d(band, fir, up=up, pad=pad)
    want = upfirdn2d(band.contiguous(), fir, up=up, pad=pad)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert _rel(got, upfirdn2d_plain(band, fir, up, 1, _k5_pads(pad))) <= REL


@pytest.mark.parametrize("shape,up,down,pad,fir", [
    ((8, 65, 65, 512), 1, 1, (1, 1), BLUR * 4),   # the up-conv's blur at 64²
    ((8, 128, 128, 3), 2, 1, (2, 1), BLUR * 4),   # the skip at 256²
    ((8, 128, 128, 256), 1, 1, (2, 2), BLUR),     # D's blurs at 128²
    ((8, 128, 128, 256), 1, 1, (1, 1), BLUR),
    ((2, 9, 7, 5), 1, 2, (1, 1), BLUR),
    ((2, 9, 7, 8), 2, 1, (1, 2), NONSEP),
    ((2, 6, 5, 16), 2, 2, (1, 2), NONSQUARE),
])
def test_torch_cuda_upfirdn2d_backward(dev, shape, up, down, pad, fir):
    """dx and the double backward's d(dx)/d(dy) against autograd through
    the plain version (its convs differentiated by ops.conv)."""
    g = torch.Generator(dev).manual_seed(sum(shape) + 2 * up + down)

    def r(*s):
        return torch.randn(*s, generator=g, device=dev)

    x = r(*shape)
    dy = r(*upfirdn2d_plain(x, fir, up, down, _k5_pads(pad)).shape)
    v = r(*shape)

    def grads(fn):
        xl, dyl = x.clone().requires_grad_(True), dy.clone().requires_grad_(True)
        y = fn(xl)
        (gx,) = torch.autograd.grad(y, xl, dyl, create_graph=True)
        (gdy,) = torch.autograd.grad(gx, dyl, v)
        return y, gx, gdy

    n5 = k5.launches
    got = grads(lambda t: upfirdn2d(t, fir, up=up, down=down, pad=pad))
    torch.cuda.synchronize()
    assert k5.launches == n5 + 3  # forward, backward, double backward
    want = grads(lambda t: upfirdn2d_plain(t, fir, up, down, _k5_pads(pad)))
    for a, b in zip(got, want):
        assert _rel(a, b) <= REL


# K4: 3xTF32 keeps fp32 accuracy; the sums over K (at most 4 taps · 512) run
# in another order than cuDNN's, each stage's in a fresh tensor-core sum
# (truncating) added in fp32: measured at most 9e-7 of the largest output
# on an H100, so a K1-level bar of 2e-6
K4_REL = 2e-6
K4_SITES = [(r // 2, channel_table(2)[r // 2], channel_table(2)[r])
            for r in (8, 16, 32, 64, 128, 256, 512, 1024)]


def _k4_args(dev, b, h, w, cin, cout, seed, demod=True):
    g = torch.Generator(dev).manual_seed(seed)

    def r(*s):
        return torch.randn(*s, generator=g, device=dev)

    return (r(b, h, w, cin), r(b, cin), r(cout, cin, 3, 3),
            r(b, cout).abs() + 0.5 if demod else None)


@pytest.mark.parametrize("b", [8, 3])
@pytest.mark.parametrize("h,cin,cout", K4_SITES, ids=[f"in{s[0]}" for s in K4_SITES])
def test_torch_cuda_upconv_sites(dev, b, h, cin, cout):
    x, style, wt, demod = _k4_args(dev, b, h, h, cin, cout, h + b)
    n4, np4 = k4.launches, k4.prepares
    wp = k4.prepare_weight(wt)
    got = k4.modupconv3x3(x, style, wt, demod, prepared=wp)
    torch.cuda.synchronize()
    assert (k4.launches, k4.prepares) == (n4 + 1, np4 + 1)
    assert got.shape == (b, 2 * h + 1, 2 * h + 1, cout)
    assert _rel(got, k4.upconv_plain(x, style, wt, demod)) <= K4_REL
    if b == 3:
        assert torch.equal(wp.cpu(), k4.prepared_plain(wt.cpu()))
        assert torch.equal(k4.modupconv3x3(x, style, wt, demod), got)


@pytest.mark.parametrize("b,h,w,cin,cout,demod", [
    (2, 1, 1, 3, 5, True), (3, 5, 7, 6, 10, True), (2, 5, 7, 12, 36, False),
    (3, 17, 9, 100, 70, True), (1, 33, 20, 513, 130, True), (2, 6, 6, 64, 33, False),
])
def test_torch_cuda_upconv_ragged(dev, b, h, w, cin, cout, demod):
    args = _k4_args(dev, b, h, w, cin, cout, cin * cout, demod)
    n4 = k4.launches
    got = k4.modupconv3x3(*args)
    torch.cuda.synchronize()
    assert k4.launches == n4 + 1
    assert _rel(got, k4.upconv_plain(*args)) <= K4_REL


@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 5, 7, 12, 36), (2, 8, 8, 512, 512),
                                             (2, 32, 32, 128, 64), (3, 9, 6, 13, 7)])
def test_torch_cuda_upconv_backward(dev, b, h, w, cin, cout):
    """First derivatives in x, style, w and demod, and second derivatives
    (the path penalty's: the input gradient differentiated in style, w and
    demod) against autograd through the plain twin."""
    x, style, wt, demod = _k4_args(dev, b, h, w, cin, cout, 3 * cin + cout)
    g = torch.Generator(dev).manual_seed(1)
    dy = torch.randn(b, 2 * h + 1, 2 * w + 1, cout, generator=g, device=dev)
    v = torch.randn(b, h, w, cin, generator=g, device=dev)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (x, style, wt, demod)]
        first = torch.autograd.grad((fn(*leaves) * dy).sum(), leaves, create_graph=True)
        second = torch.autograd.grad((first[0] * v).sum(), leaves[1:])
        return first + second

    n4 = k4.launches
    got = grads(k4.modupconv3x3)
    assert k4.launches == n4 + 1
    for name, a, want in zip(("dx", "ds", "dw", "dd", "ds2", "dw2", "dd2"), got,
                             grads(k4.upconv_plain)):
        assert _rel(a.detach(), want.detach()) <= GRAD_REL, name


def test_torch_cuda_upconv_rejects_bad_inputs(dev):
    x, style, wt, demod = _k4_args(dev, 1, 4, 4, 8, 8, 0)
    with pytest.raises(TypeError, match="float32"):
        k4.modupconv3x3(x.bfloat16(), style, wt, demod)
    with pytest.raises(ValueError, match="contiguous"):
        k4.modupconv3x3(x.transpose(1, 2), style, wt, demod)
    with pytest.raises(ValueError, match="shape"):
        k4.modupconv3x3(x, style, wt[:, :4], demod)

"""The autograd Functions of K1 (``modconv3x3``), K2 (``conv3x3``) and K3
(``modconv1x1``) on the CPU, where their forward is the plain version:
``gradcheck`` and ``gradgradcheck`` in float64 (R1 and the path length
penalty differentiate the backward again), with demod, noise (per sample
and broadcast), bias, the activation and the residual each on and off, and
ragged channel counts (Cin 5, as the final conv's 513); and the plain
convolution Functions of ``ops.conv``.
torch's default gradcheck tolerances (float64 finite differences).
"""

import pytest
import torch

from where2edit_tpu_torch.kernels import conv3x3 as k2
from where2edit_tpu_torch.kernels import modconv1x1 as k3
from where2edit_tpu_torch.kernels import modconv3x3 as k1


@pytest.fixture(autouse=True)
def _one_thread():
    """gradcheck runs thousands of tiny ops: one intra-op thread is fastest,
    and stays fast when several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _r(*shape, seed=0):
    g = torch.Generator().manual_seed(seed + sum(shape))
    return torch.randn(*shape, generator=g, dtype=torch.float64, requires_grad=True)


def _check(fn, args):
    assert torch.autograd.gradcheck(fn, args)
    assert torch.autograd.gradgradcheck(fn, args)


@pytest.mark.parametrize("demod,noise,bias,act", [
    (True, "batch", True, True),
    (True, "shared", False, False),
    (False, None, True, True),
    (False, "shared", False, False),
])
def test_torch_modconv3x3_gradgradcheck(demod, noise, bias, act):
    b, h, w, cin, cout = 2, 4, 5, 5, 3
    tensors = [_r(b, h, w, cin), _r(b, cin), _r(3, 3, cin, cout)]
    if demod:
        tensors.append(_r(b, cout))
    if noise:
        tensors += [_r(b if noise == "batch" else 1, h, w), _r(1)]
    if bias:
        tensors.append(_r(cout))

    def fn(x, s, wt, *rest):
        rest = list(rest)
        d = rest.pop(0) if demod else None
        nz, nw = (rest.pop(0), rest.pop(0)) if noise else (None, None)
        bi = rest.pop(0) if bias else None
        return k1.modconv3x3(x, s, wt, d, nz, nw, bi, act)

    _check(fn, tuple(tensors))


@pytest.mark.parametrize("cin,cout,bias,act", [
    (5, 3, True, True), (5, 3, False, False), (4, 6, True, False), (3, 4, False, True),
])
def test_torch_conv3x3_gradgradcheck(cin, cout, bias, act):
    tensors = (_r(2, 4, 5, cin), _r(3, 3, cin, cout), _r(cout))

    def fn(x, wt, bi):
        return k2.conv3x3(x, wt, 0.3, bi if bias else None, act)

    _check(fn, tensors)


@pytest.mark.parametrize("demod,noise,act,residual", [
    (True, True, True, False),
    (False, False, False, True),
    (True, False, True, True),
    (False, True, False, False),
])
def test_torch_modconv1x1_gradgradcheck(demod, noise, act, residual):
    b, p, cin, cout = 2, 7, 5, 3
    tensors = (_r(b, p, cin), _r(b, cin), _r(cin, cout), _r(b, cout),
               _r(1, p), _r(1), _r(cout), _r(b, p, cout))

    def fn(x, s, wt, d, nz, nw, bi, res):
        return k3.modconv1x1(x, s, wt, d if demod else None,
                             nz if noise else None, nw if noise else None, bi,
                             act, res if residual else None)

    _check(fn, tensors)


def test_torch_backward_dgrad_is_the_kernel():
    """The input gradient goes through the same Function: on the CPU each
    Function call runs the plain version once, so counting those calls
    counts what the card launches: one forward and one input gradient."""
    calls = {"k1": 0, "k2": 0}
    plain1, plain2 = k1.modconv3x3_plain, k2.conv3x3_plain

    def count1(*a, **k):
        calls["k1"] += 1
        return plain1(*a, **k)

    def count2(*a, **k):
        calls["k2"] += 1
        return plain2(*a, **k)

    k1.modconv3x3_plain, k2.conv3x3_plain = count1, count2
    try:
        x = _r(2, 4, 4, 4)
        y1 = k1.modconv3x3(x, _r(2, 4), _r(3, 3, 4, 4), act=True)
        y2 = k2.conv3x3(x, _r(3, 3, 4, 4), 0.5, act=True)
        (y1.sum() + y2.sum()).backward()
    finally:
        k1.modconv3x3_plain, k2.conv3x3_plain = plain1, plain2
    assert calls == {"k1": 2, "k2": 2}


def test_torch_conv3x3_cpu_takes_plain_path_and_refuses_other_devices():
    n2 = k2.launches
    x, w, b = _r(2, 5, 5, 3).detach(), _r(3, 3, 3, 4).detach(), _r(4).detach()
    assert torch.equal(k2.conv3x3(x, w, 0.2, b, True), k2.conv3x3_plain(x, w, 0.2, b, True))
    assert k2.launches == n2
    with pytest.raises(ValueError):
        k2.conv3x3(torch.empty(1, 4, 4, 4, device="meta"),
                   torch.empty(3, 3, 4, 4, device="meta"), 1.0)


@pytest.mark.parametrize("h,k,stride,padding,groups", [
    (8, 3, 2, 0, 1),    # the discriminator's downsampling conv (odd output padding)
    (7, 1, 2, 0, 1),    # its 1x1 skip
    (6, 3, 1, 1, 1),
    (7, 4, 2, 0, 2),    # a depthwise FIR blur
])
def test_torch_conv_functions_gradgradcheck(h, k, stride, padding, groups):
    """ops.conv: the same values as F.conv2d / F.conv_transpose2d, and
    gradients of gradients through the twin Functions."""
    import torch.nn.functional as F  # noqa: PLC0415

    from where2edit_tpu_torch.ops.conv import conv2d, conv_transpose2d  # noqa: PLC0415

    cin, cout = (3, 4) if groups == 1 else (1, 1)  # per group
    x, w = _r(2, cin * groups, h, h), _r(cout * groups, cin, k, k)
    assert torch.allclose(conv2d(x, w, stride, padding, groups),
                          F.conv2d(x, w, stride=stride, padding=padding, groups=groups))
    _check(lambda x, w: conv2d(x, w, stride, padding, groups), (x, w))
    xt, wt = _r(2, cout * groups, h, h), _r(cout * groups, cin, k, k)
    assert torch.allclose(conv_transpose2d(xt, wt, stride, padding, groups=groups),
                          F.conv_transpose2d(xt, wt, stride=stride, padding=padding,
                                             groups=groups))
    _check(lambda x, w: conv_transpose2d(x, w, stride, padding, groups=groups), (xt, wt))

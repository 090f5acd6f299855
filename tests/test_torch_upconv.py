"""K4's arithmetic on the CPU (``kernels/upconv.py``): the sub-pixel phase
split against the transposed conv it replaces, the prepared weights' plain
twin, the autograd Function's first and second derivatives, and the
upsampling ``ModulatedConv2d`` / ``StyledConv`` against the formula the port
ran before K4 (modulate, ``conv_transpose2d``, demod, blur, epilogue). The
kernel itself runs on the card only (``tests/test_torch_cuda_kernels.py``).

Tolerances: 1e-12 relative to the output's largest magnitude in float64
(the split sums the same products in another order); gradcheck's defaults
in float64; 1e-12 for the layers, also in float64.
"""

import pytest
import torch
import torch.nn.functional as F

from where2edit_tpu_torch.kernels import upconv as k4
from where2edit_tpu_torch.kernels.common import tc_prepared_plain
from where2edit_tpu_torch.nn import layers as tl
from where2edit_tpu_torch.ops.fused_act import fused_leaky_relu

REL64 = 1e-12


def _rel(got, want):
    got, want = got.detach(), want.detach()
    return float((got - want).abs().max() / want.abs().max())


def _inputs(b, h, w, cin, cout, seed, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)

    def r(*s):
        return torch.randn(*s, generator=g, dtype=dtype)

    return r(b, h, w, cin), r(b, cin), r(cout, cin, 3, 3), r(b, cout).abs() + 0.5


def _transposed(x, style, w, demod):
    """The formula K4 replaces, as the port wrote it (NCHW views)."""
    y = F.conv_transpose2d((x * style[:, None, None, :]).permute(0, 3, 1, 2),
                           w.transpose(0, 1), stride=2).permute(0, 2, 3, 1)
    return y if demod is None else y * demod[:, None, None, :]


def _phases_plain(x, style, w, demod=None):
    """The phase split evaluated in plain torch: each phase's taps
    (``k4.PHASE_TAPS``, weights from ``k4.phase_weights``) as matrix
    products over the shifted input, written to the interleaved positions."""
    b, h, wd, _ = x.shape
    xm = x * style[:, None, None, :]
    # a zero row and column on each side: x[-1] and x[H] (x[.., W]) are zero
    xp = F.pad(xm, (0, 0, 1, 1, 1, 1))
    wph = k4.phase_weights(w)
    out = x.new_zeros((b, 2 * h + 1, 2 * wd + 1, w.shape[0]))
    i = 0
    for p, taps in enumerate(k4.PHASE_TAPS):
        py, px = divmod(p, 2)
        hp, wp = h + 1 - py, wd + 1 - px
        acc = 0
        for ky, kx in taps:
            dy = ky // 2 if py == 0 else 0
            dx = kx // 2 if px == 0 else 0
            # x[m - dy, n - dx] for m < hp, n < wp: zero outside the input
            src = xp[:, 1 - dy:1 - dy + hp, 1 - dx:1 - dx + wp]
            acc = acc + src @ wph[i]
            i += 1
        out[:, py::2, px::2] = acc
    return out if demod is None else out * demod[:, None, None, :]


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("h,w", [(1, 1), (2, 2), (4, 4), (5, 7)])
def test_torch_upconv_phase_split(b, h, w):
    """The four parity phases (4, 2, 2 and 1 taps) evaluated as products
    over the shifted input give conv_transpose2d(x·s, wᵀ, 2)·demod."""
    x, style, wt, demod = _inputs(b, h, w, 5, 7, 10 * h + w + b)
    want = _transposed(x, style, wt, demod)
    got = _phases_plain(x, style, wt, demod)
    assert got.shape == (b, 2 * h + 1, 2 * w + 1, 7)
    assert _rel(got, want) <= REL64
    assert _rel(_phases_plain(x, style, wt), _transposed(x, style, wt, None)) <= REL64
    assert torch.equal(k4.upconv_plain(x, style, wt, demod), want)


def test_torch_upconv_phase_taps():
    """Nine taps in all, each (ky, kx) once, each phase's taps of its own
    parity; ``phase_weights`` lays them out tap by tap as (Cin, Cout)."""
    taps = [t for phase in k4.PHASE_TAPS for t in phase]
    assert sorted(taps) == [(ky, kx) for ky in range(3) for kx in range(3)]
    for p, phase in enumerate(k4.PHASE_TAPS):
        py, px = divmod(p, 2)
        assert all(ky % 2 == py and kx % 2 == px for ky, kx in phase)
    assert [len(phase) for phase in k4.PHASE_TAPS] == [4, 2, 2, 1]
    _, _, wt, _ = _inputs(1, 1, 1, 3, 5, 0)
    wph = k4.phase_weights(wt)
    assert wph.shape == (9, 3, 5) and wph.is_contiguous()
    for i, (ky, kx) in enumerate(taps):
        assert torch.equal(wph[i], wt[:, :, ky, kx].t())


@pytest.mark.parametrize("cin,cout", [(8, 32), (13, 7), (16, 70)])
def test_torch_upconv_prepared_plain(cin, cout):
    """The prepared buffer's plain twin is K1's layout over the phase-ordered
    weights; CPU tensors get no buffer."""
    _, _, wt, _ = _inputs(1, 1, 1, cin, cout, cin + cout, torch.float32)
    got = k4.prepared_plain(wt)
    assert torch.equal(got, tc_prepared_plain(k4.phase_weights(wt).reshape(3, 3, cin, cout)))
    bn = 32 if cout <= 32 else 64 if cout <= 64 else 128
    assert got.numel() == 2 * 9 * (-(-cin // 8) * 8) * (-(-cout // bn) * bn)
    assert k4.prepare_weight(wt) is None


@pytest.mark.parametrize("demod", [True, False])
def test_torch_upconv_gradcheck(demod):
    x, style, wt, d = _inputs(2, 3, 4, 5, 6, 3 + demod)
    args = [t.requires_grad_() for t in (x, style, wt)]
    if demod:
        args.append(d.requires_grad_())
    assert torch.autograd.gradcheck(k4.modupconv3x3, args)


@pytest.mark.parametrize("demod", [True, False])
def test_torch_upconv_gradgradcheck(demod):
    x, style, wt, d = _inputs(2, 2, 3, 4, 3, 5 + demod)
    args = [t.requires_grad_() for t in (x, style, wt)]
    if demod:
        args.append(d.requires_grad_())
    assert torch.autograd.gradgradcheck(k4.modupconv3x3, args)


def test_torch_upconv_rejects_other_devices():
    x, style, wt, d = _inputs(1, 2, 2, 4, 4, 1, torch.float32)
    with pytest.raises(ValueError, match="unsupported device"):
        k4.modupconv3x3(x.to("meta"), style.to("meta"), wt.to("meta"), d.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        k4.prepare_weight(wt.to("meta"))


def _old_upconv(m, x, style, noise=None, noise_weight=None, bias=None, act=False):
    """``ModulatedConv2d._conv``'s upsampling branch before K4."""
    s = m.modulation(style)
    w = m.weight[0]
    demod = torch.rsqrt(s.square() @ (m.scale * w).square().sum((2, 3)).t() + 1e-8)
    out = _transposed(x, m.scale * s, w, demod if m.demodulate else None)
    out = m.blur(out)
    if noise is not None:
        out = out + noise_weight * noise
    return fused_leaky_relu(out, bias) if act else out


def _grads(out, tensors, dy):
    return torch.autograd.grad(out, tensors, dy)


@pytest.mark.parametrize("demod", [True, False])
def test_torch_upconv_modulated_conv2d_matches_transposed(demod):
    """ModulatedConv2d(upsample=True) through K4's Function gives the old
    formula's output and gradients (input, style, weight, modulation)."""
    g = torch.Generator().manual_seed(11 + demod)
    m = tl.ModulatedConv2d(6, 10, 3, 8, demodulate=demod, upsample=True, rng=g).double()
    x = torch.randn(2, 5, 5, 6, generator=g, dtype=torch.float64, requires_grad=True)
    style = torch.randn(2, 8, generator=g, dtype=torch.float64, requires_grad=True)
    got, _ = m(x, style)
    want = _old_upconv(m, x, style)
    assert got.shape == (2, 10, 10, 10)
    assert _rel(got, want) <= REL64
    dy = torch.randn(got.shape, generator=g, dtype=torch.float64)
    tensors = [x, style, m.weight, m.modulation.weight, m.modulation.bias]
    for a, b in zip(_grads(got, tensors, dy), _grads(want, tensors, dy)):
        assert _rel(a, b) <= REL64


def test_torch_upconv_styled_conv_matches_transposed():
    """StyledConv(upsample=True): K4, the blur and the noise, bias and
    lrelu epilogue against the old formula, outputs and gradients."""
    g = torch.Generator().manual_seed(21)
    sc = tl.StyledConv(6, 10, 3, 8, upsample=True, rng=g).double()
    with torch.no_grad():
        sc.noise.weight.fill_(0.3)
        sc.activate.bias.normal_(generator=g)
    x = torch.randn(3, 4, 4, 6, generator=g, dtype=torch.float64, requires_grad=True)
    style = torch.randn(3, 8, generator=g, dtype=torch.float64, requires_grad=True)
    noise = torch.randn(3, 8, 8, 1, generator=g, dtype=torch.float64)
    got, _ = sc(x, style, noise=noise)
    want = _old_upconv(sc.conv, x, style, noise, sc.noise.weight, sc.activate.bias, True)
    assert _rel(got, want) <= REL64
    dy = torch.randn(got.shape, generator=g, dtype=torch.float64)
    tensors = [x, style, sc.conv.weight, sc.noise.weight, sc.activate.bias]
    for a, b in zip(_grads(got, tensors, dy), _grads(want, tensors, dy)):
        assert _rel(a, b) <= REL64


def test_torch_upconv_dtype_picks_the_path(monkeypatch):
    """An fp32 input goes through K4's Function; a bf16 one keeps the plain
    transposed conv (K4 has no bf16 form)."""
    calls = []
    real = k4.modupconv3x3

    def counted(*a, **kw):
        calls.append(a[0].dtype)
        return real(*a, **kw)

    monkeypatch.setattr(k4, "modupconv3x3", counted)
    g = torch.Generator().manual_seed(4)
    m = tl.ModulatedConv2d(4, 6, 3, 8, upsample=True, rng=g)
    x, style = torch.randn(1, 3, 3, 4, generator=g), torch.randn(1, 8, generator=g)
    with torch.no_grad():
        y32, _ = m(x, style)
        y16, _ = m(x.bfloat16(), style)
    assert calls == [torch.float32]
    assert y16.dtype == torch.bfloat16 and y32.shape == y16.shape
    assert _rel(y16.float(), y32) < 2e-2

"""The autograd Function of ``ops/upfirdn2d.py`` (``UpFirDn2d``, what
``upfirdn2d`` runs on a CUDA tensor, there with K5) on the CPU, where its
forward is the plain version: its backward is upfirdn2d again, with ``up``
and ``down`` swapped, the FIR flipped and the pads that crop the result to
the input's size, so these cases hold that formula.

- ``gradcheck`` and ``gradgradcheck`` in float64 (R1 and the path length
  penalty differentiate the backward again), torch's default tolerances;
- the gradient against autograd through the plain version (float64, where
  the two differ only in the order of their sums);
- the gradient against ``jax.grad`` of the JAX package's ``upfirdn2d``
  (float32 on both sides, 1e-5 as tests/test_torch_ops.py);

on every (up, down, pad, FIR) the models use: the up-conv's blur, the ToRGB
skip's ``Upsample``, the discriminator's two blurs, ``Downsample``; and on
ragged sizes (H != W, odd), a negative pad, a non-separable FIR, a
non-square one, and up and down together. The FIR of a layer is a buffer
read to the host once per version (``host_taps``): an in-place change is
seen.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from where2edit_tpu.ops import upfirdn2d as j_upfirdn2d
from where2edit_tpu_torch.ops.upfirdn2d import (
    UpFirDn2d,
    host_taps,
    make_kernel,
    upfirdn2d,
)

from torch_parity import close

BLUR = make_kernel([1, 3, 3, 1])
RNG_FIR = np.random.default_rng(7)
NONSEP = RNG_FIR.standard_normal((3, 3)).astype(np.float32)
NONSQUARE = RNG_FIR.standard_normal((2, 4)).astype(np.float32)

# name: (x shape (N, H, W, C), up, down, pad, FIR)
CASES = {
    "g_blur": ((2, 9, 9, 3), 1, 1, (1, 1), BLUR * 4),          # the up-conv's Blur
    "upsample": ((2, 5, 5, 3), 2, 1, (2, 1), BLUR * 4),        # ToRGB skip
    "d_blur_conv": ((2, 8, 8, 2), 1, 1, (2, 2), BLUR),         # before D's 3x3 stride 2
    "d_blur_skip": ((2, 8, 8, 2), 1, 1, (1, 1), BLUR),         # before D's 1x1 stride 2
    "downsample": ((2, 8, 8, 2), 1, 2, (1, 1), BLUR),
    "ragged": ((1, 7, 10, 3), 1, 1, (2, 1), BLUR),
    "ragged_up": ((2, 4, 7, 2), 2, 1, (2, 1), BLUR * 4),
    "negative_pad": ((1, 9, 8, 2), 1, 1, (-1, 2), BLUR),
    "nonseparable_up": ((1, 5, 6, 2), 2, 1, (1, 1), NONSEP),
    "nonsquare_down": ((1, 9, 7, 2), 1, 2, (1, 2), NONSQUARE),
    "up_and_down": ((1, 5, 6, 2), 2, 2, (1, 2), NONSEP),
}
IDS = list(CASES)


@pytest.fixture(autouse=True)
def _one_thread():
    """gradcheck runs thousands of tiny ops: one intra-op thread is fastest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(name, dtype=torch.float64, seed=0):
    shape, up, down, pad, fir = CASES[name]
    g = torch.Generator().manual_seed(seed + sum(shape))
    x = torch.randn(*shape, generator=g, dtype=dtype, requires_grad=True)
    return x, (lambda t: UpFirDn2d.apply(t, host_taps(fir), up, down, (*pad, *pad)))


@pytest.mark.parametrize("name", IDS)
def test_torch_upfirdn2d_gradcheck(name):
    x, fn = _case(name)
    assert torch.autograd.gradcheck(fn, (x,))


@pytest.mark.parametrize("name", IDS)
def test_torch_upfirdn2d_gradgradcheck(name):
    x, fn = _case(name)
    assert torch.autograd.gradgradcheck(fn, (x,))


@pytest.mark.parametrize("name", IDS)
def test_torch_upfirdn2d_grad_matches_plain_autograd(name):
    """The Function's backward against autograd through the plain version,
    ``upfirdn2d`` on a CPU tensor (stuffing, padding and the depthwise conv
    differentiated by torch)."""
    shape, up, down, pad, fir = CASES[name]
    x, fn = _case(name)
    y = fn(x)
    assert y.grad_fn.saved_tensors == ()  # the FIR is passed by value
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(1), dtype=y.dtype)
    (got,) = torch.autograd.grad(y, x, dy)
    want_y = upfirdn2d(x, np.asarray(fir, np.float64), up=up, down=down, pad=pad)
    (want,) = torch.autograd.grad(want_y, x, dy)
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", IDS)
def test_torch_upfirdn2d_grad_matches_jax(name):
    shape, up, down, pad, fir = CASES[name]
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    y_shape = j_upfirdn2d(jnp.asarray(x), fir, up=up, down=down, pad=pad).shape
    dy = rng.standard_normal(y_shape).astype(np.float32)

    def loss(a):
        return jnp.sum(j_upfirdn2d(a, fir, up=up, down=down, pad=pad) * dy)

    want = jax.grad(loss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = UpFirDn2d.apply(xt, host_taps(fir), up, down, (*pad, *pad))
    assert tuple(y.shape) == tuple(y_shape)
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(dy))
    close(got, want, 1e-5)


def test_torch_upfirdn2d_host_taps_follow_the_buffer():
    """A FIR tensor changed in place (a state dict loaded into a layer's
    buffer) is read again; an unchanged one is read once."""
    k = torch.from_numpy(make_kernel([1, 3, 3, 1]))
    first = host_taps(k)
    assert host_taps(k) is first
    np.testing.assert_array_equal(first, make_kernel([1, 3, 3, 1]))
    k.mul_(2.0)
    np.testing.assert_array_equal(host_taps(k), 2 * make_kernel([1, 3, 3, 1]))

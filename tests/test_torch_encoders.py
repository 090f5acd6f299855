"""The e4e / pSp encoders of the port against the JAX package's, on the
CPU: one reference-layout state dict drawn with numpy feeds the port's
``load_state_dict`` and, through ``where2edit_tpu/convert/irse.py``, the
JAX modules; inputs come from the same numpy seed.

Tolerance 1e-4 absolute and relative (fp32 both sides; a 50-block residual
trunk sums in another order). The converter round trip is bitwise.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from where2edit_tpu.convert.irse import (
    _body_params,
    _one_block,
    _style_block,
    convert_encoder_params,
)
from where2edit_tpu.models import encoders as jenc
from where2edit_tpu.models import irse as jirse
from where2edit_tpu_torch import convert
from where2edit_tpu_torch.models import encoders as tenc
from where2edit_tpu_torch.models import irse as tirse

from torch_parity import close, np_tree, t

TOL = 1e-4
SIZE = 32           # stylegan_size: 8 W+ rows (3 coarse, 4 middle, 1 fine)
ENCODERS = {"gradual": "GradualStyleEncoder", "e4e": "Encoder4Editing",
            "w": "BackboneEncoderUsingLastLayerIntoW"}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the tier-1 run puts six test processes on the
    machine's cores, where more threads per process spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def numpy_state_dict(module_fn, seed: int) -> dict:
    """The state-dict layout of ``module_fn()`` (built on the meta device)
    filled from numpy: convs N(0, 1/fan_in), linears N(0, 1) (scaled at run
    time), biases and running means N(0, 0.01), BatchNorm scales 1 + N(0,
    0.01), running variances U(0.5, 1.5), PReLU slopes 0.25 + N(0, 0.01)."""
    with torch.device("meta"):
        layout = module_fn().state_dict()
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in layout.items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(0)
            continue
        if k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif k.endswith(("running_mean", "bias")):
            a = 0.1 * rng.standard_normal(shape)
        elif len(shape) == 4:
            a = rng.standard_normal(shape) / math.sqrt(np.prod(shape[1:]))
        elif len(shape) == 2:
            a = rng.standard_normal(shape)
        elif k.endswith(("input_layer.2.weight", "res_layer.2.weight")):
            a = 0.25 + 0.1 * rng.standard_normal(shape)
        else:
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        sd[k] = t(a)
    return sd


def _loaded(module_fn, sd):
    with torch.device("meta"):
        module = module_fn()
    module.load_state_dict(sd, assign=True)
    return module.eval()


def _nchw(x):
    return t(x).permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


@pytest.mark.parametrize("in_c,depth,stride,use_se", [
    (16, 32, 2, True),    # a stage head: 1x1 conv + BN shortcut
    (32, 32, 1, True),    # a stage tail: identity shortcut
    (32, 32, 2, True),    # strided identity shortcut (MaxPool2d(1, 2))
    (16, 32, 2, False),   # IR without squeeze-excite
])
def test_torch_bottleneck_ir(in_c, depth, stride, use_se):
    def make():
        return tirse.BottleneckIR(in_c, depth, stride, use_se=use_se)

    sd = numpy_state_dict(make, seed=in_c + depth + stride)
    x = np.random.default_rng(1).standard_normal((2, 9, 9, in_c)).astype(np.float32)
    with torch.no_grad():
        got = _nhwc(_loaded(make, sd)(_nchw(x)))
    spec = jirse.BlockSpec(in_c, depth, stride)
    p, s = _one_block({f"body.0.{k}": v for k, v in sd.items()}, 0, spec,
                      "ir_se" if use_se else "ir")
    want = jirse.BottleneckIR(in_c, depth, stride, use_se=use_se).apply(
        {"params": p, "batch_stats": s}, jnp.asarray(x))
    assert got.shape == want.shape
    close(got, want, TOL)


def test_torch_irse_body_taps():
    """The 50-layer trunk and its FPN taps 6 / 20 / 23 (the JAX side scans
    each stage's tail)."""
    sd = numpy_state_dict(tirse.IRSEBody, seed=5)
    x = np.random.default_rng(2).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        got, got_taps = _loaded(tirse.IRSEBody, sd)(t(x), want_taps=True)
    p, s = _body_params(sd, 50, "ir_se")
    want, want_taps = jax.jit(lambda v, x: jirse.IRSEBody().apply(
        v, x, want_taps=True))({"params": p, "batch_stats": s}, jnp.asarray(x))
    close(got, want, TOL)
    assert sorted(got_taps) == sorted(want_taps) == [6, 20, 23]
    for i in got_taps:
        assert got_taps[i].shape == want_taps[i].shape
        close(got_taps[i], want_taps[i], TOL)


def test_torch_gradual_style_block():
    """Narrow widths: 16 -> 32, nominal spatial 8 (three stride-2 convs to
    1x1), then the EqualLinear."""
    def make():
        return tenc.GradualStyleBlock(16, 32, 8)

    sd = numpy_state_dict(make, seed=6)
    x = np.random.default_rng(3).standard_normal((2, 8, 8, 16)).astype(np.float32)
    with torch.no_grad():
        got = _loaded(make, sd)(_nchw(x))
    v = _style_block({f"blk.{k}": w for k, w in sd.items()}, "blk", 8)
    want = jenc.GradualStyleBlock(16, 32, 8).apply({"params": v}, jnp.asarray(x))
    assert tuple(got.shape) == (2, 32)
    close(got, want, TOL)


@pytest.fixture(scope="module")
def encoder_sds():
    """One reference-layout state dict per encoder kind, and the input:
    batch 2 at 64², where c3 is 4² (the style blocks' last convs run at
    1x1, as in JAX)."""
    sds = {kind: numpy_state_dict(
        lambda cls=getattr(tenc, name): cls(stylegan_size=SIZE), seed=10 + i)
        for i, (kind, name) in enumerate(ENCODERS.items())}
    x = np.random.default_rng(4).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    return sds, x


@pytest.mark.parametrize("kind,stage", [
    ("gradual", None), ("e4e", None), ("w", None),
    ("e4e", 2),   # progressive gating: rows 3.. stay at w0
])
def test_torch_encoders_wplus(encoder_sds, kind, stage):
    sds, x = encoder_sds
    name = ENCODERS[kind]
    kw = {} if stage is None else {"progressive_stage": stage}

    def make():
        return getattr(tenc, name)(stylegan_size=SIZE, **kw)

    with torch.no_grad():
        got = _loaded(make, sds[kind])(t(x))
    jmod = getattr(jenc, name)(stylegan_size=SIZE, **kw)
    variables = convert_encoder_params(sds[kind], stylegan_size=SIZE, kind=kind)
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    assert tuple(got.shape) == want.shape == (2, 8, 512)
    close(got, want, TOL)
    if stage is not None:
        assert torch.equal(got[:, stage + 1:], got[:, :1].expand(-1, 8 - stage - 1, -1))
        assert not torch.equal(got[:, stage], got[:, 0])


@pytest.mark.parametrize("kind,num_layers", [
    ("gradual", 50), ("e4e", 50), ("w", 50),
    ("w", 100),   # a trunk the JAX package keeps unrolled
])
def test_torch_encoder_state_dict_round_trip(encoder_sds, kind, num_layers):
    """reference state dict -> convert_encoder_params -> encoder_state_dict
    gives back every tensor bitwise (flax keeps no num_batches_tracked), and
    the result loads into the port's module."""
    name = ENCODERS[kind]

    def make():
        return getattr(tenc, name)(num_layers=num_layers, stylegan_size=SIZE)

    sd = (encoder_sds[0][kind] if num_layers == 50
          else numpy_state_dict(make, seed=20))
    variables = np_tree(convert_encoder_params(
        sd, stylegan_size=SIZE, num_layers=num_layers, kind=kind))
    back = convert.encoder_state_dict(variables, kind=kind, stylegan_size=SIZE,
                                      num_layers=num_layers)
    want = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        assert torch.equal(back[k], v), k
    with torch.device("meta"):
        module = make()
    module.to_empty(device="cpu")
    convert.load_converted(module, back)
    back.pop("input_layer.1.running_var")
    with pytest.raises(KeyError, match="running_var"):
        convert.load_converted(module, back)

"""The port's ArcFace ``Backbone`` and ``IDLoss`` against the JAX
package's, on the CPU: one seeded reference-layout IR-SE50 state dict
(randomised BatchNorm statistics, ``torch_parity.arcface_state``) loads
into the port as it is and into JAX through
``where2edit_tpu/convert/irse.py::convert_backbone_params``; inputs from
one numpy seed. Embeddings within 1e-4 of the largest magnitude (fp32
both sides, 24 residual blocks summed in another order; the embedding is
L2-normalised); the ID loss within 1e-4 absolute.
``convert.backbone_state_dict`` inverts the JAX converter bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from where2edit_tpu.convert.irse import convert_backbone_params
from where2edit_tpu.losses.id_loss import IDLoss as JIDLoss
from where2edit_tpu.models.irse import Backbone as JBackbone
from where2edit_tpu_torch import convert
from where2edit_tpu_torch.losses.id_loss import IDLoss
from where2edit_tpu_torch.models.irse import Backbone

from torch_parity import arcface_state, np_tree, t

TOL = 1e-4


@pytest.fixture(scope="module")
def nets():
    torch.set_num_threads(min(torch.get_num_threads(), 2))
    sd = arcface_state(seed=0)
    jnet = JBackbone(input_size=112, drop_ratio=0.6)
    jvars = jax.tree.map(jnp.asarray, convert_backbone_params(sd))
    tnet = Backbone.from_state_dict(sd, input_size=112, drop_ratio=0.6).eval()
    return sd, jnet, jvars, tnet


def _rel_close(got, want, tol: float):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def test_torch_arcface_backbone_matches_jax(nets):
    _, jnet, jvars, tnet = nets
    x = np.random.default_rng(1).uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32)
    want = jax.jit(jnet.apply)(jvars, jnp.asarray(x))
    with torch.no_grad():
        got = tnet(t(x))
    assert tuple(got.shape) == (2, 512)
    np.testing.assert_allclose(got.norm(dim=1).numpy(), 1.0, rtol=1e-6)
    _rel_close(got.numpy(), want, TOL)


@pytest.mark.parametrize("size", [64, 256])
def test_torch_id_loss_matches_jax(nets, size):
    """``extract_feats`` pools a non-256² input to 256², crops the face box,
    pools to 112²; the loss is mean(1 - cos) with the target detached."""
    _, jnet, jvars, tnet = nets
    rng = np.random.default_rng(size)
    y = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    y_hat = np.clip(y + 0.3 * rng.standard_normal(y.shape), -1, 1).astype(np.float32)
    jloss = JIDLoss(jnet, jvars)
    jfeats = jax.jit(jloss.apply_extract_feats)(jvars, jnp.asarray(y))
    jl, _ = jax.jit(jloss.apply)(jvars, jnp.asarray(y_hat), jnp.asarray(y))
    tloss = IDLoss(tnet)
    y_hat_t = t(y_hat).requires_grad_(True)
    y_t = t(y).requires_grad_(True)
    with torch.no_grad():
        _rel_close(tloss.extract_feats(t(y)).numpy(), jfeats, TOL)
    tl, sim = tloss(y_hat_t, y_t)
    assert sim == 0.0
    assert abs(float(tl.detach()) - float(jl)) <= TOL, (float(tl.detach()), float(jl))
    tl.backward()
    assert y_t.grad is None and float(y_hat_t.grad.abs().sum()) > 0


@pytest.mark.parametrize("affine", [True, False])
def test_torch_arcface_state_dict_round_trip(nets, affine):
    sd = {k: v for k, v in nets[0].items() if not k.endswith("num_batches_tracked")}
    if not affine:
        del sd["output_layer.4.weight"], sd["output_layer.4.bias"]
    back = convert.backbone_state_dict(np_tree(convert_backbone_params(sd, affine=affine)))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    net = Backbone.from_state_dict(back)
    assert (net.output_layer[4].weight is None) == (not affine)


def test_torch_arcface_input_size():
    with pytest.raises(ValueError, match="112 or 224"):
        Backbone(input_size=128)

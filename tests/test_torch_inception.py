"""The port's InceptionV3 against the JAX package's, on the CPU: one seeded
torchvision-layout state dict (randomised BatchNorm statistics,
``torch_parity.inception_state``) loads into the port as it is and into
JAX through ``where2edit_tpu/convert/inception.py``; the same numpy input
at 75², the smallest size the net takes. Features and logits within 1e-4
of the largest magnitude (fp32 both sides, ~90 convs summed in another
order). ``convert.inception_state_dict`` inverts the JAX converter
bitwise. ``cli/evaluate.py::load_fid_extract`` (a generator image →
[0, 1] → bilinear 299², no corner alignment → pool3) agrees with the net
on JAX's resize of the same image."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from where2edit_tpu.convert.inception import convert_inception_params
from where2edit_tpu.models.inception import InceptionV3 as JInception
from where2edit_tpu.ops.interpolate import interpolate_bilinear as j_bilinear
from where2edit_tpu_torch import convert
from where2edit_tpu_torch.cli import evaluate
from where2edit_tpu_torch.models.inception import InceptionV3

from torch_parity import inception_state, np_tree, t

TOL = 1e-4


@pytest.fixture(scope="module")
def state():
    torch.set_num_threads(min(torch.get_num_threads(), 2))
    return inception_state(seed=0)


def _rel_close(got, want, tol: float):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def test_torch_inception_matches_jax(state):
    x = np.random.default_rng(1).uniform(0, 1, (2, 75, 75, 3)).astype(np.float32)
    jvars = jax.tree.map(jnp.asarray, convert_inception_params(state))
    jf, jl = jax.jit(JInception().apply)(jvars, jnp.asarray(x))
    model = InceptionV3.from_state_dict(state).eval()
    with torch.no_grad():
        tf, tl = model(t(x))
    assert tuple(tf.shape) == (2, 2048) and tuple(tl.shape) == (2, 1008)
    assert float(tf.std()) > 1e-2  # the weights keep the features alive
    _rel_close(tf.numpy(), jf, TOL)
    _rel_close(tl.numpy(), jl, TOL)


def test_torch_inception_state_dict_round_trip(state):
    back = convert.inception_state_dict(np_tree(convert_inception_params(state)))
    want = {k: v for k, v in state.items() if not k.endswith("num_batches_tracked")}
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        assert torch.equal(back[k], v), k


def test_torch_inception_from_state_dict_checks_keys(state):
    """A torchvision checkpoint's ``AuxLogits.*`` head is dropped and
    missing ``num_batches_tracked`` counters allowed; a missing weight
    raises."""
    sd = {k: v for k, v in state.items() if not k.endswith("num_batches_tracked")}
    sd["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    model = InceptionV3.from_state_dict(sd)
    assert torch.equal(model.fc.weight, state["fc.weight"])
    del sd["Mixed_6b.branch7x7_2.conv.weight"]
    with pytest.raises(RuntimeError, match="Missing key"):
        InceptionV3.from_state_dict(sd)


def test_torch_fid_extract_resizes_as_jax(state, tmp_path):
    path = tmp_path / "inception.pt"
    torch.save(state, path)
    img = np.random.default_rng(2).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    x = np.asarray(j_bilinear((jnp.asarray(img) + 1) / 2, 299, align_corners=False))
    model = InceptionV3.from_state_dict(state).eval()
    with torch.no_grad():
        got = evaluate.load_fid_extract(str(path), "cpu")(t(img))
        want = model(t(x))[0]
    assert tuple(got.shape) == (2, 2048)
    _rel_close(got.numpy(), want.numpy(), TOL)

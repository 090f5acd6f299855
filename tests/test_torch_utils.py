"""The port's ``utils/cutouts.py``, ``utils/profiling.py`` and
``utils/registry.py`` (counterparts of the JAX package's modules).

Cutouts: ``resample``, ``clamp_with_grad`` (value and gradient),
``masks_to_boxes`` and ``crop_resize_bilinear`` against the JAX functions
on the same numpy inputs within 1e-5; ``MakeCutouts``' shapes and range.
Profiling: ``StageTimer``, ``sync_fetch`` and ``trace``'s Chrome trace, which
holds the program's ``ops.upfirdn2d`` span around its convolution.
Registry: the four behaviours of tests/test_registry.py, with ``gdown``
mocked (nothing is downloaded)."""

import gzip
import json
import sys
import types

import jax.numpy as jnp
import jax
import numpy as np
import pytest
import torch

from where2edit_tpu.utils import cutouts as jc
from where2edit_tpu.utils.registry import GOOGLE_DRIVE_PATHS as JAX_PATHS
from where2edit_tpu_torch.ops.upfirdn2d import make_kernel, upfirdn2d
from where2edit_tpu_torch.utils import cutouts as tc
from where2edit_tpu_torch.utils import profiling
from where2edit_tpu_torch.utils.registry import (
    GOOGLE_DRIVE_PATHS,
    ensure_checkpoint_exists,
)

from torch_parity import close, t

TOL = 1e-5


@pytest.mark.parametrize("size", [(16, 20), (32, 12), (40, 40)])
def test_torch_resample_matches_jax(size):
    x = np.random.default_rng(1).uniform(0, 1, (2, 40, 36, 3)).astype(np.float32)
    close(tc.resample(t(x), size), jc.resample(jnp.asarray(x), size), TOL)
    np.testing.assert_allclose(tc._lanczos_kernel(0.4), jc._lanczos_kernel(0.4))


def test_torch_clamp_with_grad_value_and_gradient():
    rng = np.random.default_rng(2)
    x = rng.uniform(-0.5, 1.5, (4, 8, 8, 3)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jc.clamp_with_grad(v, 0.0, 1.0), jnp.asarray(x))
    (gx_want,) = vjp(jnp.asarray(g))
    xt = t(x).requires_grad_(True)
    got = tc.clamp_with_grad(xt, 0.0, 1.0)
    got.backward(t(g))
    close(got, want, 0)
    close(xt.grad, gx_want, 0)
    # the gradient passes where it points back inside the range
    assert (xt.grad != 0).any() and (xt.grad == 0).any()


@pytest.mark.parametrize("threshold", [0.5, 0.7])
def test_torch_masks_to_boxes_matches_jax(threshold):
    rng = np.random.default_rng(3)
    masks = np.zeros((4, 32, 32, 1), np.float32)
    masks[0, 5:12, 8:20] = 0.9
    masks[1] = rng.uniform(0, 1, (32, 32, 1))
    masks[3, 30:, :2] = 0.8          # box at the corner; mask 2 is empty
    got = tc.masks_to_boxes(t(masks), threshold)
    want = jc.masks_to_boxes(jnp.asarray(masks), threshold)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tc.masks_to_boxes(t(masks[..., 0]), threshold).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("oy,ox,size", [(0.0, 0.0, 32.0), (3.0, 7.0, 17.0),
                                        (10.0, 2.0, 21.5)])
def test_torch_crop_resize_bilinear_matches_jax(oy, ox, size):
    x = np.random.default_rng(4).standard_normal((2, 32, 32, 3)).astype(np.float32)
    got = tc.crop_resize_bilinear(t(x), torch.tensor(oy), torch.tensor(ox),
                                  torch.tensor(size), 16)
    want = jc.crop_resize_bilinear(jnp.asarray(x), oy, ox, size, 16)
    close(got, want, TOL)


@pytest.mark.parametrize("hw,cut", [(64, 16), (24, 16)])
def test_torch_make_cutouts_shapes_and_range(hw, cut):
    x = torch.rand(2, hw, hw, 3)
    mk = tc.MakeCutouts(cut, cutn=5, cut_pow=1.0, noise_fac=0.1)
    out = mk(x, torch.Generator().manual_seed(0))
    assert out.shape == (10, cut, cut, 3)
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    again = mk(x, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)  # the draws come from the generator alone
    xg = x.clone().requires_grad_(True)
    tc.MakeCutouts(cut, cutn=2, noise_fac=0.0)(xg, torch.Generator().manual_seed(1)).sum().backward()
    assert torch.isfinite(xg.grad).all() and xg.grad.abs().sum() > 0


def test_torch_stage_timer_and_trace(tmp_path):
    timer = profiling.StageTimer()
    a = torch.randn(64, 64)
    with timer.stage("matmul"):
        for _ in range(3):
            a = a @ a / 64
    out = timer.time_fn("add", lambda v: [v + 1, v * 2], a)
    assert len(out) == 2
    report = timer.report()
    assert "matmul" in report and "add" in report and "%" in report
    assert set(timer.ms()) == {"matmul", "add"}
    assert profiling.sync_fetch({"x": a}) == {"x": a}
    x = torch.randn(1, 8, 8, 4)
    with profiling.trace(str(tmp_path)):
        upfirdn2d(x, make_kernel([1, 3, 3, 1]), up=2, pad=(2, 1))
    (path,) = tmp_path.glob("*.trace.json.gz")
    with gzip.open(path, "rt") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    (span,) = [e for e in events if e["name"] == "ops.upfirdn2d"]
    convs = [e for e in events if e["name"] == "aten::convolution"]
    assert convs and all(span["ts"] <= c["ts"] and c["ts"] + c["dur"] <= span["ts"] + span["dur"]
                         for c in convs)
    assert profiling.totals()["ops.upfirdn2d"]["count"] == 1


def test_torch_registry_table_is_the_jax_table():
    assert GOOGLE_DRIVE_PATHS == JAX_PATHS
    assert len([k for k in GOOGLE_DRIVE_PATHS if k.startswith("mapper/")]) == 14


def test_torch_registry_existing_file_short_circuits(tmp_path):
    f = tmp_path / "weights.pt"
    f.write_bytes(b"x")
    assert ensure_checkpoint_exists(str(f)) is True


def test_torch_registry_unknown_name(tmp_path, capsys):
    assert ensure_checkpoint_exists(str(tmp_path / "not-in-registry.pt")) is False
    out = capsys.readouterr().out
    assert "not found" in out and "manually" in out


def test_torch_registry_download_via_mocked_gdown(tmp_path, monkeypatch):
    calls = {}

    def fake_download(url, path, quiet=False):
        calls["url"], calls["path"] = url, path
        with open(path, "wb") as fh:
            fh.write(b"ckpt-bytes")
        return path

    fake = types.ModuleType("gdown")
    fake.download = fake_download
    monkeypatch.setitem(sys.modules, "gdown", fake)
    monkeypatch.chdir(tmp_path)
    name = "stylegan2-ffhq-config-f.pt"
    assert ensure_checkpoint_exists(name) is True
    assert calls == {"url": GOOGLE_DRIVE_PATHS[name], "path": name}


def test_torch_registry_gdown_absent_prints_url(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "gdown", None)  # the import raises
    monkeypatch.chdir(tmp_path)
    name = "example_celebs.pt"
    assert ensure_checkpoint_exists(name) is False
    out = capsys.readouterr().out
    assert "gdown" in out and GOOGLE_DRIVE_PATHS[name] in out

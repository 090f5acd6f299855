"""The port's StyleCLIP CLIs on the CPU: ``cli/mapper_train.py`` at 32²
(refusal of an existing ``exp_dir``, ``opt.json``, a SIGTERM snapshot that
``--resume`` carries to ``max_steps`` bit for bit against an uninterrupted
run, a warm start from a reference-layout ``.pt``) and
``cli/mapper_inference.py`` at 64² (the options re-hydrated from the
checkpoint, its images, latents and ``stats.txt``, the latents against the
JAX package's ``w + 0.1·mapper(w)`` on the same weights)."""

import glob
import json
import os
import signal
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from where2edit_tpu.editing.latent_mappers import LevelsMapper as JLevelsMapper
from where2edit_tpu_torch import convert
from where2edit_tpu_torch.cli import mapper_inference, mapper_train
from where2edit_tpu_torch.cli.common import build_generator
from where2edit_tpu_torch.editing.styleclip_mapper import build_mapper
from where2edit_tpu_torch.models.clip_model import CLIP
from where2edit_tpu_torch.train.coach import Coach

from torch_parity import TINY_CLIP, np_tree

SIZE = 32


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """``MetricsWriter`` writes JSON lines only (importing TensorBoard
    pulls in TensorFlow where it is installed)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    torch.set_num_threads(min(torch.get_num_threads(), 2))


@pytest.fixture(scope="module")
def clip_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clip") / "clip.pt")
    torch.save(CLIP(**TINY_CLIP, rng=torch.Generator().manual_seed(2)).state_dict(), path)
    return path


def _train_args(exp_dir, clip_file, *extra) -> list:
    return ["--exp_dir", str(exp_dir), "--description", "purple hair",
            "--stylegan_size", str(SIZE), "--stylegan_weights", "/nonexistent",
            "--clip_ckpt", clip_file, "--id_lambda", "0", "--max_steps", "4",
            "--train_dataset_size", "6", "--test_dataset_size", "2",
            "--val_interval", "3", "--board_interval", "1", "--device", "cpu", *extra]


def _load(path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def test_torch_mapper_train_cli_refuses_existing_exp_dir(tmp_path, clip_file):
    """``opt.json`` holds the run's flags, the checkpoints the mapper under
    ``mapper.`` with those options; a second run into the same
    ``exp_dir`` is refused before any work."""
    exp = tmp_path / "exp"
    args = _train_args(exp, clip_file, "--max_steps", "1")
    coach = mapper_train.main(args)
    with open(exp / "opt.json") as f:
        opts = json.load(f)
    assert opts["description"] == "purple hair" and opts["no_fine_mapper"] is False
    assert opts["device"] == "cpu" and coach.global_step == 1
    ckpt = _load(exp / "checkpoints" / "iteration_1.pt")
    assert ckpt["opts"] == opts and ckpt["step"] == 1
    assert set(ckpt["state_dict"]) == {f"mapper.{k}" for k in coach.mapper.state_dict()}
    assert (exp / "checkpoints" / "timestamp.txt").exists()
    with pytest.raises(FileExistsError, match="already exists"):
        mapper_train.main(args)


def test_torch_mapper_train_cli_sigterm_resume_bit_exact(tmp_path, clip_file, monkeypatch):
    """SIGTERM at step 2 (mid-epoch: 3 batches an epoch) leaves
    ``preempt.pt`` at step 2; ``--resume`` of it ends at step 4 with the
    uninterrupted run's mapper and optimizer state, bit for bit."""
    mapper_train.main(_train_args(tmp_path / "full", clip_file))

    orig_train = Coach.train

    def train_with_sigterm(self, stop_fn=None):
        def stop():
            if self.global_step >= 2:
                signal.raise_signal(signal.SIGTERM)
            return bool(stop_fn())
        return orig_train(self, stop_fn=stop)

    monkeypatch.setattr(Coach, "train", train_with_sigterm)
    mapper_train.main(_train_args(tmp_path / "pre", clip_file))
    monkeypatch.setattr(Coach, "train", orig_train)
    snap = tmp_path / "pre" / "checkpoints" / "preempt.pt"
    pre = _load(snap)
    assert pre["step"] == 2 and pre["epoch_pos"] == 2
    assert not (tmp_path / "pre" / "checkpoints" / "iteration_4.pt").exists()

    coach = mapper_train.main(_train_args(tmp_path / "res", clip_file, "--resume", str(snap)))
    assert coach.global_step == 4
    full = _load(tmp_path / "full" / "checkpoints" / "iteration_4.pt")
    res = _load(tmp_path / "res" / "checkpoints" / "iteration_4.pt")
    assert full["step"] == res["step"] == 4
    for k, v in full["state_dict"].items():
        assert torch.equal(v, res["state_dict"][k]), k
    # trained past the snapshot (at 32² the fine group has no rows, so its
    # mapper has no gradient and stays)
    moved = {k for k, v in full["state_dict"].items() if not torch.equal(v, pre["state_dict"][k])}
    assert moved and all("fine_mapping" in k for k in set(full["state_dict"]) - moved)
    for i, st in full["optimizer"]["state"].items():
        for name, v in st.items():
            got = res["optimizer"]["state"][i][name]
            assert torch.equal(v, got) if torch.is_tensor(v) else v == got, (i, name)


def test_torch_mapper_train_cli_warmstarts_from_reference_pt(tmp_path, clip_file):
    """``--checkpoint_path`` on a reference StyleCLIP ``.pt`` (``mapper.*``
    and ``decoder.*`` under ``state_dict``): at lr 0 the run ends at the
    file's mapper; without it, at the seeded init, which differs."""
    rng = torch.Generator().manual_seed(7)
    ref_mapper = build_mapper("LevelsMapper", no_coarse_mapper=True, rng=rng)
    decoder, _ = build_generator(SIZE, None, device="cpu", seed=3)
    sd = {f"mapper.{k}": v for k, v in ref_mapper.state_dict().items()}
    sd.update({f"decoder.{k}": v for k, v in decoder.state_dict().items()})
    ref = tmp_path / "styleclip.pt"
    torch.save({"state_dict": sd, "opts": {"mapper_type": "LevelsMapper"}}, ref)

    base = ("--max_steps", "1", "--learning_rate", "0", "--no_coarse_mapper")
    mapper_train.main(_train_args(tmp_path / "warm", clip_file, *base,
                                  "--checkpoint_path", str(ref)))
    mapper_train.main(_train_args(tmp_path / "cold", clip_file, *base))
    warm = _load(tmp_path / "warm" / "checkpoints" / "iteration_1.pt")["state_dict"]
    cold = _load(tmp_path / "cold" / "checkpoints" / "iteration_1.pt")["state_dict"]
    want = {k: v for k, v in sd.items() if k.startswith("mapper.")}
    assert set(warm) == set(want)
    assert all(torch.equal(warm[k], v) for k, v in want.items())
    assert any(not torch.equal(cold[k], v) for k, v in want.items())


def test_torch_mapper_inference_opts_rehydration():
    """Checkpoint options are re-hydrated and only flags given explicitly
    override them; without checkpoint options, the defaults."""
    base = ["--exp_dir", "e", "--checkpoint_path", "c", "--latents_test_path", "l"]
    p = mapper_inference.build_argparser()
    ckpt_opts = {"mapper_type": "SingleMapper", "stylegan_size": 256,
                 "no_coarse_mapper": True, "work_in_stylespace": True}
    opts = mapper_inference.resolve_opts(vars(p.parse_args(base)), ckpt_opts)
    assert opts["mapper_type"] == "SingleMapper" and opts["stylegan_size"] == 256
    assert opts["no_coarse_mapper"] is True and opts["work_in_stylespace"] is True
    opts2 = mapper_inference.resolve_opts(
        vars(p.parse_args(base + ["--stylegan_size", "1024"])), ckpt_opts)
    assert opts2["stylegan_size"] == 1024 and opts2["mapper_type"] == "SingleMapper"
    opts3 = mapper_inference.resolve_opts(vars(p.parse_args(base)), None)
    assert opts3["mapper_type"] == "LevelsMapper" and opts3["stylegan_size"] == 1024
    assert "device" not in vars(p.parse_args(base))


def _inference_world(tmp_path, size: int = 64, **opts):
    """A checkpoint of JAX ``LevelsMapper`` weights (biases N(0, 30)) in the
    training CLI's layout, and a latent file; returns (flax mapper, its
    variables, the latents, the paths)."""
    rng = np.random.default_rng(11)
    n_latent = 2 * int(np.log2(size)) - 2
    jm = JLevelsMapper()
    v = np_tree(jax.jit(lambda a: jm.init({"params": jax.random.PRNGKey(4)}, a))(
        jnp.zeros((1, n_latent, 512))))
    params = jax.tree.map(lambda a: a, dict(v["params"]))
    for group in params.values():
        for fc in group.values():
            fc["bias"] = (rng.standard_normal(fc["bias"].shape) * 30).astype(np.float32)
    sd = convert.latent_mapper_state_dict({"params": params}, "LevelsMapper")
    ckpt = tmp_path / "best_model.pt"
    torch.save({"state_dict": {f"mapper.{k}": v for k, v in sd.items()},
                "opts": {"mapper_type": "LevelsMapper", "stylegan_size": size,
                         "stylegan_weights": "/nonexistent", "test_batch_size": 1,
                         "device": "cuda", **opts}}, ckpt)
    w = (rng.standard_normal((5, n_latent, 512)) * 0.5).astype(np.float32)
    lat = tmp_path / "latents.pt"
    torch.save(torch.from_numpy(w), lat)
    return jm, params, w, str(ckpt), str(lat)


def test_torch_mapper_inference_cli_matches_jax(tmp_path):
    """3 of 5 latents at test batch 2 (a flag over the checkpoint's 1),
    coupled: one image per latent, one latent file per batch, the
    runtime line; the saved latents are the JAX package's
    ``w + 0.1·mapper(w)`` on the same weights (within 1e-6 of their
    largest magnitude); the checkpoint's ``device`` option is not used."""
    jm, params, w, ckpt, lat = _inference_world(tmp_path)
    out = mapper_inference.main(["--exp_dir", str(tmp_path / "inf"), "--checkpoint_path",
                                 ckpt, "--latents_test_path", lat, "--couple_outputs",
                                 "--test_batch_size", "2", "--n_images", "3",
                                 "--device", "cpu"])
    names = sorted(os.listdir(out))
    assert names == ["00000.jpg", "00001.jpg", "00002.jpg", "latents_00000.npy",
                     "latents_00002.npy", "stats.txt"]
    with open(os.path.join(out, "stats.txt")) as f:
        assert f.read().startswith("Runtime ")
    got = np.concatenate([np.load(p) for p in sorted(glob.glob(os.path.join(out, "*.npy")))])
    want = np.asarray(w[:3] + 0.1 * jax.jit(jm.apply)({"params": params}, jnp.asarray(w[:3])))
    assert got.shape == want.shape == (3, 10, 512)
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-6
    from PIL import Image  # noqa: PLC0415

    with Image.open(os.path.join(out, "00000.jpg")) as im:
        assert im.size == (2 * 64 + 3 * 2, 64 + 2 * 2)  # original | edit, padded


def test_torch_mapper_inference_refuses_stylespace(tmp_path):
    """A ``work_in_stylespace`` checkpoint is refused, as the JAX CLI edits
    W+ only."""
    _, _, _, ckpt, lat = _inference_world(tmp_path, size=32, work_in_stylespace=True)
    with pytest.raises(SystemExit, match="work_in_stylespace"):
        mapper_inference.main(["--exp_dir", str(tmp_path / "inf"), "--checkpoint_path",
                               ckpt, "--latents_test_path", lat, "--device", "cpu"])


def test_torch_mapper_train_cli_bf16(tmp_path, clip_file):
    """``--bf16``: the coach's generator synthesises in bf16 (its image and
    the losses fp32), the mapper trains, the run's options keep the flag."""
    coach = mapper_train.main(_train_args(tmp_path / "bf16", clip_file, "--bf16"))
    assert coach.global_step == 4
    assert coach.generator.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in coach.mapper.parameters())
    assert json.load(open(tmp_path / "bf16" / "opt.json"))["bf16"] is True
    ckpt = _load(tmp_path / "bf16" / "checkpoints" / "iteration_4.pt")
    assert all(torch.isfinite(v).all() for v in ckpt["state_dict"].values())
    assert np.isfinite(coach.best_val_loss)

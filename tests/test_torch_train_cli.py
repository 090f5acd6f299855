"""The port's adversarial-training entry point on the CPU: the CLI end to
end (it writes checkpoints) and ``--resume`` continuing one exactly as the
uninterrupted run did; ``--fid_every`` (the EMA generator's FID, logged as
``eval/fid``); and the kernel calls per training program, which
``chip_smoke.py`` holds the card's launch counters to
(``chip_smoke.train_launches``)."""

import contextlib
import os
import shutil

import numpy as np
import pytest
import torch

from where2edit_tpu_torch.cli import train_stylegan
from where2edit_tpu_torch.cli.run_attention import load_clip
from where2edit_tpu_torch.eval.metrics import frechet_distance
from where2edit_tpu_torch.kernels import conv3x3 as k2
from where2edit_tpu_torch.kernels import modconv1x1 as k3
from where2edit_tpu_torch.kernels import modconv3x3 as k1
from where2edit_tpu_torch.losses.clip_loss import CLIPLoss
from where2edit_tpu_torch.models.clip_model import CLIP
from where2edit_tpu_torch.train.datasets import ImageBank
from where2edit_tpu_torch.train.gan_trainer import GANTrainConfig, GANTrainer
from where2edit_tpu_torch.utils.logging import read_scalars

from torch_parity import TINY_CLIP

ARGS = ["--synthetic", "6", "--size", "16", "--batch", "4", "--device", "cpu",
        "--save_every", "1"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the tier-1 run puts six test processes on the
    machine's cores, where more threads per process spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("gan")
    trainer = train_stylegan.main([*ARGS, "--iter", "2", "--results_dir", str(out / "a")])
    return out, trainer


def test_torch_train_cli_writes_checkpoints(first_run):
    out, trainer = first_run
    assert trainer.global_step == 2
    for step in (1, 2):
        ckpt = torch.load(out / "a" / f"ckpt_{step:07d}.pt", weights_only=True)
        assert ckpt["step"] == step and ckpt["opts"]["size"] == 16
        assert set(ckpt) >= {"g", "d", "g_ema", "g_opt", "d_opt", "pl_mean", "rng"}
    assert float(ckpt["pl_mean"]) != 0.0  # step 0 ran the path length penalty


def test_torch_train_cli_resume_matches_uninterrupted(first_run):
    out, _ = first_run
    resumed = train_stylegan.main([*ARGS, "--iter", "2", "--resume",
                                   str(out / "a" / "ckpt_0000001.pt"),
                                   "--results_dir", str(out / "b")])
    assert resumed.global_step == 2
    want = torch.load(out / "a" / "ckpt_0000002.pt", weights_only=True)
    got = torch.load(out / "b" / "ckpt_0000002.pt", weights_only=True)
    for part in ("g", "d", "g_ema"):
        for name, v in want[part].items():
            assert torch.equal(got[part][name], v), (part, name)
    assert torch.equal(got["pl_mean"], want["pl_mean"])
    assert torch.equal(got["rng"], want["rng"])


def test_torch_train_cli_needs_reals():
    with pytest.raises(SystemExit):
        train_stylegan.main(["--size", "16", "--device", "cpu"])


def test_torch_train_launches_per_program(monkeypatch):
    """Each Function call runs the plain version once on the CPU, where the
    card launches its kernel once: counted per program at 16² (2 octaves),
    every program run (both regularisers at every step), split into calls
    made in the forward and inside a backward pass."""
    import chip_smoke  # noqa: PLC0415

    calls = [0] * 6  # (K1, K2, K3) forward, then (K1, K2, K3) backward
    for i, (mod, name) in enumerate(((k1, "modconv3x3_plain"), (k2, "conv3x3_plain"),
                                     (k3, "modconv1x1_plain"))):
        plain = getattr(mod, name)

        def counted(*a, _plain=plain, _i=i, **k):
            in_backward = torch._C._current_autograd_node() is not None
            calls[_i + 3 * in_backward] += 1
            return _plain(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    tr = GANTrainer(GANTrainConfig(size=16, batch_size=2, channel_multiplier=1,
                                   d_reg_every=1, g_reg_every=1), device="cpu")
    got = {}

    @contextlib.contextmanager
    def span(program, trainer):
        before = tuple(calls)
        yield
        diff = tuple(a - b for a, b in zip(calls, before))
        got[program] = (diff[:3], diff[3:])

    tr.step(torch.rand(2, 16, 16, 3) * 2 - 1, span)
    assert got == {**chip_smoke.train_launches(2), "ema": ((0, 0, 0), (0, 0, 0))}


def test_torch_train_cli_fid_every(tmp_path):
    """``--fid_every 1`` at 32² with CLIP-FID (a small CLIP from
    ``--clip_ckpt``; the InceptionV3 extractor runs in chip_smoke.py's
    phase 15d and tests/test_torch_inception.py): a finite FID of the EMA
    generator against the real pool (drawn from seed + 3) over the fixed z
    pool (seed + 4), logged as ``eval/fid``; recomputed from the returned
    trainer's EMA generator and the same pools it is the same number."""
    clip = tmp_path / "clip.pt"
    torch.save(CLIP(**TINY_CLIP, rng=torch.Generator().manual_seed(0)).state_dict(), clip)
    out = tmp_path / "run"
    trainer = train_stylegan.main([
        "--synthetic", "6", "--size", "32", "--batch", "2", "--device", "cpu",
        "--save_every", "0", "--iter", "1", "--fid_every", "1", "--fid_n", "3",
        "--fid_batch", "2", "--clip_ckpt", str(clip), "--results_dir", str(out)])
    rows = read_scalars(os.path.join(out, "logs"))
    fids = [r for r in rows if r["tag"] == "eval/fid"]
    assert [r["step"] for r in fids] == [1] and np.isfinite(fids[0]["value"])
    assert {"train/d_loss", "train/g_loss"} <= {r["tag"] for r in rows}

    extract = CLIPLoss(load_clip(str(clip), "cpu"), 32).encode_image
    bank = ImageBank(images=np.random.default_rng(0).uniform(
        -1.0, 1.0, (6, 32, 32, 3)).astype(np.float32))
    real_rng = np.random.default_rng(3)  # --fid_n 3 rounds up to 2 batches of 2
    z = torch.from_numpy(np.random.default_rng(4).standard_normal((4, 512)).astype(np.float32))
    with torch.no_grad():
        real = np.concatenate([extract(torch.from_numpy(bank.sample(real_rng, 2))).numpy()
                               for _ in range(2)])
        fake = np.concatenate([extract(trainer.g_ema([z[i:i + 2]], randomize_noise=False)
                                       .image).numpy() for i in (0, 2)])
    assert real.shape == fake.shape == (4, 512)
    assert frechet_distance(real, fake) == fids[0]["value"]


def test_torch_train_cli_ckpt_warm_start(tmp_path):
    """``--ckpt``: G and its EMA start from a reference ``.pt``'s ``g_ema``
    (here at ``--iter 0``, so nothing moves them), in bf16 too."""
    from where2edit_tpu_torch.models.stylegan2 import Generator  # noqa: PLC0415

    sd = Generator(16, rng=torch.Generator().manual_seed(9)).state_dict()
    torch.save({"g_ema": sd}, tmp_path / "g.pt")
    for flags in ([], ["--bf16"]):
        trainer = train_stylegan.main([*ARGS, "--iter", "0", "--ckpt", str(tmp_path / "g.pt"),
                                       "--results_dir", str(tmp_path / "r"), *flags])
        assert trainer.g.dtype == (torch.bfloat16 if flags else torch.float32)
        for model in (trainer.g, trainer.g_ema):
            for name, v in model.state_dict().items():
                assert torch.equal(v, sd[name]), name
    shutil.rmtree(tmp_path)  # full-width G and D checkpoints, ~0.2 GB each


def test_torch_train_cli_ckpt_missing_file_exits(tmp_path):
    """A ``--ckpt`` that names no file stops the run before any step,
    rather than training G from random weights."""
    with pytest.raises(SystemExit, match="no such file"):
        train_stylegan.main([*ARGS, "--iter", "1", "--ckpt", str(tmp_path / "none.pt"),
                             "--results_dir", str(tmp_path / "r")])
    assert not os.path.exists(tmp_path / "r")


def test_torch_train_cli_bf16_levers_loader_and_grids(tmp_path):
    """Every new flag at 32²: bf16 G and D, remat, d_remat, both
    micro-batches, the background loader with flips, an EMA sample grid
    per step; finite losses, and the trainer built as the flags say."""
    out = tmp_path / "levers"
    trainer = train_stylegan.main([
        "--synthetic", "6", "--size", "32", "--batch", "4", "--device", "cpu",
        "--iter", "2", "--save_every", "0", "--bf16", "--remat", "--d_bf16", "--d_remat",
        "--d_microbatch", "2", "--g_microbatch", "2", "--workers", "2", "--hflip",
        "--sample_every", "1", "--n_sample", "4", "--results_dir", str(out)])
    cfg = trainer.cfg
    assert (cfg.bf16, cfg.remat, cfg.d_bf16, cfg.d_remat, cfg.d_microbatch,
            cfg.g_microbatch) == (True, True, True, True, 2, 2)
    assert trainer.g.dtype == trainer.d.dtype == torch.bfloat16 and trainer.d.remat
    assert all(p.dtype == torch.float32 for p in trainer.g.parameters())
    assert all(np.isfinite(float(v)) for v in trainer.metrics.values())
    assert sorted(f for f in os.listdir(out) if f.startswith("sample_")) == [
        "sample_0000001.jpg", "sample_0000002.jpg"]
    assert os.path.isfile(out / "ckpt_0000002.pt")
    shutil.rmtree(tmp_path)  # full-width G and D checkpoints, ~0.6 GB each


def test_torch_train_cli_sigterm_resume_bit_exact(tmp_path, monkeypatch):
    """SIGTERM during a step: a checkpoint at the next step boundary, a
    clean return (None); ``--resume`` of it ends bit for bit where an
    uninterrupted run ends, the draws, the real-image stream and the flip
    stream included (the loader with ``--hflip``)."""
    import signal  # noqa: PLC0415

    common = [*ARGS[:-2], "--save_every", "0", "--iter", "4", "--d_reg_every", "2",
              "--g_reg_every", "2", "--hflip", "--workers", "1"]
    train_stylegan.main([*common, "--results_dir", str(tmp_path / "full")])
    orig_step = GANTrainer.step

    def step_with_sigterm(self, real, span=None):
        if self.global_step == 2:
            signal.raise_signal(signal.SIGTERM)
        return orig_step(self, real, span)

    monkeypatch.setattr(GANTrainer, "step", step_with_sigterm)
    assert train_stylegan.main([*common, "--results_dir", str(tmp_path / "pre")]) is None
    monkeypatch.setattr(GANTrainer, "step", orig_step)
    ckpts = sorted(f for f in os.listdir(tmp_path / "pre") if f.startswith("ckpt_"))
    assert ckpts == ["ckpt_0000003.pt"]  # step 2 finished, then the boundary
    resumed = train_stylegan.main([*common, "--results_dir", str(tmp_path / "res"),
                                   "--resume", str(tmp_path / "pre" / ckpts[0])])
    assert resumed.global_step == 4
    want = torch.load(tmp_path / "full" / "ckpt_0000004.pt", weights_only=True)
    got = torch.load(tmp_path / "res" / "ckpt_0000004.pt", weights_only=True)
    for part in ("g", "d", "g_ema"):
        for name, v in want[part].items():
            assert torch.equal(got[part][name], v), (part, name)
    assert torch.equal(got["pl_mean"], want["pl_mean"])
    assert torch.equal(got["rng"], want["rng"])
    shutil.rmtree(tmp_path)  # three full-width G and D checkpoints, ~0.4 GB each

"""``cli/run_attention.py`` of the port end to end on the CPU at generator
size 32: the k-means pickle of ``cli/run_clustering.py`` feeds a 2-step
run of the production mapper (grids, ``video.txt``, checkpoints, the source
snapshot, the own-phrase renders) with ``--clip_ckpt`` and ``--vgg_ckpt``
files in the reference layouts (a small OpenAI-layout CLIP, a torchvision
VGG16); a SIGTERM snapshot that ``--resume`` continues bit for bit as an
uninterrupted run; the three other mapper branches (the W+ mappers and the
S-space one without clusters) for 2 steps each, resumed bit for bit from
their step-1 checkpoint; the ``--latent_path`` loader.
"""

import contextlib
import os
import signal

import numpy as np
import pytest
import torch

from where2edit_tpu_torch.cli import run_attention, run_clustering
from where2edit_tpu_torch.models.clip_model import CLIP
from where2edit_tpu_torch.models.stylegan2 import Generator
from where2edit_tpu_torch.models.vgg import Vgg16
from where2edit_tpu_torch.train.attention_trainer import AttentionTrainer

SMALL_CLIP = dict(embed_dim=512, image_resolution=224, vision_width=64,
                  vision_layers=1, vision_patch_size=32, text_width=64,
                  text_heads=1, text_layers=1, vision_heads=1)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The k-means pickle at cluster layer 7 (a 512-wide 16² conv) and
    reference-layout CLIP and VGG16 files."""
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("assets")
    pkl = run_clustering.main(["--stylegan_size", "32", "--device", "cpu",
                               "--attention_layer", "7", "--batch_size", "2",
                               "--step", "1", "--results_dir", str(root / "k"),
                               "--ckpt", "/nonexistent"])
    clip = CLIP(**SMALL_CLIP, rng=torch.Generator().manual_seed(1))
    torch.save({**clip.state_dict(), "context_length": torch.tensor(77)},
               root / "clip.pt")
    vgg = Vgg16(rng=torch.Generator().manual_seed(2))
    torch.save({**vgg.state_dict(), "classifier.0.bias": torch.zeros(4)},
               root / "vgg16.pth")
    phrases = root / "phrases.txt"
    phrases.write_text("purple hair\nbig eyes\n")
    return {"pkl": pkl, "clip": str(root / "clip.pt"), "vgg": str(root / "vgg16.pth"),
            "clip_sd": clip.state_dict(), "vgg_sd": vgg.state_dict(),
            "phrases": str(phrases)}


def _args(assets, results, *extra):
    return ["--stylegan_size", "32", "--device", "cpu", "--work_in_stylespace",
            "--use_cluster", "--cluster_path", assets["pkl"], "--cluster_layer", "7",
            "--clip_ckpt", assets["clip"], "--vgg_ckpt", assets["vgg"],
            "--ckpt", "/nonexistent", "--results_dir", str(results), *extra]


def test_torch_run_attention_cli_two_steps(assets, tmp_path):
    out = run_attention.main(_args(assets, tmp_path, "--step", "2", "--batch_size", "2",
                                   "--save_intermediate_image_every", "2",
                                   "--own_description_dir", assets["phrases"]))
    files = set(os.listdir(out))
    assert {"00002.jpg", "attention00002.jpg", "final_result.jpg",
            "final_attention.jpg", "video.txt", "run.log", "00002_mapper.pt",
            "final_mapper.pt"} <= files
    assert os.path.isfile(os.path.join(out, "code", "where2edit_tpu_torch", "train",
                                       "attention_trainer.py"))
    log = open(os.path.join(out, "run.log")).read()
    assert "no CLIP checkpoint" not in log and "no VGG checkpoint" not in log
    assert "step 1: loss=" in log
    assert open(os.path.join(out, "video.txt")).read() == "file ./00002.jpg\nduration 0.2\n"
    ckpt = torch.load(os.path.join(out, "final_mapper.pt"), weights_only=True)
    assert ckpt["step"] == 2 and ckpt["adam"]["count"] == 2
    assert ckpt["opts"]["stylegan_size"] == 32
    assert "attention_0.conv.modulation.weight" in ckpt["mapper"]  # reference keys
    centers = np.asarray(ckpt["mapper"]["initial_state"])
    assert centers.shape == (10, 576) and np.abs(centers).max() > 0


def test_torch_run_attention_cli_bf16_remat(assets, tmp_path):
    """``--bf16 --remat``: a bf16 generator (fp32 parameters, fp32 image)
    and the grad-pass synthesis recomputed in the backward; two steps with
    finite losses, and the mapper trained."""
    captured = {}

    def span(stage, trainer):
        captured["trainer"] = trainer
        return contextlib.nullcontext()

    out = run_attention.main(_args(assets, tmp_path, "--step", "2", "--batch_size", "2",
                                   "--save_intermediate_image_every", "0", "--bf16",
                                   "--remat"), span=span)
    trainer = captured["trainer"]
    assert trainer.cfg.remat and trainer.generator.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in trainer.generator.parameters())
    log = open(os.path.join(out, "run.log")).read()
    assert "step 1: loss=" in log and "nan" not in log.lower()
    ckpt = torch.load(os.path.join(out, "final_mapper.pt"), weights_only=True)
    assert ckpt["step"] == 2 and ckpt["opts"]["bf16"] and ckpt["opts"]["remat"]


def test_torch_run_attention_cli_sigterm_resume_bitwise(assets, tmp_path, monkeypatch):
    args = ["--step", "4", "--batch_size", "1", "--save_intermediate_image_every", "0"]
    full = run_attention.main(_args(assets, tmp_path / "full", *args))
    # interrupted run: a real SIGTERM while step 1 runs; the loop stops at
    # the next step boundary and snapshots
    orig_step = AttentionTrainer.step

    def step_with_sigterm(self, step_idx, bank):
        out = orig_step(self, step_idx, bank)
        if step_idx == 1:
            signal.raise_signal(signal.SIGTERM)
        return out

    monkeypatch.setattr(AttentionTrainer, "step", step_with_sigterm)
    cut = run_attention.main(_args(assets, tmp_path / "cut", *args))
    monkeypatch.setattr(AttentionTrainer, "step", orig_step)
    snap = os.path.join(cut, "preempt_mapper.pt")
    assert os.path.isfile(snap) and not os.path.exists(os.path.join(cut, "final_mapper.pt"))
    assert torch.load(snap, weights_only=True)["step"] == 2
    resumed = run_attention.main(_args(assets, tmp_path / "resumed", *args,
                                       "--resume", snap))
    a = torch.load(os.path.join(full, "final_mapper.pt"), weights_only=True)
    b = torch.load(os.path.join(resumed, "final_mapper.pt"), weights_only=True)
    assert a["step"] == b["step"] == 4
    assert a["mapper"].keys() == b["mapper"].keys()
    for k in a["mapper"]:
        assert torch.equal(a["mapper"][k], b["mapper"][k]), k
    assert a["adam"]["count"] == b["adam"]["count"] == 4
    for x, y in zip(a["adam"]["mu"] + a["adam"]["nu"], b["adam"]["mu"] + b["adam"]["nu"]):
        assert torch.equal(x, y)
    assert torch.equal(a["rng"], b["rng"])


@pytest.mark.parametrize("flags,name", [
    ((), "FullSpaceMapperFEATLin"),
    (("--use_cluster",), "FullSpaceMapperFEATClusterLin"),
    (("--work_in_stylespace",), "FullSpaceMapperFEATLinStyle"),
])
def test_torch_run_attention_cli_unported_mappers(assets, tmp_path, flags, name):
    """The branches the first slices left out: each trains 2 steps with its
    own mapper (reference keys in the checkpoint), and a run resumed from
    the step-1 checkpoint ends where the 2-step run ends, bit for bit."""
    base = ["--stylegan_size", "32", "--device", "cpu", "--cluster_layer", "7",
            "--clip_ckpt", assets["clip"], "--vgg_ckpt", assets["vgg"],
            "--ckpt", "/nonexistent", "--step", "2", "--batch_size", "2",
            "--own_description_dir", assets["phrases"], *flags]
    if "--use_cluster" in flags:
        base += ["--cluster_path", assets["pkl"]]
    full = run_attention.main([*base, "--save_intermediate_image_every", "1",
                               "--results_dir", str(tmp_path / "full")])
    assert {"00001_mapper.pt", "final_mapper.pt", "final_result.jpg",
            "attention00002.jpg"} <= set(os.listdir(full))
    resumed = run_attention.main([*base, "--save_intermediate_image_every", "0",
                                  "--resume", os.path.join(full, "00001_mapper.pt"),
                                  "--results_dir", str(tmp_path / "resumed")])
    a = torch.load(os.path.join(full, "final_mapper.pt"), weights_only=True)
    b = torch.load(os.path.join(resumed, "final_mapper.pt"), weights_only=True)
    assert a["step"] == b["step"] == 2 and a["adam"]["count"] == b["adam"]["count"] == 2
    assert a["mapper"].keys() == b["mapper"].keys()
    for k in a["mapper"]:
        assert torch.equal(a["mapper"][k], b["mapper"][k]), k
    keys = set(a["mapper"])
    wplus = not flags or flags == ("--use_cluster",)
    # W+: three EqualLinears per row and the trunk; S-space: two per style
    assert ("mapper_0.3.weight" in keys) == wplus
    assert "mapper_0.2.weight" in keys and "attention_last.weight" in keys
    assert ("attention_first.weight" in keys) == wplus
    assert ("initial_state" in keys) == (name == "FullSpaceMapperFEATClusterLin")
    if "initial_state" in keys:
        assert float(a["mapper"]["initial_state"].abs().max()) > 0
    log = open(os.path.join(full, "run.log")).read()
    losses = [float(line.split("loss=")[1].split(";")[0])
              for line in log.splitlines() if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_torch_run_attention_loaders(assets, tmp_path):
    clip = run_attention.load_clip(assets["clip"], "cpu")
    for k, v in clip.state_dict().items():
        assert torch.equal(v, assets["clip_sd"][k]), k
    assert not any(p.requires_grad for p in clip.parameters())
    vgg = run_attention.load_vgg(assets["vgg"], "cpu")
    for k, v in vgg.state_dict().items():
        assert torch.equal(v, assets["vgg_sd"][k]), k
    gen = Generator(32)
    w = torch.randn(3, 512)
    torch.save(w, tmp_path / "w.pt")
    bank = run_attention.load_latent_bank(str(tmp_path / "w.pt"), gen)
    assert bank.shape == (3, gen.n_latent, 512) and torch.equal(bank[:, 5], w)
    torch.save({"latents": torch.randn(2, gen.n_latent, 512)}, tmp_path / "d.pt")
    assert run_attention.load_latent_bank(str(tmp_path / "d.pt"), gen).shape[0] == 2
    torch.save({"codes": w}, tmp_path / "bad.pt")
    with pytest.raises(SystemExit, match="'latents'"):
        run_attention.load_latent_bank(str(tmp_path / "bad.pt"), gen)

"""The port stands alone: importing where2edit_tpu_torch and every one of
its modules (in a fresh process) loads neither JAX nor any module of the JAX
package; entry points run on CUDA unless told otherwise and refuse to carry
on without a card."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import pkgutil, sys
import where2edit_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    where2edit_tpu_torch.__path__, "where2edit_tpu_torch.")]
for name in names:
    __import__(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "where2edit_tpu"))
print(len(names), bad, " ".join(names))
"""

NEW_MODULES = {  # adversarial training
    "where2edit_tpu_torch.kernels.conv3x3", "where2edit_tpu_torch.train",
    "where2edit_tpu_torch.train.gan_trainer", "where2edit_tpu_torch.train.datasets",
    "where2edit_tpu_torch.train.checkpoints", "where2edit_tpu_torch.cli.train_stylegan",
    # real-photo editing (e4e inversion; Pillow is imported only to read images)
    "where2edit_tpu_torch.models.irse", "where2edit_tpu_torch.models.encoders",
    "where2edit_tpu_torch.models.psp", "where2edit_tpu_torch.cli.common",
    "where2edit_tpu_torch.demo.gallery",
    # k-means regions and region-attention training
    "where2edit_tpu_torch.utils", "where2edit_tpu_torch.utils.native",
    "where2edit_tpu_torch.utils.images", "where2edit_tpu_torch.utils.logging",
    "where2edit_tpu_torch.utils.seed", "where2edit_tpu_torch.cli.run_clustering",
    "where2edit_tpu_torch.models.vgg", "where2edit_tpu_torch.losses",
    "where2edit_tpu_torch.losses.clip_loss", "where2edit_tpu_torch.losses.perceptual",
    "where2edit_tpu_torch.losses.infonce", "where2edit_tpu_torch.train.lr",
    "where2edit_tpu_torch.train.corpus", "where2edit_tpu_torch.train.attention_trainer",
    "where2edit_tpu_torch.cli.run_attention",
    # trained mappers served: the W+ family, the ablation nets, the server
    "where2edit_tpu_torch.editing.modules", "where2edit_tpu_torch.demo.server",
    # evaluation: FID / IS / SSIM, the mIoU, InceptionV3, ArcFace
    "where2edit_tpu_torch.eval", "where2edit_tpu_torch.eval.metrics",
    "where2edit_tpu_torch.eval.ssim", "where2edit_tpu_torch.eval.iou",
    "where2edit_tpu_torch.models.inception", "where2edit_tpu_torch.models.state",
    "where2edit_tpu_torch.losses.id_loss", "where2edit_tpu_torch.cli.evaluate",
    # the StyleCLIP family: latent mappers, Ranger, the coach, its two CLIs
    "where2edit_tpu_torch.editing.latent_mappers",
    "where2edit_tpu_torch.editing.styleclip_mapper", "where2edit_tpu_torch.train.ranger",
    "where2edit_tpu_torch.train.coach", "where2edit_tpu_torch.cli.mapper_train",
    "where2edit_tpu_torch.cli.mapper_inference",
    # data parallelism over torch.distributed
    "where2edit_tpu_torch.parallel", "where2edit_tpu_torch.parallel.dist",
    "where2edit_tpu_torch.parallel.collectives",
}


def test_torch_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad, names = out.stdout.strip().split(" ", 2)
    assert int(count) >= 41
    assert bad == "[]"
    assert NEW_MODULES <= set(names.split())


def test_torch_entry_points_need_a_card_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for GPU-less hosts")
    from where2edit_tpu_torch import resolve_device  # noqa: PLC0415
    from where2edit_tpu_torch.cli import edit, train_stylegan  # noqa: PLC0415
    from where2edit_tpu_torch.demo.app import (  # noqa: PLC0415
        build_argparser,
        build_session,
        load_psp,
        load_session,
    )
    from where2edit_tpu_torch.models.psp import PSp  # noqa: PLC0415

    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_session(32)
    torch.save({}, tmp_path / "e4e.pt")
    args = build_argparser().parse_args(["--stylegan_size", "32", "--e4e_ckpt",
                                         str(tmp_path / "e4e.pt")])
    for refused in (lambda: load_session(args), lambda: load_psp(args),
                    lambda: PSp.from_state_dict({}, stylegan_size=32)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            refused()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        edit.main(["--text", "grey hair", "--stylegan_size", "32"])
    from where2edit_tpu_torch.demo import server  # noqa: PLC0415

    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.main(["--stylegan_size", "32", "--port", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_stylegan.main(["--synthetic", "2", "--size", "8", "--iter", "1"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_torch_training_entry_points_need_a_card_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for GPU-less hosts")
    from where2edit_tpu_torch.cli import run_attention, run_clustering  # noqa: PLC0415

    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_clustering.main(["--stylegan_size", "8", "--results_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_attention.main(["--stylegan_size", "8", "--work_in_stylespace",
                            "--use_cluster", "--results_dir", str(tmp_path)])


def test_torch_evaluate_needs_a_card_unless_told(tmp_path):
    """``cli/evaluate.py`` refuses in both modes without a card, before any
    work, and runs on the CPU only when ``--device cpu`` says so."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for GPU-less hosts")
    from where2edit_tpu_torch.cli import evaluate  # noqa: PLC0415

    small = ["--stylegan_size", "8", "--attention_layer", "4", "--cluster_layer", "4"]
    for mode in ("edits", "iou"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            evaluate.main([mode, *small, "--e4e_ckpt", str(tmp_path / "e4e.pt")])
    with pytest.raises(SystemExit, match="no CelebAMask-HQ data"):
        torch.save({}, tmp_path / "e4e.pt")
        evaluate.main(["iou", *small, "--device", "cpu", "--e4e_ckpt",
                       str(tmp_path / "e4e.pt"), "--img_path", str(tmp_path / "none")])


def test_torch_styleclip_clis_need_a_card_unless_told(tmp_path):
    """``cli/mapper_train.py`` and ``cli/mapper_inference.py`` refuse
    without a card before any work (no ``exp_dir`` is made, no checkpoint
    read)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for GPU-less hosts")
    from where2edit_tpu_torch.cli import mapper_inference, mapper_train  # noqa: PLC0415

    exp = tmp_path / "exp"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mapper_train.main(["--exp_dir", str(exp), "--description", "purple hair",
                           "--stylegan_size", "8"])
    assert not exp.exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mapper_inference.main(["--exp_dir", str(exp), "--checkpoint_path",
                               str(tmp_path / "missing.pt"), "--latents_test_path",
                               str(tmp_path / "missing.pt")])

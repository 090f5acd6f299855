"""StyleGAN2 adversarial training on one card (counterpart of
where2edit_tpu/cli/train_stylegan.py), fp32.

    python -m where2edit_tpu_torch.cli.train_stylegan --synthetic 16 \\
        --size 1024 --channel_multiplier 2 --batch 8 --iter 5

Runs on CUDA unless ``--device cpu`` is given (and raises without a card).
Writes ``ckpt_<step>.pt`` under ``--results_dir`` every ``--save_every``
steps and at the end; ``--resume`` continues a checkpoint, the draws and the
real-image stream included, as an uninterrupted run would. Scalars go to
``--results_dir``/logs (``train/*`` every 10 steps; with ``--fid_every N``
the EMA generator's FID every N steps as ``eval/fid``: InceptionV3 pool3
features with ``--inception_ckpt``, else CLIP image features).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch

from where2edit_tpu_torch.eval.metrics import frechet_distance
from where2edit_tpu_torch.train.checkpoints import load_checkpoint, save_checkpoint
from where2edit_tpu_torch.train.datasets import ImageBank
from where2edit_tpu_torch.train.gan_trainer import GANTrainConfig, GANTrainer
from where2edit_tpu_torch.utils.logging import MetricsWriter


def build_fid_extract(args, device):
    """The periodic FID's feature extractor: InceptionV3 pool3 with
    ``--inception_ckpt`` (standard FID), else CLIP image features
    (CLIP-FID; with random CLIP weights it only tracks relative drift)."""
    from where2edit_tpu_torch.cli import evaluate  # noqa: PLC0415
    from where2edit_tpu_torch.cli.run_attention import load_clip  # noqa: PLC0415
    from where2edit_tpu_torch.losses.clip_loss import CLIPLoss  # noqa: PLC0415

    if args.inception_ckpt:
        return evaluate.load_fid_extract(args.inception_ckpt, device)
    if not args.clip_ckpt:
        print("[fid] no --inception_ckpt/--clip_ckpt: CLIP-FID with random "
              "weights (relative tracking only)")
    return CLIPLoss(load_clip(args.clip_ckpt, device), args.size).encode_image


def main(argv=None, span=None):
    """Returns the trainer after the last step. ``span(program, trainer)``,
    when given, is a context manager around each training program (d, r1,
    g, path, ema) and, with ``--fid_every``, around the real pool's
    features (``fid_reals``) and each FID pass (``fid``): ``chip_smoke.py``
    fences, times and counts with it."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data", type=str, default=None,
                   help="image directory | .npy | .npz of reals (N,H,W,3)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train against N uniform random images instead of --data")
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--channel_multiplier", type=int, default=2)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iter", type=int, default=800000)
    p.add_argument("--lr", type=float, default=0.002)
    p.add_argument("--r1", type=float, default=10.0)
    p.add_argument("--d_reg_every", type=int, default=16)
    p.add_argument("--g_reg_every", type=int, default=4)
    p.add_argument("--path_regularize", type=float, default=2.0)
    p.add_argument("--path_batch_shrink", type=int, default=2)
    p.add_argument("--mixing", type=float, default=0.9)
    p.add_argument("--ema_kimg", type=float, default=10.0)
    p.add_argument("--fid_every", type=int, default=0,
                   help="FID of the EMA generator every N steps (0 disables)")
    p.add_argument("--fid_n", type=int, default=1000,
                   help="samples per side of the FID estimate")
    p.add_argument("--fid_batch", type=int, default=0,
                   help="generation / extraction batch for FID (0 = --batch)")
    p.add_argument("--inception_ckpt", type=str, default=None,
                   help="torchvision-layout InceptionV3 state dict for standard FID")
    p.add_argument("--clip_ckpt", type=str, default=None,
                   help="CLIP checkpoint for CLIP-FID (used without "
                        "--inception_ckpt; random weights if omitted)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--results_dir", type=str, default="results/gan")
    p.add_argument("--save_every", type=int, default=10000)
    p.add_argument("--resume", type=str, default="",
                   help="checkpoint file written by this CLI")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; cpu runs the plain versions)")
    args = p.parse_args(argv)

    if args.synthetic:
        rng0 = np.random.default_rng(args.seed)
        bank = ImageBank(images=rng0.uniform(
            -1.0, 1.0, (args.synthetic, args.size, args.size, 3)).astype(np.float32))
    elif args.data:
        bank = ImageBank.from_path(args.data, args.size)
    else:
        raise SystemExit("one of --data/--synthetic is required")
    print(f"reals: {len(bank)} images at {args.size}px")

    cfg = GANTrainConfig(
        size=args.size, batch_size=args.batch, lr=args.lr, r1=args.r1,
        d_reg_every=args.d_reg_every, g_reg_every=args.g_reg_every,
        path_regularize=args.path_regularize,
        path_batch_shrink=args.path_batch_shrink, mixing=args.mixing,
        ema_kimg=args.ema_kimg, channel_multiplier=args.channel_multiplier,
        seed=args.seed)
    trainer = GANTrainer(cfg, device=args.device)
    start = load_checkpoint(args.resume, trainer) if args.resume else 0
    if start:
        print(f"resumed from {args.resume} at step {start}")
    rng = np.random.default_rng(args.seed + 1)
    for _ in range(start):  # the real-image stream an uninterrupted run saw
        rng.integers(0, len(bank), size=args.batch)

    metrics_writer = MetricsWriter(os.path.join(args.results_dir, "logs"))
    fid_span = span or (lambda program, trainer: contextlib.nullcontext())
    if args.fid_every:
        fid_extract = build_fid_extract(args, trainer.device)
        fb = args.fid_batch or args.batch
        n = max(((args.fid_n + fb - 1) // fb) * fb, fb)  # a multiple of fb
        fid_rng = np.random.default_rng(args.seed + 3)
        with fid_span("fid_reals", trainer), torch.no_grad():
            real_feats = np.concatenate([
                fid_extract(torch.from_numpy(bank.sample(fid_rng, fb)).to(
                    trainer.device)).cpu().numpy() for _ in range(n // fb)])
        # a fixed z pool: successive FIDs differ only through the EMA weights
        fid_z = torch.from_numpy(np.random.default_rng(args.seed + 4).standard_normal(
            (n, 512)).astype(np.float32)).to(trainer.device)

        @torch.no_grad()
        def fid_eval() -> float:
            feats = np.concatenate([
                fid_extract(trainer.g_ema([fid_z[i:i + fb]], randomize_noise=False).image
                            ).cpu().numpy() for i in range(0, n, fb)])
            return frechet_distance(real_feats, feats)

    def checkpoint(step: int) -> str:
        return save_checkpoint(os.path.join(args.results_dir, f"ckpt_{step:07d}.pt"),
                               trainer, step, vars(args))

    t0 = time.time()
    for step in range(start, args.iter):
        real = torch.from_numpy(bank.sample(rng, args.batch)).to(trainer.device)
        m = trainer.step(real, span)
        if step % 10 == 0:
            rate = args.batch * (step - start + 1) / (time.time() - t0)
            m = {k: float(v) for k, v in m.items()}
            print(f"[{step}] " + " ".join(f"{k}={v:.4f}" for k, v in m.items())
                  + f" ({rate:.2f} imgs/s)", flush=True)
            for k, v in m.items():
                metrics_writer.add_scalar(f"train/{k}", v, step)
        if args.fid_every and (step + 1) % args.fid_every == 0:
            with fid_span("fid", trainer):
                fid = fid_eval()
            print(f"[{step + 1}] fid={fid:.3f}", flush=True)
            metrics_writer.add_scalar("eval/fid", fid, step + 1)
        if args.save_every and (step + 1) % args.save_every == 0:
            print(f"checkpoint -> {checkpoint(step + 1)}")
    print(f"final checkpoint -> {checkpoint(args.iter)}")
    metrics_writer.close()
    return trainer


if __name__ == "__main__":
    main()

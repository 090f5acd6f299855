"""StyleGAN2 adversarial training on one card (counterpart of
where2edit_tpu/cli/train_stylegan.py), fp32.

    python -m where2edit_tpu_torch.cli.train_stylegan --synthetic 16 \\
        --size 1024 --channel_multiplier 2 --batch 8 --iter 5

Runs on CUDA unless ``--device cpu`` is given (and raises without a card).
Writes ``ckpt_<step>.pt`` under ``--results_dir`` every ``--save_every``
steps and at the end; ``--resume`` continues a checkpoint, the draws and the
real-image stream included, as an uninterrupted run would.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from where2edit_tpu_torch.train.checkpoints import load_checkpoint, save_checkpoint
from where2edit_tpu_torch.train.datasets import ImageBank
from where2edit_tpu_torch.train.gan_trainer import GANTrainConfig, GANTrainer


def main(argv=None, span=None):
    """Returns the trainer after the last step. ``span(program, trainer)``,
    when given, is a context manager around each training program (d, r1,
    g, path, ema): ``chip_smoke.py`` fences, times and counts with it."""
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

    def checkpoint(step: int) -> str:
        return save_checkpoint(os.path.join(args.results_dir, f"ckpt_{step:07d}.pt"),
                               trainer, step, vars(args))

    t0 = time.time()
    for step in range(start, args.iter):
        real = torch.from_numpy(bank.sample(rng, args.batch)).to(trainer.device)
        m = trainer.step(real, span)
        if step % 10 == 0:
            rate = args.batch * (step - start + 1) / (time.time() - t0)
            print(f"[{step}] " + " ".join(f"{k}={float(v):.4f}" for k, v in m.items())
                  + f" ({rate:.2f} imgs/s)", flush=True)
        if args.save_every and (step + 1) % args.save_every == 0:
            print(f"checkpoint -> {checkpoint(step + 1)}")
    print(f"final checkpoint -> {checkpoint(args.iter)}")
    return trainer


if __name__ == "__main__":
    main()

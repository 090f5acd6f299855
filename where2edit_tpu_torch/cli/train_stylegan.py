"""StyleGAN2 adversarial training, on one card or data-parallel
(counterpart of where2edit_tpu/cli/train_stylegan.py).

    python -m where2edit_tpu_torch.cli.train_stylegan --synthetic 16 \\
        --size 1024 --channel_multiplier 2 --batch 8 --iter 5 \\
        [--bf16 --d_bf16] [--remat --d_remat] [--d_microbatch 4] \\
        [--g_microbatch 8] [--workers 2 --hflip] [--ckpt g_ema.pt] [--dp N]

Runs on CUDA unless ``--device cpu`` is given (and raises without a card).
fp32 by default; ``--bf16``/``--d_bf16`` run the generator's synthesis and
the discriminator's tower in bf16 (the kernels' bf16 forms; losses,
regularisers, parameters and Adam stay fp32), ``--remat``/``--d_remat``
recompute activations in the backward pass instead of keeping them, and
``--d_microbatch``/``--g_microbatch`` accumulate the programs over chunks.
The reals are loaded on a background pipeline (``train/loader.py``,
``--workers`` decode threads), with random horizontal flips under
``--hflip``. ``--ckpt`` warm-starts
G (and its EMA) from a reference ``.pt``'s ``g_ema``. Writes
``ckpt_<step>.pt`` under ``--results_dir`` every ``--save_every`` steps and
at the end, and an EMA sample grid ``sample_<step>.jpg`` every
``--sample_every`` steps; ``--resume`` continues a checkpoint, the draws
and the real-image and flip streams included, as an uninterrupted run
would. SIGTERM writes a checkpoint at the next step boundary and exits 0.
``--dp N`` trains on N ranks, one process per card (``--device cpu``: N
gloo processes), ``--batch`` the global batch split evenly, and the step is
the one-process step on the global batch (``train/gan_trainer.py``);
``--multihost`` runs as a rank of the group ``torchrun`` describes instead
(``torchrun --nproc_per_node N -m where2edit_tpu_torch.cli.train_stylegan
--multihost ...``). Only rank 0 logs, samples, scores FID and writes
checkpoints; a SIGTERM to any rank stops every rank at the same step.
Scalars go to ``--results_dir``/logs (``train/*`` every 10 steps; with
``--fid_every N`` the EMA generator's FID every N steps as ``eval/fid``:
InceptionV3 pool3 features with ``--inception_ckpt``, else CLIP image
features).
"""

from __future__ import annotations

import argparse
import functools
import os
import time

import numpy as np
import torch

from where2edit_tpu_torch.cli.common import Preemption, add_dp_args, dp_entry
from where2edit_tpu_torch.eval.metrics import frechet_distance
from where2edit_tpu_torch.parallel import dist
from where2edit_tpu_torch.train.checkpoints import load_checkpoint, save_checkpoint
from where2edit_tpu_torch.train.datasets import ImageBank
from where2edit_tpu_torch.train.gan_trainer import GANTrainConfig, GANTrainer
from where2edit_tpu_torch.train.loader import PrefetchLoader
from where2edit_tpu_torch.utils import profiling
from where2edit_tpu_torch.utils.images import save_image_grid
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


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data", type=str, default=None,
                   help="image directory | .npy | .npz of reals (N,H,W,3)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train against N uniform random images instead of --data")
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--channel_multiplier", type=int, default=2)
    p.add_argument("--batch", type=int, default=8,
                   help="global batch (split over the --dp ranks)")
    p.add_argument("--iter", type=int, default=800000)
    p.add_argument("--lr", type=float, default=0.002)
    p.add_argument("--r1", type=float, default=10.0)
    p.add_argument("--d_reg_every", type=int, default=16)
    p.add_argument("--g_reg_every", type=int, default=4)
    p.add_argument("--path_regularize", type=float, default=2.0)
    p.add_argument("--path_batch_shrink", type=int, default=2)
    p.add_argument("--mixing", type=float, default=0.9)
    p.add_argument("--ema_kimg", type=float, default=10.0)
    p.add_argument("--workers", type=int, default=1,
                   help="decode threads of the background real-image pipeline "
                        "(at least 1)")
    p.add_argument("--prefetch", type=int, default=3,
                   help="batches the background pipeline keeps in flight")
    p.add_argument("--hflip", action="store_true",
                   help="random horizontal flips of the reals")
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
    p.add_argument("--bf16", action="store_true",
                   help="bf16 synthesis (losses and regularisers fp32)")
    p.add_argument("--remat", action="store_true",
                   help="recompute the G program's synthesis in its backward pass")
    p.add_argument("--d_bf16", action="store_true",
                   help="bf16 discriminator tower (stddev and losses fp32)")
    p.add_argument("--d_remat", action="store_true",
                   help="recompute each discriminator ResBlock in the backward pass")
    p.add_argument("--d_microbatch", type=int, default=0,
                   help="accumulate the D and R1 programs over chunks of N "
                        "samples (minibatch-stddev per chunk)")
    p.add_argument("--g_microbatch", type=int, default=0,
                   help="accumulate the G program over chunks of N samples")
    p.add_argument("--ckpt", type=str, default=None,
                   help="warm-start G from a reference .pt's g_ema (or a bare "
                        "generator state dict)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--results_dir", type=str, default="results/gan")
    p.add_argument("--save_every", type=int, default=10000)
    p.add_argument("--sample_every", type=int, default=1000,
                   help="an EMA sample grid every N steps (0 disables)")
    p.add_argument("--n_sample", type=int, default=16)
    p.add_argument("--resume", type=str, default="",
                   help="checkpoint file written by this CLI")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; cpu runs the plain versions)")
    add_dp_args(p)
    return p


def main(argv=None, span=None):
    """Returns the trainer after the last step, or None when a SIGTERM
    stopped the run (after its checkpoint) or when ``--dp`` spawned its
    ranks. ``span(program, trainer)``, when given, is a context manager
    around each training program (d, r1, g, path, ema) and, with
    ``--fid_every``, around the real pool's features (``fid_reals``) and
    each FID pass (``fid``): ``chip_smoke.py`` fences, times and counts with
    it. Without it, the tracer's ``trainer.gan.<program>`` spans."""
    args = build_argparser().parse_args(argv)
    return dp_entry(args, functools.partial(_main, span=span))


def _main(args, span=None):
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
        bf16=args.bf16, remat=args.remat, d_bf16=args.d_bf16,
        d_remat=args.d_remat, d_microbatch=args.d_microbatch,
        g_microbatch=args.g_microbatch, seed=args.seed)
    g_state = None
    if args.ckpt:
        if not os.path.isfile(args.ckpt):  # a warm start never falls back to random G
            raise SystemExit(f"--ckpt {args.ckpt}: no such file")
        from where2edit_tpu_torch.cli.common import build_generator  # noqa: PLC0415

        g_state = build_generator(args.size, args.ckpt, args.channel_multiplier,
                                  device="cpu")[0].state_dict()
    trainer = GANTrainer(cfg, device=args.device, g_state=g_state)
    start = load_checkpoint(args.resume, trainer) if args.resume else 0
    if start:
        print(f"resumed from {args.resume} at step {start}")
    rng = np.random.default_rng(args.seed + 1)
    flip_rng = np.random.default_rng(args.seed + 5)
    for _ in range(start):  # the real-image and flip streams an uninterrupted run saw
        rng.integers(0, len(bank), size=args.batch)
        if args.hflip:
            flip_rng.random(args.batch)
    sample_z = torch.from_numpy(np.random.default_rng(args.seed + 2).standard_normal(
        (args.n_sample, 512), dtype=np.float32)).to(trainer.device)

    metrics_writer = MetricsWriter(os.path.join(args.results_dir, "logs"))
    fid_span = span or profiling.stage_spans("trainer.gan")
    if args.fid_every and dist.is_main():
        fid_extract = build_fid_extract(args, trainer.device)
        fb = args.fid_batch or args.batch
        n = max(((args.fid_n + fb - 1) // fb) * fb, fb)  # a multiple of fb
        fid_rng = np.random.default_rng(args.seed + 3)

        def real_batch() -> np.ndarray:
            # the reals D sees: with --hflip the pool takes flips too
            arr = bank.sample(fid_rng, fb)
            if args.hflip:
                coins = fid_rng.random(fb) < 0.5
                arr = arr.copy()
                arr[coins] = arr[coins][:, :, ::-1, :]
            return np.ascontiguousarray(arr)

        with fid_span("fid_reals", trainer), torch.no_grad():
            real_feats = np.concatenate([
                fid_extract(torch.from_numpy(real_batch()).to(
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

    workers = max(args.workers, 1)
    loader = PrefetchLoader(bank, args.batch, rng=rng, workers=workers,
                            prefetch=args.prefetch, hflip=args.hflip,
                            flip_seed=flip_rng, device=trainer.device,
                            rank=dist.data_rank(), world=dist.data_world())
    print(f"[loader] {workers} decode threads, {args.prefetch} batches in flight"
          + (", hflip" if args.hflip else ""))

    # SIGTERM asks for a checkpoint at the next step boundary and a clean
    # exit; --resume then continues as an uninterrupted run would
    t0 = time.time()
    try:
        with Preemption("[preempt] SIGTERM: checkpointing at the next step "
                        "boundary") as preempt:
            for step in range(start, args.iter):
                if preempt():
                    print(f"[preempt] checkpoint -> {checkpoint(step)}")
                    return None
                m = trainer.step(next(loader), span)
                if step % 10 == 0:
                    rate = args.batch * (step - start + 1) / (time.time() - t0)
                    m = {k: float(v) for k, v in m.items()}
                    print(f"[{step}] " + " ".join(f"{k}={v:.4f}" for k, v in m.items())
                          + f" ({rate:.2f} imgs/s)", flush=True)
                    for k, v in m.items():
                        metrics_writer.add_scalar(f"train/{k}", v, step)
                if args.fid_every and (step + 1) % args.fid_every == 0 and dist.is_main():
                    with fid_span("fid", trainer):
                        fid = fid_eval()
                    print(f"[{step + 1}] fid={fid:.3f}", flush=True)
                    metrics_writer.add_scalar("eval/fid", fid, step + 1)
                if (args.sample_every and (step + 1) % args.sample_every == 0
                        and dist.is_main()):
                    with torch.no_grad():
                        img = trainer.g_ema([sample_z], randomize_noise=False).image
                    save_image_grid(img, os.path.join(args.results_dir,
                                                      f"sample_{step + 1:07d}.jpg"),
                                    nrow=int(round(args.n_sample ** 0.5)) or 1,
                                    scale_each=True)
                if args.save_every and (step + 1) % args.save_every == 0:
                    print(f"checkpoint -> {checkpoint(step + 1)}")
    finally:
        loader.close()
        metrics_writer.close()
    print(f"final checkpoint -> {checkpoint(args.iter)}")
    return trainer


if __name__ == "__main__":
    main()

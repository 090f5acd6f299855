"""StyleCLIP latent-mapper training CLI (counterpart of
where2edit_tpu/cli/mapper_train.py), one card.

Refuses an existing ``--exp_dir``, writes ``opt.json`` there, builds the
frozen generator, CLIP (``--clip_ckpt``, else ViT-B/32 with seeded random
weights) and, with ``--ir_se50_weights``, ArcFace IR-SE50 for the ID loss,
then runs the ``Coach``:

    python -m where2edit_tpu_torch.cli.mapper_train --exp_dir exp \\
        --description "a person with purple hair" --ir_se50_weights ir_se50.pth

Runs on CUDA unless ``--device cpu`` is given (and raises without a card).
``--checkpoint_path`` warm-starts the mapper from this CLI's checkpoint or
a reference StyleCLIP ``.pt`` (its ``mapper.*`` entries; ``decoder.*`` are
ignored); ``--resume`` restores a checkpoint of this CLI whole (mapper,
optimizer, step, shuffle position). SIGTERM leaves a ``preempt.pt``
snapshot at the next step boundary. ``--bf16`` runs the coach's syntheses
in bf16 (its losses stay fp32). The JAX CLI's ``--use_mesh`` and
``--s2d_octaves`` are not here (the first waits for DDP; the last is a TPU
layout lever).
"""

from __future__ import annotations

import argparse
import json
import os
import signal

import numpy as np
import torch

from where2edit_tpu_torch import resolve_device
from where2edit_tpu_torch.cli.common import build_generator, load_torch_state, mean_latent
from where2edit_tpu_torch.cli.run_attention import load_clip
from where2edit_tpu_torch.editing.latent_mappers import stylespace_count
from where2edit_tpu_torch.editing.styleclip_mapper import MAPPER_TYPES, build_mapper
from where2edit_tpu_torch.losses.clip_loss import CLIPLoss
from where2edit_tpu_torch.losses.id_loss import IDLoss
from where2edit_tpu_torch.models.clip_tokenizer import tokenize
from where2edit_tpu_torch.models.irse import Backbone
from where2edit_tpu_torch.models.psp import get_keys
from where2edit_tpu_torch.train.checkpoints import load_coach_checkpoint
from where2edit_tpu_torch.train.coach import Coach, CoachConfig


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--exp_dir", type=str, required=True)
    p.add_argument("--description", type=str, required=True)
    p.add_argument("--mapper_type", type=str, default="LevelsMapper",
                   choices=sorted(MAPPER_TYPES))
    p.add_argument("--no_coarse_mapper", action="store_true")
    p.add_argument("--no_medium_mapper", action="store_true")
    p.add_argument("--no_fine_mapper", action="store_true")
    p.add_argument("--work_in_stylespace", action="store_true")
    p.add_argument("--latents_train_path", type=str, default=None,
                   help="a torch W+ tensor (N, n_latent, 512) to train on")
    p.add_argument("--latents_test_path", type=str, default=None)
    p.add_argument("--train_dataset_size", type=int, default=5000)
    p.add_argument("--test_dataset_size", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--test_batch_size", type=int, default=1)
    p.add_argument("--checkpoint_path", type=str, default=None,
                   help="warm-start the mapper's weights from this CLI's "
                        "checkpoint or a reference StyleCLIP .pt")
    p.add_argument("--resume", type=str, default=None,
                   help="resume whole from this CLI's checkpoint (weights, "
                        "optimizer state, step, shuffle position), e.g. the "
                        "preempt.pt a SIGTERM leaves")
    p.add_argument("--learning_rate", type=float, default=0.5)
    p.add_argument("--optim_name", type=str, default="ranger",
                   choices=("ranger", "adam"))
    p.add_argument("--id_lambda", type=float, default=0.1)
    p.add_argument("--clip_lambda", type=float, default=1.0)
    p.add_argument("--latent_l2_lambda", type=float, default=0.8)
    p.add_argument("--stylegan_size", type=int, default=1024)
    p.add_argument("--stylegan_weights", type=str,
                   default="pretrained_models/stylegan2-ffhq-config-f.pt")
    p.add_argument("--clip_ckpt", type=str, default=None,
                   help="OpenAI CLIP state dict or TorchScript archive (.pt)")
    p.add_argument("--ir_se50_weights", type=str, default=None,
                   help="ArcFace IR-SE50 state dict (the ID loss; without it "
                        "the ID loss is off)")
    p.add_argument("--max_steps", type=int, default=50000)
    p.add_argument("--board_interval", type=int, default=50)
    p.add_argument("--image_interval", type=int, default=100)
    p.add_argument("--save_interval", type=int, default=None)
    p.add_argument("--val_interval", type=int, default=2000)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 synthesis during training (losses stay fp32)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; cpu runs the plain versions)")
    return p


def warmstart_state(path: str) -> dict:
    """The mapper's state dict in a ``--checkpoint_path`` file: the
    ``mapper.*`` entries of its ``state_dict`` (this CLI's checkpoints and
    the reference's both), or the file itself when it is a bare state
    dict."""
    ckpt = load_torch_state(path)
    return get_keys(ckpt, "mapper") if "state_dict" in ckpt else ckpt


def load_latents(path: str | None):
    return None if not path else np.asarray(load_torch_state(path), np.float32)


def main(argv=None, span=None) -> Coach:
    """Returns the trained ``Coach``. ``span(stage, coach)``, when given,
    is the coach's stage hook: ``chip_smoke.py`` fences, times and counts
    with it."""
    args = build_argparser().parse_args(argv)
    dev = resolve_device(args.device)
    if os.path.exists(args.exp_dir):
        raise FileExistsError(f"Oops... {args.exp_dir} already exists")
    os.makedirs(args.exp_dir)
    with open(os.path.join(args.exp_dir, "opt.json"), "w") as f:
        json.dump(vars(args), f, indent=4, sort_keys=True)

    gen, latent_avg = build_generator(args.stylegan_size, args.stylegan_weights,
                                      device=dev, dtype=torch.bfloat16 if args.bf16
                                      else torch.float32)
    if latent_avg is None:
        latent_avg = mean_latent(gen, torch.Generator(dev).manual_seed(0))

    mapper = build_mapper(args.mapper_type, **vars(args),
                          n_styles=stylespace_count(args.stylegan_size),
                          rng=torch.Generator().manual_seed(0))
    if args.checkpoint_path and not args.resume:
        print(f"Loading from checkpoint: {args.checkpoint_path}")
        mapper.load_state_dict(warmstart_state(args.checkpoint_path))
    mapper = mapper.to(dev)

    clip_loss = tokens = None
    if args.clip_lambda > 0:
        clip_loss = CLIPLoss(load_clip(args.clip_ckpt, dev), args.stylegan_size)
        tokens = torch.from_numpy(np.asarray(tokenize([args.description]))).long().to(dev)
    id_loss = None
    if args.id_lambda > 0 and args.ir_se50_weights:
        facenet = Backbone.from_state_dict(load_torch_state(args.ir_se50_weights),
                                           input_size=112, drop_ratio=0.6)
        id_loss = IDLoss(facenet.to(dev))
    elif args.id_lambda > 0:
        print("[warn] id_lambda > 0 but no --ir_se50_weights; disabling IDLoss")

    cfg = CoachConfig(
        exp_dir=args.exp_dir, description=args.description,
        mapper_type=args.mapper_type, work_in_stylespace=args.work_in_stylespace,
        batch_size=args.batch_size, test_batch_size=args.test_batch_size,
        train_dataset_size=args.train_dataset_size,
        test_dataset_size=args.test_dataset_size,
        learning_rate=args.learning_rate, optim_name=args.optim_name,
        id_lambda=args.id_lambda if id_loss else 0.0,
        clip_lambda=args.clip_lambda if clip_loss else 0.0,
        latent_l2_lambda=args.latent_l2_lambda,
        stylegan_size=args.stylegan_size, max_steps=args.max_steps,
        board_interval=args.board_interval, image_interval=args.image_interval,
        save_interval=args.save_interval, val_interval=args.val_interval)
    coach = Coach(cfg, generator=gen, mapper=mapper, clip_loss=clip_loss,
                  id_loss=id_loss, latent_avg=latent_avg, text_tokens=tokens,
                  train_latents=load_latents(args.latents_train_path),
                  test_latents=load_latents(args.latents_test_path),
                  opts=vars(args), span=span)
    if args.resume:
        step = load_coach_checkpoint(args.resume, coach)
        print(f"resumed from {args.resume}; continuing at step {step}")

    # SIGTERM asks for a stop at the next step boundary, then a snapshot
    stop = {"flag": False}

    def _on_sigterm(signum, frame):
        stop["flag"] = True
        print("[preempt] SIGTERM — snapshotting at the next step boundary")

    prev = signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        result = coach.train(stop_fn=lambda: stop["flag"])
    finally:
        signal.signal(signal.SIGTERM, prev)
        coach.metrics.close()
    if result == "preempted":
        print(f"[preempt] snapshot → "
              f"{os.path.join(cfg.exp_dir, 'checkpoints', 'preempt.pt')}")
    return coach


if __name__ == "__main__":
    main()

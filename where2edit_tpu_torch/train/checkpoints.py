"""Training checkpoints, one ``torch.save`` file each, holding the state of
the trainer's draw generator, so a resumed run draws what an uninterrupted
one would. Adversarial training's: G, D, the EMA generator, both optimizer
states, ``pl_mean`` and the step. Region-attention training's: the mapper,
Adam's state and the step."""

from __future__ import annotations

import os

import torch


def save_checkpoint(path: str, trainer, step: int, opts: dict | None = None) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"g": trainer.g.state_dict(), "d": trainer.d.state_dict(),
                "g_ema": trainer.g_ema.state_dict(),
                "g_opt": trainer.g_opt.state_dict(),
                "d_opt": trainer.d_opt.state_dict(),
                "pl_mean": trainer.pl_mean, "step": step,
                "rng": trainer.rng.get_state(), "opts": opts or {}}, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, trainer) -> int:
    """Restore ``trainer`` from ``path``; returns the step to continue at."""
    ckpt = torch.load(path, map_location=trainer.device, weights_only=True)
    trainer.g.load_state_dict(ckpt["g"])
    trainer.d.load_state_dict(ckpt["d"])
    trainer.g_ema.load_state_dict(ckpt["g_ema"])
    trainer.g_opt.load_state_dict(ckpt["g_opt"])
    trainer.d_opt.load_state_dict(ckpt["d_opt"])
    trainer.pl_mean = ckpt["pl_mean"].to(trainer.device)
    trainer.rng.set_state(ckpt["rng"].cpu())
    trainer.global_step = int(ckpt["step"])
    return trainer.global_step


def save_mapper_checkpoint(path: str, trainer, step: int,
                           opts: dict | None = None) -> str:
    """One ``torch.save`` file of region-attention training, written
    atomically: the mapper's state dict (the reference's keys), Adam's
    state, the step, the draw generator's state and ``opts``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"mapper": trainer.mapper.state_dict(),
                "adam": trainer.opt.state_dict(), "step": step,
                "rng": trainer.rng.get_state(), "opts": opts or {}}, tmp)
    os.replace(tmp, path)
    return path


def load_mapper_checkpoint(path: str, trainer) -> int:
    """Restore ``trainer`` from a file ``save_mapper_checkpoint`` wrote;
    returns the step to continue at. A bare mapper state dict restores the
    mapper alone and returns 0."""
    ckpt = torch.load(path, map_location=trainer.device, weights_only=True)
    if "mapper" not in ckpt:
        trainer.mapper.load_state_dict(ckpt)
        return 0
    trainer.mapper.load_state_dict(ckpt["mapper"])
    trainer.opt.load_state_dict(ckpt["adam"])
    trainer.rng.set_state(ckpt["rng"].cpu())
    trainer.draws_taken = trainer.steps_completed = int(ckpt["step"])
    return trainer.steps_completed

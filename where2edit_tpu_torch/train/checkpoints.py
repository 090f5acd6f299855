"""Checkpoints of adversarial training: one ``torch.save`` file holding
G, D, the EMA generator, both optimizer states, ``pl_mean``, the step and
the state of the trainer's draw generator, so a resumed run draws what an
uninterrupted one would."""

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

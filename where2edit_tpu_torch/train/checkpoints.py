"""Training checkpoints, one ``torch.save`` file each, holding the state of
the trainer's draw generator, so a resumed run draws what an uninterrupted
one would. Adversarial training's: G, D, the EMA generator, both optimizer
states, ``pl_mean`` and the step. Region-attention training's: the mapper,
Adam's state and the step. The StyleCLIP coach's: the mapper under the
reference coach's ``state_dict`` / ``mapper.`` layout, the optimizer's
state, the step and the shuffle order's position.

In a data-parallel group only rank 0 writes, and every rank waits at a
barrier until the file is in place; every rank loads on ``--resume``. Each
file is staged under a name of the writing process's own (``.tmp.<pid>``)
and renamed into place, so two writers never share a staging file."""

from __future__ import annotations

import os

import torch

from where2edit_tpu_torch.models.psp import get_keys
from where2edit_tpu_torch.parallel.dist import barrier, is_main


def _write(path: str, make_state) -> str:
    """``make_state()`` saved to ``path`` by rank 0, atomically; every rank
    returns once the file is there."""
    if is_main():
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        torch.save(make_state(), tmp)
        os.replace(tmp, path)
    barrier()
    return path


def save_checkpoint(path: str, trainer, step: int, opts: dict | None = None) -> str:
    return _write(path, lambda: {
        "g": trainer.g.state_dict(), "d": trainer.d.state_dict(),
        "g_ema": trainer.g_ema.state_dict(), "g_opt": trainer.g_opt.state_dict(),
        "d_opt": trainer.d_opt.state_dict(), "pl_mean": trainer.pl_mean,
        "step": step, "rng": trainer.rng.get_state(), "opts": opts or {}})


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
    return _write(path, lambda: {
        "mapper": trainer.mapper.state_dict(), "adam": trainer.opt.state_dict(),
        "step": step, "rng": trainer.rng.get_state(), "opts": opts or {}})


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


def save_coach_checkpoint(path: str, coach) -> str:
    """One ``torch.save`` file of StyleCLIP mapper training, written
    atomically: ``state_dict`` (the mapper's keys under ``mapper.``, as the
    reference coach saves them, so its ``get_keys(ckpt, "mapper")`` reads
    the file), ``opts``, the optimizer's state, ``step``, the best
    validation loss, the draw generator's state, and the shuffle
    generator's state at the start of the current epoch with the batches
    of it already taken (``epoch_pos``)."""
    return _write(path, lambda: {
        "state_dict": {f"mapper.{k}": v for k, v in coach.mapper.state_dict().items()},
        "opts": coach.opts, "optimizer": coach.opt.state_dict(),
        "step": coach.global_step, "best_val_loss": coach.best_val_loss,
        "draw_rng": coach.draw_rng.get_state(), "shuffle_rng": coach.epoch_rng_state(),
        "epoch_pos": coach.epoch_pos})


def load_coach_checkpoint(path: str, coach) -> int:
    """Restore ``coach`` from a file ``save_coach_checkpoint`` wrote;
    returns the step to continue at."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    coach.mapper.load_state_dict(get_keys(ckpt, "mapper"))
    coach.opt.load_state_dict(ckpt["optimizer"])
    coach.best_val_loss = ckpt["best_val_loss"]
    coach.draw_rng.set_state(ckpt["draw_rng"])
    coach.shuffle_rng.set_state(ckpt["shuffle_rng"])
    coach.epoch_pos = int(ckpt["epoch_pos"])
    coach.global_step = int(ckpt["step"])
    return coach.global_step

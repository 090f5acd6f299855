"""Shared CLI plumbing (counterpart of where2edit_tpu/cli/common.py):
checkpoint loading, the generator, the mean latent, pickles and the source
snapshot of a run."""

from __future__ import annotations

import os
import pickle
import shutil

import numpy as np
import torch

from where2edit_tpu_torch.models.stylegan2 import Generator


def load_torch_state(path: str):
    """``torch.load`` onto the CPU; returns the raw object. Full unpickling
    (pSp / e4e checkpoints carry their training options), so the file must
    be one the operator trusts."""
    return torch.load(path, map_location="cpu", weights_only=False)


def snapshot_sources(output_dir: str) -> str:
    """Copy the package's sources into the run directory (the reference
    copies its scripts per run); build outputs are left out."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code_dir = os.path.join(output_dir, "code", "where2edit_tpu_torch")
    shutil.copytree(pkg_root, code_dir, dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc", "*.so",
                                                  "_build"))
    return code_dir


def build_generator(size: int, ckpt_path: str | None,
                    channel_multiplier: int = 2, device=None, seed: int = 0):
    """(generator on ``device``, latent_avg or None): the ``g_ema`` of
    ``ckpt_path`` (or the whole file as a state dict) when that file exists,
    else seeded random weights drawn on the CPU."""
    gen = Generator(size, channel_multiplier=channel_multiplier,
                    rng=torch.Generator().manual_seed(seed))
    latent_avg = None
    if ckpt_path and os.path.isfile(ckpt_path):
        ckpt = load_torch_state(ckpt_path)
        gen.load_state_dict(ckpt.get("g_ema", ckpt))
        if ckpt.get("latent_avg") is not None:
            latent_avg = torch.as_tensor(ckpt["latent_avg"]).float().to(device)
    return gen.to(device).eval(), latent_avg


def mean_latent(gen, rng: torch.Generator, n: int = 4096) -> torch.Tensor:
    """(1, 512) mean of ``n`` mapped z drawn from ``rng``."""
    with torch.no_grad():
        return gen.mean_latent(n, rng)


def save_pickle(obj, path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_cluster_centers(path: str) -> np.ndarray:
    """k-means centres from a pickle (numpy, or a tensor) → float32 numpy."""
    with open(path, "rb") as f:
        centers = pickle.load(f)
    if hasattr(centers, "numpy"):
        centers = centers.numpy()
    return np.asarray(centers, dtype=np.float32)

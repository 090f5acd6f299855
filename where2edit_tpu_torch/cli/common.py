"""Shared CLI plumbing (counterpart of where2edit_tpu/cli/common.py)."""

from __future__ import annotations

import torch


def load_torch_state(path: str):
    """``torch.load`` onto the CPU; returns the raw object. Full unpickling
    (pSp / e4e checkpoints carry their training options), so the file must
    be one the operator trusts."""
    return torch.load(path, map_location="cpu", weights_only=False)

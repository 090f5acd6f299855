"""Seeding (counterpart of where2edit_tpu/utils/seed.py): seeds the host's
``random`` and numpy, and returns a ``torch.Generator`` on the device for
every draw the caller makes there."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_random_seed(seed: int, device="cpu") -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator(device).manual_seed(seed)

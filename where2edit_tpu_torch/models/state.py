"""Loading a checkpoint into a model built on the meta device."""

from __future__ import annotations

import torch
from torch import nn


def assign_state(model: nn.Module, state_dict: dict) -> nn.Module:
    """Load ``state_dict`` strictly into a ``model`` built on the meta
    device (its tensors are taken, float ones as float32), with zero
    ``num_batches_tracked`` counters where the dict has none."""
    sd = {k: (v.float() if v.is_floating_point() else v)
          for k, v in ((k, torch.as_tensor(v)) for k, v in state_dict.items())}
    for k in model.state_dict():
        if k.endswith("num_batches_tracked") and k not in sd:
            sd[k] = torch.zeros((), dtype=torch.long)
    model.load_state_dict(sd, assign=True)
    return model

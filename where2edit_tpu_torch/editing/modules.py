"""Shared editing-layer modules (counterpart of
where2edit_tpu/editing/modules.py): the reference's ``utils.py`` helpers
that the ablation mappers build on.

Every random draw takes an explicit ``torch.Generator`` (on the tensor's
device) and goes through ``normal`` / ``uniform`` below, so a caller that
needs given numbers (a parity test) replaces those two functions.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from where2edit_tpu_torch.editing.clustering import pairwise_distance

__all__ = ["pairwise_distance", "normal", "uniform", "Multiply", "AddNoise",
           "sample_gumbel", "GumbelSoftmax", "GLU", "CANet", "kl_loss"]


def normal(shape, rng: torch.Generator | None, like: torch.Tensor) -> torch.Tensor:
    """Standard normal draws of ``shape`` on ``like``'s device and dtype."""
    return torch.randn(shape, generator=rng, device=like.device, dtype=like.dtype)


def uniform(shape, rng: torch.Generator | None, like: torch.Tensor) -> torch.Tensor:
    """Uniform [0, 1) draws of ``shape`` on ``like``'s device and dtype."""
    return torch.rand(shape, generator=rng, device=like.device, dtype=like.dtype)


class Multiply(nn.Module):
    def __init__(self, scale: float = 1.0):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return x * self.scale


class AddNoise(nn.Module):
    """Gaussian jitter of ``sigma`` in training only."""

    def __init__(self, sigma: float = 1.0):
        super().__init__()
        self.sigma = sigma

    def forward(self, x, train: bool = False, rng: torch.Generator | None = None):
        if not train:
            return x
        return x + normal(x.shape, rng, x) * self.sigma


def sample_gumbel(shape, rng: torch.Generator | None, like: torch.Tensor,
                  eps: float = 1e-20) -> torch.Tensor:
    u = uniform(shape, rng, like)
    return -torch.log(-torch.log(u + eps) + eps)


class GumbelSoftmax(nn.Module):
    """A soft Gumbel sample in training, its hard one-hot otherwise (the
    noise is drawn in both, as the reference does)."""

    def __init__(self, temperature: float = 1.0):
        super().__init__()
        self.temperature = temperature

    def forward(self, x, train: bool = False, rng: torch.Generator | None = None):
        y = torch.softmax((x + sample_gumbel(x.shape, rng, x)) / self.temperature,
                          dim=-1)
        if train:
            return y
        return F.one_hot(y.argmax(dim=-1), x.shape[-1]).to(x.dtype)


class GLU(nn.Module):
    """The first half of the last axis gated by the sigmoid of the second."""

    def forward(self, x):
        nc = x.shape[-1] // 2
        return x[..., :nc] * torch.sigmoid(x[..., nc:])


class CANet(nn.Module):
    """Text conditioning with the VAE reparametrisation: ``fc`` (the
    reference's ``nn.Linear``, key ``fc.*``) then GLU gives (mu, logvar);
    training draws ``mu + eps·std``, inference returns ``mu``."""

    def __init__(self, t_dim: int, c_dim: int, rng: torch.Generator | None = None):
        super().__init__()
        self.c_dim = c_dim
        self.fc = nn.Linear(t_dim, c_dim * 4)
        with torch.no_grad():  # lecun normal, as the JAX Dense
            self.fc.weight.copy_(torch.randn(c_dim * 4, t_dim, generator=rng)
                                 / math.sqrt(t_dim))
            self.fc.bias.zero_()

    def forward(self, text_embedding, train: bool = True,
                rng: torch.Generator | None = None):
        x = GLU()(self.fc(text_embedding))
        mu, logvar = x[..., :self.c_dim], x[..., self.c_dim:]
        std = torch.exp(0.5 * logvar)
        eps = normal(std.shape, rng, std) if train else torch.zeros_like(std)
        return mu + eps * std, mu, logvar


def kl_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    kld = 1.0 + logvar - mu.square() - torch.exp(logvar)
    return -0.5 * kld.mean()

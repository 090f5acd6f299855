"""ArcFace identity loss (counterpart of where2edit_tpu/losses/id_loss.py)."""

from __future__ import annotations

import torch

from where2edit_tpu_torch.ops.interpolate import adaptive_avg_pool


class IDLoss:
    """``facenet``: a ``models.irse.Backbone`` at input size 112."""

    def __init__(self, facenet):
        self.facenet = facenet

    def extract_feats(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) → L2-normalised (B, 512): pool to 256², crop the face
        box [35:223, 32:220], pool to 112²."""
        if x.shape[1] != 256:
            x = adaptive_avg_pool(x, 256)
        x = x[:, 35:223, 32:220, :]
        return self.facenet(adaptive_avg_pool(x, 112))

    def __call__(self, y_hat: torch.Tensor, y: torch.Tensor):
        """(mean(1 − cos(y_hat, y)), 0.0); no gradient reaches ``y``."""
        y_feats = self.extract_feats(y).detach()
        y_hat_feats = self.extract_feats(y_hat)
        return (1.0 - (y_hat_feats * y_feats).sum(-1)).mean(), 0.0

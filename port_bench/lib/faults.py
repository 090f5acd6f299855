"""Faults planted in the reference put in the program's place, read by the
controls: each must come out as not correct."""

from __future__ import annotations

from port_bench.reference import attention as ref_att
from port_bench.reference import gan as ref_gan


class GanHalfBatch(ref_gan.Trainer):
    """Half of the batch left out: the discriminator's outputs of the first
    half only, so every loss is the mean over the rest."""

    def _d(self, x, params=None):
        out = super()._d(x, params)
        return out[: out.shape[0] // 2]


class AttentionHalfBatch(ref_att.Trainer):
    """Half of the batch left out: InfoNCE and the perceptual loss over the
    first half of the edited batch only."""

    def _losses(self, img, img2, cond):
        half = img.shape[0] // 2
        return super()._losses(img[:half], img2, cond[:half])


# by driver, then by the name ``control.py --fault`` takes
TRAINERS = {"gan_train": {"half_batch": GanHalfBatch},
            "attention_train": {"half_batch": AttentionHalfBatch}}

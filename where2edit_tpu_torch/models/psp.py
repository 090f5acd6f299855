"""pSp composite: encoder + StyleGAN2 decoder + 256² face pool
(counterpart of where2edit_tpu/models/psp.py).

``PSp`` is an ``nn.Module`` whose state dict is a pSp / e4e checkpoint's
``state_dict`` (``encoder.*``, ``decoder.*``); ``from_state_dict`` splits
those prefixes as the reference's ``get_keys`` does and takes the
checkpoint's ``latent_avg`` (``(n_latent, 512)`` in e4e checkpoints, or
``(512,)``). ``encode`` is the tracer's span ``psp.encode``
(``utils/profiling.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from where2edit_tpu_torch import resolve_device
from where2edit_tpu_torch.models.encoders import (
    BackboneEncoderUsingLastLayerIntoW,
    Encoder4Editing,
    GradualStyleEncoder,
)
from where2edit_tpu_torch.models.stylegan2 import Generator
from where2edit_tpu_torch.ops.interpolate import adaptive_avg_pool
from where2edit_tpu_torch.utils import profiling

ENCODER_TYPES = {
    "GradualStyleEncoder": (GradualStyleEncoder, "gradual"),
    "Encoder4Editing": (Encoder4Editing, "e4e"),
    "SingleStyleCodeEncoder": (BackboneEncoderUsingLastLayerIntoW, "w"),
}


def get_keys(d: dict, name: str) -> dict:
    """The entries of ``d`` (or of its ``state_dict``) under ``name.``,
    with the prefix removed."""
    if "state_dict" in d:
        d = d["state_dict"]
    return {k[len(name) + 1:]: v for k, v in d.items()
            if k[: len(name)] == name}


class PSp(nn.Module):
    def __init__(self, encoder: nn.Module, decoder: Generator,
                 latent_avg: Optional[torch.Tensor] = None,
                 start_from_latent_avg: bool = True):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.latent_avg = latent_avg
        self.start_from_latent_avg = start_from_latent_avg

    @property
    def device(self) -> torch.device:
        return self.decoder.device

    @classmethod
    def from_state_dict(cls, ckpt: dict, *, stylegan_size: int = 1024,
                        encoder_type: str = "Encoder4Editing",
                        device: str | torch.device | None = None) -> "PSp":
        """A pSp / e4e checkpoint dict -> ``PSp`` on ``device`` (CUDA unless
        the caller names another). Every encoder and decoder entry must
        load; ``latent_avg`` may be absent."""
        dev = resolve_device(device)
        enc_cls, _ = ENCODER_TYPES[encoder_type]
        with torch.device("meta"):  # no weights drawn: the checkpoint's go in
            encoder = enc_cls(stylegan_size=stylegan_size)
        encoder.load_state_dict(get_keys(ckpt, "encoder"), assign=True)
        decoder = Generator(stylegan_size)
        decoder.load_state_dict(get_keys(ckpt, "decoder"))
        avg = ckpt.get("latent_avg")
        if avg is not None:
            avg = torch.as_tensor(avg, dtype=torch.float32).to(dev)
        return cls(encoder, decoder, avg).to(dev).eval()

    @profiling.spanned("psp.encode")
    @torch.no_grad()
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 256, 256, 3) in [-1, 1] -> W+ (B, n_latent, 512), the
        latent average added."""
        codes = self.encoder(x)
        if self.start_from_latent_avg and self.latent_avg is not None:
            codes = codes + (self.latent_avg[None] if self.latent_avg.ndim == 2
                             else self.latent_avg)
        return codes

    @torch.no_grad()
    def forward(self, x: torch.Tensor, *, resize: bool = True,
                latent_mask=None, input_code: bool = False,
                inject_latent: Optional[torch.Tensor] = None,
                return_latents: bool = False, alpha: Optional[float] = None,
                randomize_noise: bool = False):
        """Encode (or take codes with ``input_code``), optionally overwrite
        the rows in ``latent_mask`` (with ``inject_latent``, blended by
        ``alpha``, or with 0), decode, and face-pool to 256²."""
        codes = x if input_code else self.encode(x)
        if latent_mask is not None:
            codes = codes.clone()
            for i in latent_mask:
                if inject_latent is None:
                    codes[:, i] = 0.0
                elif alpha is None:
                    codes[:, i] = inject_latent[:, i]
                else:
                    codes[:, i] = (alpha * inject_latent[:, i]
                                   + (1 - alpha) * codes[:, i])
        out = self.decoder([codes], input_is_latent=not input_code,
                           randomize_noise=randomize_noise,
                           return_latents=True)
        images = adaptive_avg_pool(out.image, 256) if resize else out.image
        if return_latents:
            return images, out.latent, out.style_vector
        return images

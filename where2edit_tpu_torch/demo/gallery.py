"""Provided-faces gallery, the demo's Real-mode default (counterpart of
where2edit_tpu/demo/gallery.py). Sources, in order:

  1. ``celebs_path``: a torch file of W+ latents (a dict name → (L, 512) /
     (1, L, 512) tensor, or one (N, L, 512) tensor, named "Celeb 1" …);
  2. ``images_dir``: face images, inverted with the e4e encoder on first
     selection;
  3. built-in: faces sampled from fixed seeds by the session's own
     generator (only when neither of the above gives a face).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

IMG_EXTS = (".png", ".jpg", ".jpeg", ".webp")


def read_face_images(paths) -> torch.Tensor:
    """Image files -> (B, 256, 256, 3) float32 in [-1, 1], each converted to
    RGB and resized to 256² by Pillow's default filter (bicubic). Pillow is
    imported here, so the rest of the port runs without it."""
    try:
        from PIL import Image  # noqa: PLC0415
    except ImportError as e:
        raise RuntimeError("reading image files needs Pillow, which is not "
                           "installed; pass W+ latents (--latent) instead") from e
    faces = []
    for path in paths:
        with Image.open(path) as img:
            rgb = img.convert("RGB").resize((256, 256))
        faces.append(np.asarray(rgb, np.float32) / 127.5 - 1.0)
    return torch.from_numpy(np.stack(faces))


class CelebGallery:
    """Named faces that load into an ``EditSession`` without an upload."""

    def __init__(self, session, *, celebs_path: Optional[str] = None,
                 images_dir: Optional[str] = None, psp=None,
                 n_builtin: int = 5, builtin_seed: int = 1000):
        self.session = session
        self.psp = psp
        self._latents = {}        # name -> (1, L, 512) W+
        self._image_paths = {}    # name -> image file, inverted on selection
        self._builtin = {}        # name -> seed
        if celebs_path:
            self._load_latent_pack(celebs_path)
        if images_dir and os.path.isdir(images_dir):
            for fn in sorted(os.listdir(images_dir)):
                if fn.lower().endswith(IMG_EXTS):
                    self._image_paths[os.path.splitext(fn)[0]] = \
                        os.path.join(images_dir, fn)
        if not self._latents and not self._image_paths:
            for i in range(n_builtin):
                self._builtin[f"Celeb {i + 1}"] = builtin_seed + i

    def _load_latent_pack(self, path: str) -> None:
        # a pack holds tensors only, so the safe loader reads it
        pack = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(pack, dict):
            items = pack.items()
        else:
            items = ((f"Celeb {i + 1}", pack[i]) for i in range(len(pack)))
        for name, w in items:
            w = torch.as_tensor(w).detach().float()
            self._latents[str(name)] = w[None] if w.ndim == 2 else w

    def names(self) -> list:
        return (list(self._latents) + list(self._image_paths)
                + list(self._builtin))

    def load(self, name: str) -> torch.Tensor:
        """Load the named face into the session; returns its image."""
        if name in self._latents:
            return self.session.load_latent(self._latents[name])
        if name in self._image_paths:
            if self.psp is None:
                raise RuntimeError(f"gallery image {name!r} needs an e4e "
                                   "encoder (--e4e_ckpt) to invert")
            x = read_face_images([self._image_paths[name]])
            return self.session.load_latent(self.psp.encode(x.to(self.psp.device)))
        if name in self._builtin:
            return self.session.load_synthetic(self._builtin[name])
        raise KeyError(f"unknown gallery entry {name!r}; "
                       f"available: {self.names()}")

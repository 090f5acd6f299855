"""Real images for adversarial training and CelebAMask-HQ's labelled test
pairs (the ``ImageBank`` and ``CelebAMaskHQ`` of
where2edit_tpu/train/datasets.py, copied: the port imports nothing of the
JAX package). Host-side numpy; the trainer moves each batch to its device."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


class ImageBank:
    """Host-side real-image source (NHWC, [-1, 1]) backed by a directory of
    images (decoded per sampled batch), a .npy (memory-mapped) or .npz array
    (N, H, W, 3) of uint8 or float, or an in-memory array.

    ``sample(rng, batch)`` returns a float32 (batch, size, size, 3) array in
    [-1, 1].
    """

    _EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")

    def __init__(self, images: Optional[np.ndarray] = None,
                 paths: Optional[list] = None, size: Optional[int] = None):
        if (images is None) == (paths is None):
            raise ValueError("exactly one of images/paths")
        self.images = images
        self.paths = paths
        self.size = size

    @classmethod
    def from_path(cls, path: str, size: int) -> "ImageBank":
        if os.path.isdir(path):
            paths = sorted(
                os.path.join(path, f) for f in os.listdir(path)
                if f.lower().endswith(cls._EXTS))
            if not paths:
                raise FileNotFoundError(f"no images under {path}")
            return cls(paths=paths, size=size)
        if path.endswith(".npz"):
            data = np.load(path)
            arr = data[list(data.keys())[0]]
        elif path.endswith(".npy"):
            arr = np.load(path, mmap_mode="r")
        else:
            raise ValueError(f"unsupported data path {path} (dir | .npy | .npz)")
        return cls(images=arr, size=size)

    def __len__(self):
        return len(self.paths) if self.paths is not None else len(self.images)

    def _normalize(self, arr: np.ndarray) -> np.ndarray:
        arr = np.asarray(arr, np.float32)
        if arr.max() > 1.5:  # uint8-range pixels
            arr = arr / 127.5 - 1.0
        return arr

    def _load_one(self, i: int) -> np.ndarray:
        if self.paths is not None:
            from PIL import Image  # noqa: PLC0415

            img = Image.open(self.paths[i]).convert("RGB")
            if self.size and img.size != (self.size, self.size):
                img = img.resize((self.size, self.size), Image.BILINEAR)
            return self._normalize(np.asarray(img, np.float32))
        img = self._normalize(self.images[i])
        if self.size and img.shape[0] != self.size:
            from PIL import Image  # noqa: PLC0415

            u8 = ((img + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
            img = self._normalize(np.asarray(
                Image.fromarray(u8).resize((self.size, self.size),
                                           Image.BILINEAR), np.float32))
        return img

    def sample(self, rng: np.random.Generator, batch: int) -> np.ndarray:
        idx = rng.integers(0, len(self), size=batch)
        return np.stack([self._load_one(int(i)) for i in idx])


class CelebAMaskHQ:
    """CelebAMask-HQ test pairs ``{i}.jpg`` (under ``img_path``) and
    ``{i}.png`` (under ``label_path``), one per file of ``img_path``;
    ``load(i, img_size, label_size)`` reads one as arrays (Pillow is
    imported there)."""

    def __init__(self, img_path: str, label_path: str):
        self.pairs = []
        if not os.path.isdir(img_path):
            return
        n = len([f for f in os.listdir(img_path)
                 if os.path.isfile(os.path.join(img_path, f))])
        for i in range(n):
            self.pairs.append((os.path.join(img_path, f"{i}.jpg"),
                               os.path.join(label_path, f"{i}.png")))

    def __len__(self):
        return len(self.pairs)

    def load(self, i: int, img_size: int = 256, label_size: Optional[int] = None):
        """(image (img_size, img_size, 3) float32 in [-1, 1], label int64
        resized NEAREST to ``label_size`` when given)."""
        from PIL import Image  # noqa: PLC0415

        img_p, lbl_p = self.pairs[i]
        img = Image.open(img_p).convert("RGB").resize((img_size, img_size))
        img_arr = np.asarray(img, np.float32) / 127.5 - 1.0
        lbl = Image.open(lbl_p)
        if label_size:
            lbl = lbl.resize((label_size, label_size), Image.NEAREST)
        return img_arr, np.asarray(lbl).astype(np.int64)

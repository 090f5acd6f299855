"""Attention-region mIoU against CelebAMask-HQ (counterpart of
where2edit_tpu/eval/iou.py): each test photo is inverted, the mapper
predicts a map for each of 8 fixed region prompts, and the binarised maps
are compared with the photo's labels remapped to 8 regions."""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from where2edit_tpu_torch.editing.masks import binarize_for_iou
from where2edit_tpu_torch.train.corpus import IOU_PROMPTS

# 13 CelebAMask classes → 8 region ids
_LABEL_REMAP = {1: 1, 2: 2, 4: 3, 5: 3, 6: 4, 7: 4, 8: 5, 9: 5,
                10: 6, 11: 7, 12: 7, 13: 8}


def remap_celeba_labels(label: np.ndarray) -> np.ndarray:
    """(H, W) raw class ids → (8, H, W) one-hot region planes."""
    out = np.zeros((8, *label.shape), np.float32)
    for src, dst in _LABEL_REMAP.items():
        out[dst - 1][label == src] = 1.0
    return out


def attention_with_text(mapper_apply: Callable, text_features, latent,
                        feature_map, attention_layer: int) -> torch.Tensor:
    """The binarised attention map (B, S, S, 1) of one prompt, at the
    resolution of tap ``attention_layer - 1``."""
    blend_size = feature_map[attention_layer - 1].shape[1]
    mo = mapper_apply(text_features, latent, feature_map, blend_size)
    return binarize_for_iou(mo.attention_map)


def jaccard(pred: np.ndarray, true: np.ndarray):
    """Per-class and macro IoU over flattened binary planes (N, C)."""
    per_class = []
    for c in range(pred.shape[1]):
        inter = np.logical_and(pred[:, c] > 0.5, true[:, c] > 0.5).sum()
        union = np.logical_or(pred[:, c] > 0.5, true[:, c] > 0.5).sum()
        per_class.append(inter / union if union else 0.0)
    return np.asarray(per_class), float(np.mean(per_class))


@torch.no_grad()
def calculate_iou(*, invert_fn: Callable, features_fn: Callable,
                  mapper_apply: Callable, encode_text: Callable,
                  tokenizer: Callable, attention_layer: int,
                  image_label_pairs: Sequence, limit: int = 90):
    """Invert each image (``invert_fn(img) -> latent``), capture its taps
    (``features_fn(latent)``), predict the 8 region prompts' maps and score
    them against the remapped labels. Returns (per-class IoU, macro IoU)."""
    text_feats = [encode_text(tokenizer([t])) for t in IOU_PROMPTS]
    preds, trues = [], []
    for i, (img, label) in enumerate(image_label_pairs):
        if i == limit:
            break
        latent = invert_fn(img)
        feats = features_fn(latent)
        planes = [attention_with_text(mapper_apply, tf, latent, feats,
                                      attention_layer)[..., 0].cpu().numpy()
                  for tf in text_feats]
        preds.append(np.stack(planes, axis=1))          # (1, 8, S, S)
        trues.append(remap_celeba_labels(np.asarray(label))[None])
    pred = np.concatenate(preds).transpose(0, 2, 3, 1).reshape(-1, 8)
    true = np.concatenate(trues).transpose(0, 2, 3, 1).reshape(-1, 8)
    return jaccard(pred, true)

"""FID / IS statistics and the edit-quality sweep (counterpart of
where2edit_tpu/eval/metrics.py).

The statistics are numpy in float64, a copy of the JAX package's (the port
imports nothing of it): an eigendecomposition square root, no scipy.
``EditEvaluator`` runs on tensors: random-prompt edits, scored by CLIP
(does the edit move the image towards its prompt), an identity extractor
(ArcFace cosine between original and edit) and the Fréchet distance
between the feature pools of the edited and the original images. In a
data-parallel group each rank edits its rows of every batch; the counts
are summed over the ranks and the pools gathered to rank 0 in the
one-process order, which alone scores them.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from where2edit_tpu_torch.parallel import dist
from where2edit_tpu_torch.utils import profiling


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Symmetric PSD matrix square root via eigendecomposition."""
    vals, vecs = np.linalg.eigh(mat)
    vals = np.clip(vals, 0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    """FID between two feature sets (N, D)."""
    mu_a, mu_b = feats_a.mean(0), feats_b.mean(0)
    cov_a = np.cov(feats_a, rowvar=False)
    cov_b = np.cov(feats_b, rowvar=False)
    # tr(A + B - 2(A^1/2 B A^1/2)^1/2)
    a_half = _sqrtm_psd(cov_a)
    cross = _sqrtm_psd(a_half @ cov_b @ a_half)
    diff = mu_a - mu_b
    return float(diff @ diff + np.trace(cov_a + cov_b - 2 * cross))


def inception_score_from_probs(probs: np.ndarray, splits: int = 10) -> float:
    """IS from class-probability rows (N, C)."""
    scores = []
    n = len(probs)
    for part in np.array_split(probs[: n - n % splits] if n >= splits
                               else probs, min(splits, n)):
        marginal = part.mean(0, keepdims=True)
        kl = part * (np.log(part + 1e-10) - np.log(marginal + 1e-10))
        scores.append(np.exp(kl.sum(1).mean()))
    return float(np.mean(scores))


def _cos(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a / torch.linalg.norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.norm(b, dim=-1, keepdim=True)
    return (a * b).sum(-1)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


class EditEvaluator:
    """Random-prompt edit sweep collecting the ID cosine, the CLIP
    improvement and the edited/original feature pools for FID.

    ``edit_fn(seed, text_features) -> (orig, gen)`` edits the faces of one
    iteration (NHWC in [-1, 1]); ``encode_image`` and ``encode_text`` are one
    CLIP's; ``id_extract`` (optional) and ``fid_extract`` (CLIP image
    features by default) map images to feature rows. ``span(stage)`` is a
    context manager around each stage (``text``, ``clip_image``,
    ``arcface``, ``inception`` — the FID extractor), by default the
    tracer's ``eval.<stage>``; after ``run`` the pools
    are kept in ``feats_gen`` and ``feats_orig``. In a data-parallel group
    ``edit_fn`` edits this rank's rows of the prompt batch whose features it
    is handed, and ``run`` returns the result on rank 0 alone (None on the
    others)."""

    def __init__(self, *, edit_fn: Callable, encode_image: Callable,
                 encode_text: Callable, id_extract: Optional[Callable] = None,
                 fid_extract: Optional[Callable] = None, span=None):
        self.edit_fn = edit_fn
        self.encode_image = encode_image
        self.encode_text = encode_text
        self.id_extract = id_extract
        self.fid_extract = fid_extract or encode_image
        self.span = span or profiling.stage_spans("eval")
        self.feats_gen = self.feats_orig = None

    @torch.no_grad()
    def run(self, seeds, prompt_token_batches) -> dict:
        id_cos, improved, total = 0.0, 0, 0
        feats_gen, feats_orig = [], []
        seeds = list(seeds)
        for seed, tokens in zip(seeds, prompt_token_batches):
            tokens = dist.rows(tokens)
            with self.span("text"):
                text_feats = self.encode_text(tokens)
            img_orig, img_gen = self.edit_fn(seed, text_feats)
            with self.span("clip_image"):
                f_orig = self.encode_image(img_orig)
                f_gen = self.encode_image(img_gen)
            sim_orig = _cos(f_orig, text_feats)
            sim_gen = _cos(f_gen, text_feats)
            improved += int((sim_gen > sim_orig).sum())
            total += int(tokens.shape[0])
            if self.id_extract is not None:
                with self.span("arcface"):
                    id_cos += float(_cos(self.id_extract(img_gen),
                                         self.id_extract(img_orig)).sum())
            with self.span("inception"):
                feats_gen.append(_host(self.fid_extract(img_gen)))
                feats_orig.append(_host(self.fid_extract(img_orig)))

        improved, total, id_cos = dist.sum_floats(improved, total, id_cos)
        improved, total = int(improved), int(total)
        pools = [dist.gather_rows(torch.from_numpy(np.concatenate(f)), len(seeds))
                 for f in (feats_gen, feats_orig)]
        if not dist.is_main():
            return None
        self.feats_gen, self.feats_orig = (p.numpy() for p in pools)
        out = {
            "clip_improvement": improved / max(total, 1),
            "fid_features": frechet_distance(self.feats_gen, self.feats_orig),
            "n": total,
        }
        if self.id_extract is not None:
            out["id_cosine"] = id_cos / max(total, 1)
        return out

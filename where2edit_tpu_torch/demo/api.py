"""The text-guided edit API (counterpart of where2edit_tpu/demo/api.py).

``EditSession`` synthesises (or loads) a face once, keeping its S-space
styles and the mapper-ready feature taps, then edits it with any prompt:
CLIP text encoding, the mapper (edited styles + cluster-pooled attention
map), threshold + blur of the map, and a second synthesis that blends
``m·edited + (1-m)·original`` at ``attention_layer``. The session works in
S-space (the production path, the demo's) or, with
``work_in_stylespace=False``, in W+: it keeps the W+ latent, the mapper
(a W+ one, ``FullSpaceMapperFEATClusterLin``) returns a delta that is added
at strength one, and the synthesis takes the new W+.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from where2edit_tpu_torch.editing.attention_mappers import tap_controls
from where2edit_tpu_torch.editing.masks import demo_threshold
from where2edit_tpu_torch.ops.gaussian_blur import gaussian_blur
from where2edit_tpu_torch.ops.interpolate import interpolate_nearest


def subsample_for_mapper(feature_map, blend_size: int, indices=None):
    """Nearest-subsample every tap larger than the blend size; with
    ``indices``, other taps become None (the last entry, the appended const
    input, is always kept)."""
    keep = None if indices is None else set(indices) | {len(feature_map) - 1}
    return [None if (keep is not None and i not in keep)
            else interpolate_nearest(f, blend_size) if f.shape[1] > blend_size
            else f
            for i, f in enumerate(feature_map)]


def predict_edit(*, mapper, text_features, attention_text_features, latent,
                 mapper_feature_map, blend_size: int,
                 strength_alpha: float = 0.1,
                 attention_threshold: float = 0.75,
                 deterministic_noise: bool = True,
                 rng: torch.Generator | None = None,
                 work_in_stylespace: bool = True):
    """Mapper (inference: ``train=False``), then threshold + blur of its map.
    S-space: the edited styles and the cluster-pooled map (``strength_alpha``
    scales the residuals). W+: ``latent + delta`` (strength one) and the
    W+ mapper's own map. Returns (new_latents, attention_map (B, h, h, 1))."""
    if work_in_stylespace:
        mo = mapper(text_features, latent, mapper_feature_map, blend_size,
                    attention_text=attention_text_features, train=False,
                    strength_alpha=strength_alpha, pooled_map=True,
                    finalize=False, deterministic_noise=deterministic_noise,
                    rng=rng)
        new_latents = mo.latents
    else:
        mo = mapper(text_features, latent, mapper_feature_map, blend_size,
                    attention_text=attention_text_features, train=False)
        new_latents = latent + mo.latents
    amap = gaussian_blur(demo_threshold(mo.attention_map, attention_threshold), 5)
    return new_latents, amap


def synthesize_edit(*, generator, new_latents, attention_map, feature_map,
                    attention_layer: int, work_in_stylespace: bool = True):
    """The blended synthesis from edited styles (or, in W+, from the new
    W+); stores no taps."""
    if work_in_stylespace:
        styles, kw = new_latents, {"input_is_stylespace": True}
    else:
        styles, kw = [new_latents], {"input_is_latent": True}
    return generator(styles, randomize_noise=False,
                     attention_layer=attention_layer,
                     attention_map=attention_map, feature_map=feature_map,
                     **kw).image


def one_text_edit(*, generator, mapper, text_features, attention_text_features,
                  latent, feature_map, attention_layer: int,
                  work_in_stylespace: bool = True,
                  strength_alpha: float = 0.1,
                  attention_threshold: float = 0.75,
                  deterministic_noise: bool = True, mapper_feature_map=None,
                  rng: torch.Generator | None = None):
    """Edit one batch: ``latent`` is the S-space styles (list of (B, C)) or,
    without ``work_in_stylespace``, a W+ (B, L, 512). ``mapper_feature_map``
    defaults to ``feature_map`` (the blend source). Returns (image,
    new_latents, attention_map)."""
    blend_size = feature_map[attention_layer - 1].shape[1]
    new_latents, amap = predict_edit(
        mapper=mapper, text_features=text_features,
        attention_text_features=attention_text_features, latent=latent,
        mapper_feature_map=(feature_map if mapper_feature_map is None
                            else mapper_feature_map),
        blend_size=blend_size, strength_alpha=strength_alpha,
        attention_threshold=attention_threshold,
        deterministic_noise=deterministic_noise, rng=rng,
        work_in_stylespace=work_in_stylespace)
    img = synthesize_edit(generator=generator, new_latents=new_latents,
                          attention_map=amap, feature_map=feature_map,
                          attention_layer=attention_layer,
                          work_in_stylespace=work_in_stylespace)
    return img, new_latents, amap


class EditSession:
    """Holds the models and one loaded face (its styles, or its W+ without
    ``work_in_stylespace``, and its taps).

    ``edit`` = ``encode`` (CLIP text) → ``predict`` (mapper + map) →
    ``render`` (blended synthesis); the three stages are public so a caller
    can time them apart.
    """

    def __init__(self, *, generator, mapper, clip_encode_text,
                 attention_layer: int = 13, work_in_stylespace: bool = True):
        self.generator = generator
        self.mapper = mapper
        self.clip_encode_text = clip_encode_text
        self.attention_layer = attention_layer
        self.work_in_stylespace = work_in_stylespace
        self.device = generator.device
        self.latent = None
        self.feature_map = None
        self.image = None
        self._mean_latent = None

    @torch.no_grad()
    def sample_wplus(self, seed: int, truncation: float = 0.7,
                     mean_latent: Optional[torch.Tensor] = None,
                     batch: int = 1) -> torch.Tensor:
        """Seeded W+ (B, n_latent, 512) from the style MLP and truncation
        only (no synthesis). The mean latent defaults to 4096 samples drawn
        with seed 0."""
        gen = self.generator
        if mean_latent is None:
            if self._mean_latent is None:
                rng = torch.Generator(self.device).manual_seed(0)
                self._mean_latent = gen.mean_latent(4096, rng)
            mean_latent = self._mean_latent
        rng = torch.Generator(self.device).manual_seed(int(seed))
        z = torch.randn(batch, gen.style_dim, generator=rng, device=self.device)
        w = gen.style_mlp(z)
        if truncation < 1:
            w = mean_latent + truncation * (w - mean_latent)
        return w[:, None, :].expand(-1, gen.n_latent, -1).contiguous()

    def load_synthetic(self, seed: int, truncation: float = 0.7,
                       mean_latent: Optional[torch.Tensor] = None,
                       batch: int = 1) -> torch.Tensor:
        """Seeded sample (the demo's 'Syn' mode); returns its image."""
        return self.load_latent(self.sample_wplus(seed, truncation,
                                                  mean_latent, batch))

    @torch.no_grad()
    def load_latent(self, wplus: torch.Tensor) -> torch.Tensor:
        """Capture a W+ (B, n_latent, 512): its S-space styles (or the W+
        itself) and the mapper-ready taps (subsampled at the source), with
        the const input appended. Returns the image."""
        wplus = torch.as_tensor(wplus, device=self.device, dtype=torch.float32)
        # a mapper without clusters reads no cluster tap
        cluster_layer = getattr(self.mapper, "cluster_layer", self.attention_layer)
        blend, keep = tap_controls(self.generator.size, self.attention_layer,
                                   cluster_layer)
        out = self.generator([wplus], input_is_latent=True,
                             randomize_noise=False, return_features=True,
                             tap_subsample=blend, tap_indices=keep)
        const = self.generator.input(wplus.shape[0])
        self.feature_map = list(out.feature_map) + [const]
        self.latent = out.style_vector if self.work_in_stylespace else wplus
        self.image = out.image
        return out.image

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens), device=self.device).long()

    @torch.no_grad()
    def encode(self, prompt_tokens, attention_tokens=None):
        """CLIP text features of the prompt and attention rows, encoded as
        one batch (rows are independent, so this equals two calls)."""
        prompt = self._tokens(prompt_tokens)
        if attention_tokens is None:
            text = self.clip_encode_text(prompt)
            return text, text
        both = self.clip_encode_text(
            torch.cat([prompt, self._tokens(attention_tokens)]))
        return both[:prompt.shape[0]], both[prompt.shape[0]:]

    def _face(self, n: int):
        """The loaded face's styles and taps, broadcast to ``n`` prompt rows
        when one face meets a batch of prompts (the prompt sweep)."""
        if self.latent is None:
            raise RuntimeError("load a face first (load_synthetic/load_latent)")
        lat, feats = self.latent, self.feature_map
        faces = (lat[0] if self.work_in_stylespace else lat).shape[0]
        if faces == 1 and n > 1:
            lat = ([s.expand(n, *s.shape[1:]) for s in lat]
                   if self.work_in_stylespace else lat.expand(n, *lat.shape[1:]))
            feats = [None if f is None else f.expand(n, *f.shape[1:])
                     for f in feats]
        return lat, feats

    @torch.no_grad()
    def predict(self, text, att, strength_alpha: float = 0.1,
                attention_threshold: float = 0.75):
        lat, feats = self._face(text.shape[0])
        return predict_edit(
            mapper=self.mapper, text_features=text,
            attention_text_features=att, latent=lat,
            mapper_feature_map=feats,
            blend_size=feats[self.attention_layer - 1].shape[1],
            strength_alpha=strength_alpha,
            attention_threshold=attention_threshold,
            work_in_stylespace=self.work_in_stylespace)

    @torch.no_grad()
    def render(self, new_latents, amap):
        _, feats = self._face(amap.shape[0])
        return synthesize_edit(generator=self.generator,
                               new_latents=new_latents, attention_map=amap,
                               feature_map=feats,
                               attention_layer=self.attention_layer,
                               work_in_stylespace=self.work_in_stylespace)

    def edit(self, prompt_tokens, attention_tokens=None,
             strength_alpha: float = 0.1, attention_threshold: float = 0.75):
        """Edit the loaded face(s). The token batch equals the face batch,
        except for the prompt sweep: one loaded face and N prompt rows give
        N edited images and maps in one batch. Returns (image, map)."""
        text, att = self.encode(prompt_tokens, attention_tokens)
        new_lat, amap = self.predict(text, att, strength_alpha,
                                     attention_threshold)
        return self.render(new_lat, amap), amap

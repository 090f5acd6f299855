"""The production S-space region-attention mapper (counterpart of
where2edit_tpu/editing/attention_mappers.py ``attention_tables``,
``tap_controls``, ``tap_resolution``, ``MapperOutput`` and
``FullSpaceMapperFEATClusterLinStyle``).

The mapper takes ``(text_features, styles, feature_map, size)`` directly.
Its 19 attention convs are 1x1 ``StyledConv``s: one K3 (``modconv1x1``)
call each on CUDA.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Sequence

import torch
from torch import nn

from where2edit_tpu_torch.editing.clustering import assign_clusters
from where2edit_tpu_torch.editing.masks import finalize_attention_map
from where2edit_tpu_torch.models.stylegan2 import blend_tap_indices, channel_table
from where2edit_tpu_torch.nn.layers import EqualLinear, StyledConv
from where2edit_tpu_torch.ops.interpolate import interpolate_nearest
from where2edit_tpu_torch.ops.segment import (
    cluster_coverage_penalty,
    segment_mean_map,
)


def attention_tables(size: int, channel_multiplier: int = 2) -> dict:
    """Geometry tables for a generator size: n_taps, n_latent, layer_num
    (non-to_rgb tap indices), w_code_num (with the reference's tail quirk),
    style_layers, wplus_dims, tap_channels, stylespace_dims."""
    log_size = int(math.log2(size))
    n_oct = log_size - 3 + 1
    n_taps = 2 + 3 * n_oct
    n_latent = 2 * log_size - 2
    ch = channel_table(channel_multiplier)

    layer_num = [i for i in range(n_taps) if i % 3 != 1]
    w_code_num = [0, 1, 1]
    style_layers = [0, 2, 2]
    for k in range(n_oct):
        w_code_num += [2 * k + 2, 2 * k + 3, 2 * k + 3]
        style_layers += [3 * k + 3, 3 * k + 5, 3 * k + 5]
    w_code_num[-1] = n_latent  # reference tail quirk

    tap_channels = [ch[4], 3]
    wplus_dims = [ch[4]]
    stylespace_dims = [ch[4], ch[4]]
    for k in range(n_oct):
        res = 2 ** (k + 3)
        tap_channels += [ch[res], ch[res], 3]
        wplus_dims += [ch[res], ch[res]]
        stylespace_dims += [ch[res // 2], ch[res], ch[res]]

    return {
        "n_taps": n_taps,
        "n_latent": n_latent,
        "layer_num": layer_num,
        "w_code_num": w_code_num,
        "style_layers": style_layers,
        "wplus_dims": wplus_dims,
        "tap_channels": tap_channels,
        "stylespace_dims": stylespace_dims,
    }


def tap_resolution(layer: int) -> int:
    """Spatial resolution of feature tap ``layer - 1`` (1-based layer)."""
    return 4 * 2 ** (layer // 3)


def tap_controls(size: int, attention_layer: int,
                 cluster_layer: Optional[int] = None,
                 channel_multiplier: int = 2):
    """``(tap_subsample, tap_indices)`` for a capture pass feeding this
    mapper: the non-to_rgb mapper taps, the blend taps and the cluster tap,
    emitted at the larger of the blend and cluster resolutions (exact: the
    attention convs are pointwise, so conv∘subsample ≡ subsample∘conv)."""
    keep = set(attention_tables(size, channel_multiplier)["layer_num"])
    keep |= set(blend_tap_indices(attention_layer))
    sub = tap_resolution(attention_layer)
    if cluster_layer is not None:
        keep.add(cluster_layer - 1)
        sub = max(sub, tap_resolution(cluster_layer))
    return sub, tuple(sorted(keep))


class MapperOutput(NamedTuple):
    latents: Any                              # list[(B, C)] edited styles
    attention_map: Optional[torch.Tensor]     # (B, size, size, 1)
    loss_delta: torch.Tensor
    loss_reg: torch.Tensor
    loss_tv: torch.Tensor

    @property
    def losses(self):
        return [self.loss_delta, self.loss_reg, self.loss_tv]


class FullSpaceMapperFEATClusterLinStyle(nn.Module):
    """Production S-space mapper: per-style residual mappers for the layers
    below ``attention_layer`` and a cluster-pooled attention map from 1x1
    attention convs over the feature taps."""

    def __init__(self, layers: int, latent_dim: int = 512,
                 attention_layer: int = 11, cluster_layer: int = 11,
                 channel_multiplier: int = 2, clusters: int = 10,
                 cluster_dim: int = 576, coverage_threshold: float = 0.7,
                 generator_size: int = 1024,
                 rng: torch.Generator | None = None):
        super().__init__()
        self.layers = layers
        self.attention_layer = attention_layer
        self.cluster_layer = cluster_layer
        self.clusters = clusters
        self.coverage_threshold = coverage_threshold
        tables = attention_tables(generator_size, channel_multiplier)
        self.layer_num = tables["layer_num"]
        self.mapper_layer = tables["style_layers"][attention_layer]
        dim = tables["stylespace_dims"]
        tap_ch = tables["tap_channels"]
        hidden = (latent_dim + 512) // 2

        self.register_buffer("initial_state",
                             torch.zeros(clusters, cluster_dim))
        for c in range(self.mapper_layer):
            self.add_module(f"mapper_{c}",
                            EqualLinear(dim[c], dim[c], bias_init=1.0, rng=rng))
            self.add_module(f"mapper_text_{c}", nn.Sequential(
                EqualLinear(latent_dim, hidden, activation="fused_lrelu", rng=rng),
                EqualLinear(hidden, 512, activation="fused_lrelu", rng=rng)))
            self.add_module(f"mapper_all_{c}",
                            EqualLinear(dim[c] + 512, dim[c], bias_init=1.0,
                                        rng=rng))
        for c in self.layer_num:
            self.add_module(f"attention_textca_{c}",
                            EqualLinear(latent_dim, tap_ch[c], bias_init=1.0,
                                        rng=rng))
            self.add_module(f"attention_{c}",
                            StyledConv(tap_ch[c], 32, 1, tap_ch[c], rng=rng))
        self.attention_textca_first = EqualLinear(latent_dim, dim[0],
                                                  bias_init=1.0, rng=rng)
        self.attention_first = StyledConv(dim[0], 32, 1, dim[0], rng=rng)
        self.attention_textca_last = EqualLinear(latent_dim, 32 * layers,
                                                 bias_init=1.0, rng=rng)
        self.attention_last = StyledConv(32 * layers, 1, 1, 32 * layers, rng=rng)
        self.initial_bias = nn.Parameter(torch.full((1,), 5.0))

    def forward(self, text_features, styles: Sequence[torch.Tensor],
                feature_map, size: int, attention_text=None,
                strength_alpha: float = 0.1, pooled_map: bool = True,
                finalize: bool = True, deterministic_noise: bool = False,
                rng: torch.Generator | None = None) -> MapperOutput:
        """``feature_map``: the generator's taps with the (B, 4, 4, 512)
        const input appended (read as ``feature_map[-1]``). Without
        ``deterministic_noise`` the attention convs' noise is drawn from
        ``rng``; with it the noise is zero."""
        batch = styles[0].shape[0]
        x_text = text_features
        if attention_text is None:
            attention_text = x_text

        with torch.no_grad():
            ids = assign_clusters(feature_map[self.cluster_layer - 1].detach(),
                                  self.initial_state)
        if ids.shape[1] != size:
            ids = interpolate_nearest(ids[..., None], size)[..., 0]

        def att_conv(conv, textca, feature):
            s = textca(attention_text)
            if feature.shape[1] > size:
                feature = interpolate_nearest(feature, size)
            nz = (feature.new_zeros(feature.shape[:3] + (1,))
                  if deterministic_noise else None)
            f, _ = conv(feature, s, noise=nz, input_is_stylespace=True, rng=rng)
            return interpolate_nearest(f, size)

        att_feats = [att_conv(self.attention_first, self.attention_textca_first,
                              feature_map[-1])]
        out = []
        loss_delta = styles[0].new_zeros(())
        for c, s in enumerate(styles):
            if c < self.mapper_layer:
                t_hidden = getattr(self, f"mapper_text_{c}")(x_text)
                s_hidden = getattr(self, f"mapper_{c}")(s)
                joint = getattr(self, f"mapper_all_{c}")(
                    torch.cat([s_hidden, t_hidden], dim=-1))
                s_new = s + strength_alpha * (joint - s)
                loss_delta = loss_delta + torch.linalg.norm(
                    s_new - s, dim=-1).mean() / float(self.mapper_layer)
                out.append(s_new)
            else:
                out.append(s)
            if c in self.layer_num:
                att_feats.append(att_conv(getattr(self, f"attention_{c}"),
                                          getattr(self, f"attention_textca_{c}"),
                                          feature_map[c]))

        each = torch.cat(att_feats, dim=-1)
        s_last = self.attention_textca_last(attention_text)
        nz_last = (each.new_zeros((batch, size, size, 1))
                   if deterministic_noise else None)
        each, _ = self.attention_last(each, s_last, noise=nz_last,
                                      input_is_stylespace=True, rng=rng)
        each = torch.sigmoid(each + self.initial_bias)[..., 0]

        pooled, means, counts = segment_mean_map(each, ids,
                                                 batch * self.clusters)
        loss_reg = cluster_coverage_penalty(means, counts, batch,
                                            self.coverage_threshold)
        amap = (pooled if pooled_map else each)[..., None]
        loss_tv = (each - pooled.detach()).square().mean()
        final = finalize_attention_map(amap, 0.8) if finalize else amap
        return MapperOutput(out, final, loss_delta, loss_reg, loss_tv)

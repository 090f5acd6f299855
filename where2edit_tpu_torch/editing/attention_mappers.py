"""The region-attention mapper family (counterpart of
where2edit_tpu/editing/attention_mappers.py): the production pair
``FullSpaceMapperFEATClusterLinStyle`` (S-space) and
``FullSpaceMapperFEATClusterLin`` (W+), their uncluttered twins
``FullSpaceMapperFEATLinStyle`` and ``FullSpaceMapperFEATLin``, and the
reference's ablation nets.

The mappers take ``(text_features, latents, ...)`` directly; the reference
concatenates the text onto the latents and slices it apart inside.
Parameters keep the reference's state-dict keys (``mapper_{c}.{i}``
Sequentials that start with a PixelNorm, flat ``attention_first`` /
``attention_{c}`` / ``attention_last`` convs, the ``initial_state``
k-means buffer), so a reference checkpoint loads as it is.

Kernels: the S-space cluster mapper's 19 attention convs are 1x1
``StyledConv``s, one K3 (``modconv1x1``) call each on CUDA. The W+ trunk's
and ``FullSpaceMapperFEATLinStyle``'s attention convs are plain 1x1
``EqualConv2d``s (not modulated): matmuls, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Sequence

import torch
from torch import nn

from where2edit_tpu_torch.editing.clustering import assign_clusters
from where2edit_tpu_torch.editing.masks import (
    finalize_attention_map,
    straight_through_threshold,
)
from where2edit_tpu_torch.editing.modules import AddNoise, GumbelSoftmax, uniform
from where2edit_tpu_torch.models.stylegan2 import blend_tap_indices, channel_table
from where2edit_tpu_torch.nn.layers import (
    EqualConv2d,
    EqualLinear,
    PixelNorm,
    StyledConv,
    pixel_norm,
)
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


def wplus_dim_table(channel_multiplier: int = 2) -> list[int]:
    """Channels of the taps the 1024² W+ mappers read, in order."""
    cm = channel_multiplier
    return ([512] * 7 + [256 * cm] * 2 + [128 * cm] * 2 + [64 * cm] * 2
            + [32 * cm] * 2 + [16 * cm] * 2)


def style_dim_table(channel_multiplier: int = 2) -> list[int]:
    """Widths of the 27 S-space style vectors at 1024²."""
    cm = channel_multiplier
    return ([512] * 12 + [256 * cm] * 3 + [128 * cm] * 3 + [64 * cm] * 3
            + [32 * cm] * 3 + [16 * cm] * 3)


class MapperOutput(NamedTuple):
    latents: Any          # W+ delta (B, L, 512) or list[(B, C)] edited styles
    attention_map: Optional[torch.Tensor]     # (B, size, size, 1)
    loss_delta: torch.Tensor
    loss_reg: torch.Tensor
    loss_tv: torch.Tensor

    @property
    def losses(self):
        return [self.loss_delta, self.loss_reg, self.loss_tv]


def _zero(like: torch.Tensor) -> torch.Tensor:
    return like.new_zeros(())


def _conv_then_resize(conv, feature: torch.Tensor, size: int) -> torch.Tensor:
    """A pointwise ``conv`` and a nearest resize to ``size`` in the cheaper
    order (they commute: nearest resize selects pixels)."""
    if feature.shape[1] > size:
        return conv(interpolate_nearest(feature, size))
    return interpolate_nearest(conv(feature), size)


def _centres(mapper) -> torch.Tensor:
    """The k-means centres, or an error when the mapper was loaded from a
    checkpoint without ``initial_state`` (the JAX mapper has no clusters
    collection then, and refuses to run)."""
    if mapper.initial_state is None:
        raise RuntimeError(
            f"{type(mapper).__name__} has no k-means centres: its checkpoint "
            "holds no initial_state")
    return mapper.initial_state


def _residual_mlp(dim: int, depth: int, lr_mul: float, rng) -> nn.Sequential:
    """The reference's per-row mapper: PixelNorm, then ``depth`` fused-lrelu
    EqualLinears (keys ``1`` … ``depth``)."""
    return nn.Sequential(PixelNorm(), *[
        EqualLinear(dim, dim, lr_mul=lr_mul, activation="fused_lrelu", rng=rng)
        for _ in range(depth)])


# --------------------------------------------------------------------------
# building blocks of the ablation nets
# --------------------------------------------------------------------------

class MapperNet(nn.Module):
    """PixelNorm and 4 fused-lrelu EqualLinears (``mapping.{1..4}``)."""

    def __init__(self, in_dim: int = 512, latent_dim: int = 512,
                 rng: torch.Generator | None = None):
        super().__init__()
        self.mapping = nn.Sequential(PixelNorm(), *[
            EqualLinear(in_dim if i == 0 else latent_dim, latent_dim, lr_mul=0.01,
                        activation="fused_lrelu", rng=rng) for i in range(4)])

    def forward(self, x):
        return self.mapping(x)


class MapperConNet(nn.Module):
    """Text and latent branches (PixelNorm, two fused-lrelu EqualLinears
    each), then a joint head of two."""

    def __init__(self, in_dim: int = 512, latent_dim: int = 512,
                 rng: torch.Generator | None = None):
        super().__init__()

        def lin(d_in):
            return EqualLinear(d_in, latent_dim, lr_mul=0.01,
                               activation="fused_lrelu", rng=rng)

        self.mapping_text = nn.Sequential(PixelNorm(), lin(in_dim - latent_dim),
                                          lin(latent_dim))
        self.mapping_latent = nn.Sequential(PixelNorm(), lin(latent_dim),
                                            lin(latent_dim))
        self.mapping_together = nn.Sequential(lin(2 * latent_dim), lin(latent_dim))

    def forward(self, text, latent):
        x = torch.cat([self.mapping_text(text), self.mapping_latent(latent)], dim=-1)
        return self.mapping_together(x)


class MapperConLinNet(nn.Module):
    """Both inputs pixel-normed, one linear head (``mapping_together.0``)."""

    def __init__(self, in_dim: int = 512, latent_dim: int = 512,
                 rng: torch.Generator | None = None):
        super().__init__()
        self.mapping_together = nn.Sequential(
            EqualLinear(in_dim, latent_dim, lr_mul=0.1, rng=rng))

    def forward(self, text, latent):
        return self.mapping_together(
            torch.cat([pixel_norm(text), pixel_norm(latent)], dim=-1))


# --------------------------------------------------------------------------
# W+ full-space families
# --------------------------------------------------------------------------

def _rows(x: torch.Tensor) -> list:
    """(B, L, D) → L rows of (B, 1, D)."""
    return [x[:, c:c + 1] for c in range(x.shape[1])]


def _mean_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(x, dim=-1).mean()


class FullSpaceMapper(nn.Module):
    """One ``MapperNet`` per W+ row on [text, row]."""

    def __init__(self, layers: int, in_dim: int = 1024, latent_dim: int = 512,
                 rng: torch.Generator | None = None):
        super().__init__()
        for c in range(layers):
            self.add_module(f"mapper_{c}", MapperNet(in_dim, latent_dim, rng=rng))

    def forward(self, text_features, latent) -> MapperOutput:
        text = text_features[:, None, :].expand(-1, latent.shape[1], -1)
        x = torch.cat([text, latent], dim=-1)
        delta = torch.cat([getattr(self, f"mapper_{c}")(row)
                           for c, row in enumerate(_rows(x))], dim=1)
        return MapperOutput(delta, None, _mean_norm(delta), _zero(delta),
                            _zero(delta))


class FullSpaceMapperCon(nn.Module):
    """One ``MapperConNet`` per W+ row."""

    def __init__(self, layers: int, in_dim: int = 1024, latent_dim: int = 512,
                 rng: torch.Generator | None = None):
        super().__init__()
        for c in range(layers):
            self.add_module(f"mapper_{c}", MapperConNet(in_dim, latent_dim, rng=rng))

    def forward(self, text_features, latent) -> MapperOutput:
        t = text_features[:, None, :]
        delta = torch.cat([getattr(self, f"mapper_{c}")(t, row)
                           for c, row in enumerate(_rows(latent))], dim=1)
        return MapperOutput(delta, None, _mean_norm(delta), _zero(delta),
                            _zero(delta))


class FullSpaceMapperAtt(nn.Module):
    """Per-row sigmoid gates from the text (``mapping_attention.{1,2}``, with
    Gaussian jitter of 0.5 in training) on ``MapperConNet`` rows."""

    def __init__(self, layers: int, in_dim: int = 1024, latent_dim: int = 512,
                 rng: torch.Generator | None = None):
        super().__init__()
        self.mapping_attention = nn.Sequential(
            PixelNorm(),
            EqualLinear(in_dim - latent_dim, latent_dim, lr_mul=0.01,
                        activation="fused_lrelu", rng=rng),
            EqualLinear(latent_dim, layers, lr_mul=0.01, rng=rng))
        self.att_noise = AddNoise(0.5)
        for c in range(layers):
            self.add_module(f"mapper_{c}", MapperConNet(in_dim, latent_dim, rng=rng))

    def forward(self, text_features, latent, train: bool = False,
                rng: torch.Generator | None = None) -> MapperOutput:
        a = self.att_noise(self.mapping_attention(text_features), train, rng)
        attention = torch.sigmoid(a)
        t = text_features[:, None, :]
        delta = torch.cat([getattr(self, f"mapper_{c}")(t, row)
                           * attention[:, c][:, None, None]
                           for c, row in enumerate(_rows(latent))], dim=1)
        loss_att = 0.25 - (attention - 0.5).square().mean()
        return MapperOutput(delta, None, loss_att, _zero(delta), _zero(delta))


class FullSpaceMapperAttLin(nn.Module):
    """Gumbel one-hot row gates from the text (``mapping_attention.1``) on
    ``MapperConLinNet`` rows."""

    def __init__(self, layers: int, in_dim: int = 1024, latent_dim: int = 512,
                 rng: torch.Generator | None = None):
        super().__init__()
        self.mapping_attention = nn.Sequential(
            PixelNorm(), EqualLinear(in_dim - latent_dim, layers, rng=rng))
        self.att_gumbel = GumbelSoftmax(1.0)
        for c in range(layers):
            self.add_module(f"mapper_{c}", MapperConLinNet(in_dim, latent_dim, rng=rng))

    def forward(self, text_features, latent, train: bool = False,
                rng: torch.Generator | None = None) -> MapperOutput:
        a = torch.relu(self.mapping_attention(text_features))
        attention = self.att_gumbel(a, train, rng)
        t = text_features[:, None, :]
        delta = torch.cat([getattr(self, f"mapper_{c}")(t, row)
                           for c, row in enumerate(_rows(latent))], dim=1)
        loss_delta = _mean_norm(delta)
        delta = delta * attention[:, :, None]
        return MapperOutput(delta, None, loss_delta, _zero(delta), _zero(delta))


class FullSpaceMapperSpatialLin(nn.Module):
    """The first spatial-attention variant: ``MapperConLinNet`` rows and a
    map from 1x1 convs over 13 taps (the reference's channel tables at
    channel multiplier 1, so ``layers`` is 14), projected on the text. The
    reference's ``mapping_attention`` head is never used in its forward and
    is not declared."""

    DIMS = [512] * 7 + [256] * 2 + [128] * 2 + [64] * 2
    LAYER_NUM = [0, 2, 3, 5, 6, 8, 9, 11, 12, 14, 15, 17, 18]

    def __init__(self, layers: int, in_dim: int = 1024, latent_dim: int = 512,
                 rng: torch.Generator | None = None):
        super().__init__()
        for c in range(layers):
            self.add_module(f"mapper_{c}", MapperConLinNet(in_dim, latent_dim, rng=rng))
        for c in range(layers - 1):
            self.add_module(f"attention_{c}",
                            EqualConv2d(self.DIMS[c], 32, 1, rng=rng))
        self.attention_last = EqualConv2d(32 * (layers - 1), latent_dim, 1, rng=rng)
        self.proj_text = EqualLinear(latent_dim, latent_dim, rng=rng)

    def forward(self, text_features, latent, feature_map, size: int,
                train: bool = False) -> MapperOutput:
        t = text_features[:, None, :]
        out, att_feats = [], []
        for c, row in enumerate(_rows(latent)):
            out.append(getattr(self, f"mapper_{c}")(t, row))
            if c < latent.shape[1] - 1:
                att_feats.append(_conv_then_resize(
                    getattr(self, f"attention_{c}"),
                    feature_map[self.LAYER_NUM[c]], size))
        delta = torch.cat(out, dim=1)
        amap = self.attention_last(torch.cat(att_feats, dim=-1))
        amap = amap / torch.linalg.norm(amap, dim=-1, keepdim=True)
        proj = self.proj_text(text_features)
        proj = proj / torch.linalg.norm(proj, dim=-1, keepdim=True)
        amap = 0.5 * ((proj[:, None, None, :] * amap).sum(-1, keepdim=True) + 1.0)
        small, big = size // 4, 3 * size // 4
        weight = torch.ones_like(amap)
        weight[:, small:big, small:big, :] = 0.5
        loss_reg = (weight * amap).mean()
        tv = (torch.linalg.norm((amap[:, 1:] - amap[:, :-1]).reshape(-1))
              + torch.linalg.norm((amap[:, :, 1:] - amap[:, :, :-1]).reshape(-1)))
        return MapperOutput(delta, amap, _mean_norm(delta), loss_reg, tv)


def _add_feat_trunk(module: nn.Module, layers: int, wplus_dims: Sequence[int],
                    rng) -> None:
    """The W+ FEAT attention convs, flat in ``module`` as the reference
    keys them: ``attention_first`` (the const input), ``attention_{c}``
    (c < layers - 1), each C_tap → 32, and ``attention_last`` 32·layers → 1
    with its bias at 5."""
    module.attention_first = EqualConv2d(wplus_dims[0], 32, 1, rng=rng)
    for c in range(layers - 1):
        module.add_module(f"attention_{c}",
                          EqualConv2d(wplus_dims[c], 32, 1, rng=rng))
    module.attention_last = EqualConv2d(32 * layers, 1, 1, rng=rng)
    with torch.no_grad():
        module.attention_last.bias.fill_(5.0)


def _feat_trunk(module: nn.Module, feature_map, size: int) -> torch.Tensor:
    """Logits (B, size, size, 1) of the W+ FEAT attention branch.

    The reference runs one C_tap → 32 conv per tap, concatenates the maps
    and applies a 32·layers → 1 conv. Both are linear and commute with the
    nearest resize, so each tap's conv composes with its 32-row slice of
    ``attention_last`` into one C_tap → 1 product (32× fewer MACs, the same
    parameters and gradients), summed over the taps."""
    last = module.attention_last
    w_last = last.weight[:, :, 0, 0].t() * last.scale            # (32·L, 1)
    taps = [(feature_map[-1], module.attention_first)]
    taps += [(feature_map[module.layer_num[c]], getattr(module, f"attention_{c}"))
             for c in range(module.layers - 1)]
    logits = None
    bias = last.bias
    for idx, (feat, conv) in enumerate(taps):
        w_l = w_last[idx * 32:(idx + 1) * 32]                     # (32, 1)
        w_eff = (conv.weight[:, :, 0, 0].t() * conv.scale) @ w_l  # (C_tap, 1)
        bias = bias + conv.bias @ w_l
        if feat.shape[1] > size:
            feat = interpolate_nearest(feat, size)
        y = feat @ w_eff
        if y.shape[1] < size:
            y = interpolate_nearest(y, size)
        logits = y if logits is None else logits + y
    return logits + bias


class FullSpaceMapperFEATLin(nn.Module):
    """W+ deltas below the attention layer, from the latent alone (three
    fused-lrelu EqualLinears at lr_mul 0.1 per row), and a spatial map from
    the FEAT trunk: straight-through zero under 0.8, a normalised TV."""

    def __init__(self, layers: int, latent_dim: int = 512,
                 attention_layer: int = 11, channel_multiplier: int = 2,
                 generator_size: int = 1024, rng: torch.Generator | None = None):
        super().__init__()
        tables = attention_tables(generator_size, channel_multiplier)
        self.layers = layers
        self.attention_layer = attention_layer
        self.layer_num = tables["layer_num"]
        self.mapper_layer = tables["w_code_num"][attention_layer]
        for c in range(self.mapper_layer):
            self.add_module(f"mapper_{c}", _residual_mlp(latent_dim, 3, 0.1, rng))
        _add_feat_trunk(self, layers, tables["wplus_dims"], rng)

    def _deltas(self, latent):
        delta = torch.cat([getattr(self, f"mapper_{c}")(row) if c < self.mapper_layer
                           else torch.zeros_like(row)
                           for c, row in enumerate(_rows(latent))], dim=1)
        return delta, _mean_norm(delta[:, :self.mapper_layer])

    def forward(self, text_features, latent, feature_map, size: int,
                train: bool = False, attention_text=None) -> MapperOutput:
        """``text_features`` and ``attention_text`` are not read: the deltas
        come from the latent alone."""
        delta, loss_delta = self._deltas(latent)
        amap = torch.sigmoid(_feat_trunk(self, feature_map, size))
        tv = (torch.linalg.matrix_norm(amap[:, 1:] - amap[:, :-1], dim=(1, 2))
              / float((size - 1) * size)
              + torch.linalg.matrix_norm(amap[:, :, 1:] - amap[:, :, :-1], dim=(1, 2))
              / float(size * (size - 1))).mean()
        final = straight_through_threshold(amap, 0.8)
        return MapperOutput(delta, final, loss_delta, final.mean(), tv)


class FullSpaceMapperFEATClusterLin(FullSpaceMapperFEATLin):
    """The production W+ mapper: ``FullSpaceMapperFEATLin``'s deltas and
    trunk, with the map at the cluster tap's resolution (whatever size the
    caller passes). ``train=True`` pools it over the k-means regions and
    adds the coverage penalty (threshold 0.8); ``train=False`` returns the
    per-pixel map. Either way it is straight-through thresholded at 0.8 and
    blurred."""

    def __init__(self, layers: int, latent_dim: int = 512,
                 attention_layer: int = 11, cluster_layer: int = 11,
                 channel_multiplier: int = 2, clusters: int = 10,
                 cluster_dim: int = 576, coverage_threshold: float = 0.8,
                 generator_size: int = 1024, rng: torch.Generator | None = None):
        super().__init__(layers, latent_dim, attention_layer,
                         channel_multiplier, generator_size, rng)
        self.cluster_layer = cluster_layer
        self.clusters = clusters
        self.coverage_threshold = coverage_threshold
        self.register_buffer("initial_state", torch.zeros(clusters, cluster_dim))

    def forward(self, text_features, latent, feature_map, size: int,
                train: bool = True, attention_text=None) -> MapperOutput:
        batch = latent.shape[0]
        blend_feature = feature_map[self.cluster_layer - 1]
        size = blend_feature.shape[1]
        centres = _centres(self)
        delta, loss_delta = self._deltas(latent)
        each = torch.sigmoid(_feat_trunk(self, feature_map, size))[..., 0]
        if train:
            with torch.no_grad():
                ids = assign_clusters(blend_feature.detach(), centres)
            pooled, means, counts = segment_mean_map(each, ids,
                                                     batch * self.clusters)
            amap = pooled[..., None]
            loss_reg = cluster_coverage_penalty(means, counts, batch,
                                                self.coverage_threshold)
        else:
            amap = each[..., None]
            loss_reg = _zero(each)
        loss_tv = (each[..., None] - amap.detach()).square().mean()
        return MapperOutput(delta, finalize_attention_map(amap, 0.8), loss_delta,
                            loss_reg, loss_tv)


# --------------------------------------------------------------------------
# S-space families
# --------------------------------------------------------------------------

class FullSpaceMapperAttLinStyle(nn.Module):
    """Per-style residuals (``MapperConLinNet`` on [text, style]) scaled by
    sigmoid gates from the text (``mapping_attention.1``, Gaussian jitter of
    0.5 and a uniform ×[1, 1.2) strength jitter in training). The
    reference's width table has 20 entries, so ``layers`` ≤ 14."""

    DIMS = [512] * 12 + [256] * 3 + [128] * 3 + [64] * 2

    def __init__(self, layers: int, in_dim: int = 1024, latent_dim: int = 512,
                 rng: torch.Generator | None = None):
        super().__init__()
        self.total_layers = layers + int((layers - 2) * 0.5)
        self.mapping_attention = nn.Sequential(
            PixelNorm(), EqualLinear(in_dim - latent_dim, self.total_layers, rng=rng))
        self.att_noise = AddNoise(0.5)
        for c in range(self.total_layers):
            d = self.DIMS[c]
            self.add_module(f"mapper_{c}",
                            MapperConLinNet(in_dim - latent_dim + d, d, rng=rng))

    def forward(self, text_features, styles: Sequence[torch.Tensor],
                train: bool = False, rng: torch.Generator | None = None
                ) -> MapperOutput:
        a = self.att_noise(self.mapping_attention(text_features), train, rng)
        attention = torch.sigmoid(a)
        t = text_features[:, None, :]
        out = []
        loss_delta = _zero(text_features)
        for c, s in enumerate(styles):
            row = s[:, None, :]
            res = getattr(self, f"mapper_{c}")(t, row)
            loss_delta = loss_delta + _mean_norm(res)
            strength = attention[:, c][:, None, None]
            if train:
                strength = strength * (1 + 0.2 * uniform((s.shape[0], 1, 1), rng, s))
            out.append((row + strength * res)[:, 0, :])
        return MapperOutput(out, None, loss_delta / float(len(styles)),
                            _zero(loss_delta), _zero(loss_delta))


class FullSpaceMapperFEATLinStyle(nn.Module):
    """S-space residuals for the styles below ``attention_layer`` (the
    layer index itself, not the style table: the reference's choice), from
    the styles alone (two fused-lrelu EqualLinears at lr_mul 10), and a
    spatial map from plain 1x1 ``EqualConv2d``s over the taps, no
    clusters."""

    def __init__(self, layers: int, attention_layer: int = 11,
                 channel_multiplier: int = 2, generator_size: int = 1024,
                 rng: torch.Generator | None = None):
        super().__init__()
        tables = attention_tables(generator_size, channel_multiplier)
        dim, tap_ch = tables["stylespace_dims"], tables["tap_channels"]
        self.attention_layer = attention_layer
        self.mapper_layer = attention_layer
        self.layer_num = tables["layer_num"]
        for c in range(self.mapper_layer):
            self.add_module(f"mapper_{c}", _residual_mlp(dim[c], 2, 10.0, rng))
        for c in self.layer_num:
            self.add_module(f"attention_{c}", EqualConv2d(tap_ch[c], 32, 1, rng=rng))
        self.attention_last = EqualConv2d(32 * (layers - 1), 1, 1, rng=rng)

    def forward(self, text_features, styles: Sequence[torch.Tensor], feature_map,
                size: int, train: bool = False, attention_text=None,
                deterministic_noise: bool = False) -> MapperOutput:
        """``text_features`` is not read (the residuals come from the styles
        alone); ``train`` and ``deterministic_noise`` change nothing (this
        net draws no noise)."""
        keep = set(self.layer_num)
        out, att_feats = [], []
        loss_delta = _zero(styles[0])
        for c, s in enumerate(styles):
            if c < self.mapper_layer:
                x = getattr(self, f"mapper_{c}")(s[:, None, :])
                loss_delta = loss_delta + _mean_norm(x) / float(self.mapper_layer)
                out.append(s + x[:, 0, :])
            else:
                out.append(s)
            if c in keep:
                att_feats.append(_conv_then_resize(getattr(self, f"attention_{c}"),
                                                   feature_map[c], size))
        amap = torch.sigmoid(self.attention_last(torch.cat(att_feats, dim=-1)))
        tv = (torch.linalg.norm((amap[:, 1:] - amap[:, :-1]).reshape(-1))
              + torch.linalg.norm((amap[:, :, 1:] - amap[:, :, :-1]).reshape(-1)))
        return MapperOutput(out, amap, loss_delta, amap.mean(), tv)


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
                train: bool = True, strength_alpha: float = 0.1,
                pooled_map: bool = True, finalize: bool = True,
                deterministic_noise: bool = False,
                rng: torch.Generator | None = None) -> MapperOutput:
        """``feature_map``: the generator's taps with the (B, 4, 4, 512)
        const input appended (read as ``feature_map[-1]``). Without
        ``deterministic_noise`` the attention convs' noise is drawn from
        ``rng``; with it the noise is zero. ``train`` changes nothing (the
        call is the same in training and inference)."""
        batch = styles[0].shape[0]
        x_text = text_features
        if attention_text is None:
            attention_text = x_text

        with torch.no_grad():
            ids = assign_clusters(feature_map[self.cluster_layer - 1].detach(),
                                  _centres(self))
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

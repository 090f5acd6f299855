"""Where2edit's S-space region-attention mapper
(``FullSpaceMapperFEATClusterLinStyle``, ``attention/run_attention.py
--work_in_stylespace --use_cluster``), at inference and as training runs
it, as plain formulas over its state dict, NCHW.

The styles below the attention layer's are moved towards a text-conditioned
target, ``s + α·(joint − s)``. The attention map: 1x1 modulated convs
(styles from the attention text) over the capture's non-ToRGB taps and the
constant, concatenated, one more such conv to one channel,
``sigmoid(· + initial_bias)``, averaged over the k-means regions of the
cluster tap (nearest centre over the features and C/16 copies of each
position coordinate), zeroed below the threshold and Gaussian-blurred.
"""

from __future__ import annotations

import math

import torch

from port_bench.reference.ops import equal_linear, gaussian_blur, lrelu, nearest


def style_layers(size: int) -> list:
    n_oct = int(math.log2(size)) - 2
    out = [0, 2, 2]
    for k in range(n_oct):
        out += [3 * k + 3, 3 * k + 5, 3 * k + 5]
    return out


def attention_taps(size: int) -> list:
    """The non-ToRGB tap indices (the convs' outputs)."""
    n_taps = 2 + 3 * (int(math.log2(size)) - 2)
    return [i for i in range(n_taps) if i % 3 != 1]


def tap_size(layer: int) -> int:
    return 4 * 2 ** (layer // 3)


def _att_conv(sd, p, textca, att_text, feature, size):
    s = equal_linear(att_text, sd[f"{textca}.weight"], sd[f"{textca}.bias"])
    if feature.shape[-1] > size:
        feature = nearest(feature, size)
    w = sd[f"{p}.conv.weight"][0][:, :, 0, 0]
    w = w / math.sqrt(w.shape[1])
    d = torch.rsqrt(s.square() @ w.square().t() + 1e-8)
    y = torch.einsum("bchw,oc->bohw", feature * s[:, :, None, None], w)
    y = lrelu(y * d[:, :, None, None], sd[f"{p}.activate.bias"])
    return nearest(y, size)


def cluster_ids(feature, centres):
    """Nearest centre of every pixel of ``feature`` (B, C, h, w), offset by
    sample·K; the features carry C/16 copies of x and of y in [-1, 1]."""
    b, c, h, w = feature.shape
    pc = c // 16
    r = torch.arange(h, device=feature.device, dtype=feature.dtype) * 2.0 / (h - 1) - 1.0
    xs = r[None, None, :, None].expand(b, h, w, pc)
    ys = r[None, :, None, None].expand(b, h, w, pc)
    f = torch.cat([feature.permute(0, 2, 3, 1), xs, ys], -1).reshape(-1, c + 2 * pc)
    d = (f.square().sum(-1, keepdim=True) - 2.0 * f @ centres.t()
         + centres.square().sum(-1)[None])
    k = centres.shape[0]
    ids = d.argmin(1).reshape(b, h, w)
    return ids + (torch.arange(b, device=ids.device) * k)[:, None, None]


def region_mean(values, ids, n: int):
    """(every pixel replaced by the mean of its region, the regions' means,
    their pixel counts); sums in float64."""
    flat = ids.reshape(-1)
    sums = torch.zeros(n, dtype=torch.float64, device=values.device).index_add(
        0, flat, values.reshape(-1).double())
    counts = torch.zeros(n, dtype=torch.float64, device=values.device).index_add(
        0, flat, torch.ones_like(flat, dtype=torch.float64))
    means = (sums / counts.clamp(min=1.0)).float()
    return means[flat].reshape(values.shape), means, counts.float()


def _forward(sd: dict, cfg: dict, text, att_text, styles: list, taps: list, const,
             strength_alpha: float):
    """(edited styles, the attention map before pooling (B, h, h), the
    region-pooled map, the regions' means and pixel counts, the delta
    loss)."""
    size = cfg["generator_size"]
    att_layer, cl_layer = cfg["attention_layer"], cfg["cluster_layer"]
    blend = tap_size(att_layer)
    mapper_layer = style_layers(size)[att_layer]
    with torch.no_grad():
        ids = cluster_ids(taps[cl_layer - 1], sd["initial_state"])
    if ids.shape[-1] != blend:
        ids = nearest(ids[:, None].float(), blend)[:, 0].long()
    feats = [_att_conv(sd, "attention_first", "attention_textca_first", att_text,
                       const, blend)]
    att_taps = set(attention_taps(size))
    out = []
    delta = styles[0].new_zeros(())
    for c, s in enumerate(styles):
        if c < mapper_layer:
            t = equal_linear(text, sd[f"mapper_text_{c}.0.weight"],
                             sd[f"mapper_text_{c}.0.bias"], act=True)
            t = equal_linear(t, sd[f"mapper_text_{c}.1.weight"],
                             sd[f"mapper_text_{c}.1.bias"], act=True)
            h = equal_linear(s, sd[f"mapper_{c}.weight"], sd[f"mapper_{c}.bias"])
            joint = equal_linear(torch.cat([h, t], -1), sd[f"mapper_all_{c}.weight"],
                                 sd[f"mapper_all_{c}.bias"])
            s_new = s + strength_alpha * (joint - s)
            delta = delta + (s_new - s).norm(dim=-1).mean() / mapper_layer
            out.append(s_new)
        else:
            out.append(s)
        if c in att_taps:
            feats.append(_att_conv(sd, f"attention_{c}", f"attention_textca_{c}",
                                   att_text, taps[c], blend))
    each = _att_conv(sd, "attention_last", "attention_textca_last", att_text,
                     torch.cat(feats, 1), blend)
    each = torch.sigmoid(each + sd["initial_bias"])[:, 0]
    n = each.shape[0] * sd["initial_state"].shape[0]
    pooled, means, counts = region_mean(each, ids, n)
    return out, each, pooled, means, counts, delta


def predict(sd: dict, cfg: dict, text, att_text, styles: list, taps: list,
            const, *, strength_alpha: float, threshold: float):
    """(edited styles, attention map (B, 1, h, h)) of one batch; ``taps``
    as the capture stores them (the blend size at most), ``const`` the
    generator's 4x4 constant broadcast to the batch."""
    out, _, pooled, _, _, _ = _forward(sd, cfg, text, att_text, styles, taps, const,
                                       strength_alpha)
    amap = pooled[:, None]
    amap = torch.where(amap < threshold, torch.zeros_like(amap), amap)
    return out, gaussian_blur(amap, 5)


def train_forward(sd: dict, cfg: dict, text, att_text, styles: list, taps: list,
                  const, *, strength_alpha: float = 0.1, threshold: float = 0.8,
                  coverage: float = 0.7):
    """The mapper as training runs it: (edited styles, the map through a
    straight-through threshold (0 below it in value, the identity in
    gradient) and the blur, and the delta, coverage and TV losses)."""
    out, each, pooled, means, counts, delta = _forward(sd, cfg, text, att_text, styles,
                                                       taps, const, strength_alpha)
    batch = each.shape[0]
    reg = torch.where(counts > 0, torch.relu(means - coverage),
                      torch.zeros_like(means)).sum() / batch
    tv = (each - pooled.detach()).square().mean()
    m = pooled[:, None]
    m = torch.where(m < threshold, m - m.detach(), m)
    return out, gaussian_blur(m, 5), {"delta": delta, "reg": reg, "tv": tv}

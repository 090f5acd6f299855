"""The text-guided edit of one batch of seeded faces, end to end, as plain
formulas: the seeded W+ (style MLP, truncation towards the mean of 4096
latents drawn with seed 0), the capture synthesis and its taps, the CLIP
text features of the edit and attention prompts, the mapper, and the
blended synthesis from the edited styles. Images come back NHWC."""

from __future__ import annotations

import torch

from port_bench.reference import clip_text, mapper, stylegan2


def mean_latent(gsd: dict, gcfg: dict, device) -> torch.Tensor:
    rng = torch.Generator(device).manual_seed(0)
    z = torch.randn(4096, gcfg["style_dim"], generator=rng, device=device)
    return stylegan2.style_mlp(gsd, z, gcfg).mean(0, keepdim=True)


def seeded_wplus(gsd: dict, gcfg: dict, seed: int, batch: int, truncation: float,
                 mean: torch.Tensor) -> torch.Tensor:
    rng = torch.Generator(mean.device).manual_seed(int(seed))
    z = torch.randn(batch, gcfg["style_dim"], generator=rng, device=mean.device)
    w = stylegan2.style_mlp(gsd, z, gcfg)
    w = mean + truncation * (w - mean)
    return w[:, None].expand(-1, stylegan2.n_latent(gcfg), -1)


def capture_taps(gcfg: dict, mcfg: dict) -> tuple:
    """(tap size, kept tap indices) of the capture: the mapper's taps, the
    blend taps and the cluster tap, at the larger of the blend and cluster
    sizes."""
    n_taps = len(stylegan2.conv_layers(gcfg))
    keep = set(mapper.attention_taps(gcfg["size"]))
    keep |= set(stylegan2.blend_taps(mcfg["attention_layer"], n_taps))
    keep.add(mcfg["cluster_layer"] - 1)
    size = max(mapper.tap_size(mcfg["attention_layer"]),
               mapper.tap_size(mcfg["cluster_layer"]))
    return size, keep


@torch.no_grad()
def edit_batch(weights: dict, cfg: dict, wplus, prompt_tokens, attention_tokens, *,
               strength_alpha: float, threshold: float) -> dict:
    """Every stage's output for one batch: text and attention features,
    the capture's styles and kept taps, the edited styles, the map (B, h,
    h, 1) and the image (B, size, size, 3)."""
    gsd, msd, tsd = weights["generator"], weights["mapper"], weights["clip_text"]
    gcfg, mcfg = cfg["generator"], dict(cfg["mapper"], generator_size=cfg["generator"]["size"])
    noise = stylegan2.fixed_noise(gsd, gcfg)
    size, keep = capture_taps(gcfg, mcfg)
    _, styles, taps = stylegan2.synthesis(gsd, gcfg, wplus, stylespace_input=False,
                                          noise=noise, tap_size=size, keep_taps=keep)
    text = clip_text.encode_text(tsd, cfg["clip_text"], prompt_tokens)
    att = clip_text.encode_text(tsd, cfg["clip_text"], attention_tokens)
    const = gsd["input.input"].expand(wplus.shape[0], -1, -1, -1)
    new_styles, amap = mapper.predict(msd, mcfg, text, att, styles, taps, const,
                                      strength_alpha=strength_alpha, threshold=threshold)
    image, _, _ = stylegan2.synthesis(gsd, gcfg, new_styles, stylespace_input=True,
                                      noise=noise,
                                      attention_layer=mcfg["attention_layer"],
                                      attention_map=amap, orig_taps=taps)
    return {"text": text, "attention_text": att, "styles": styles,
            "taps": [None if t is None else t.permute(0, 2, 3, 1) for t in taps],
            "edited_styles": new_styles, "map": amap.permute(0, 2, 3, 1),
            "image": image.permute(0, 2, 3, 1)}

"""CLIP ViT-B/32, text and image towers (counterpart of
where2edit_tpu/models/clip_model.py).

Parameter names follow OpenAI's CLIP state dict: the text tower's at the top
level (``token_embedding.weight``, ``positional_embedding``,
``transformer.resblocks.{i}.*``, ``ln_final.*``, ``text_projection``), the
image tower's under ``visual.*`` and ``logit_scale``, so an OpenAI state
dict loads as it is (``load_clip_state``). Attention is a plain matmul +
softmax (the text tower's with an additive causal mask); the text output is
read at the EOT position (the largest token id), the image output at the
class token. Images are NHWC.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch
from torch import nn


def _normal(shape, std: float, rng: torch.Generator | None) -> torch.Tensor:
    return torch.randn(*shape, generator=rng) * std


class QuickGELU(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


def _linear(d_in: int, d_out: int, rng: torch.Generator | None) -> nn.Linear:
    lin = nn.Linear(d_in, d_out)
    with torch.no_grad():
        lin.weight.copy_(_normal((d_out, d_in), d_in ** -0.5, rng))
        lin.bias.zero_()
    return lin


class MultiheadAttention(nn.Module):
    """torch nn.MultiheadAttention-compatible parameters (fused in_proj)."""

    def __init__(self, width: int, heads: int, rng: torch.Generator | None = None):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(
            _normal((3 * width, width), width ** -0.5, rng))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = _linear(width, width, rng)

    def forward(self, x, mask=None):
        b, l, d = x.shape
        h = self.heads
        hd = d // h
        qkv = x @ self.in_proj_weight.t() + self.in_proj_bias
        q, k, v = (t.reshape(b, l, h, hd).transpose(1, 2)
                   for t in qkv.split(d, dim=-1))
        att = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        if mask is not None:
            att = att + mask
        out = torch.softmax(att, dim=-1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(b, l, d))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, rng: torch.Generator | None = None):
        super().__init__()
        self.attn = MultiheadAttention(width, heads, rng)
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", _linear(width, width * 4, rng)),
            ("gelu", QuickGELU()),
            ("c_proj", _linear(width * 4, width, rng)),
        ]))
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int,
                 rng: torch.Generator | None = None):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, rng) for _ in range(layers))

    def forward(self, x, mask=None):
        for blk in self.resblocks:
            x = blk(x, mask)
        return x


class TextTransformer(nn.Module):
    """tokens (B, context_length) int → (B, output_dim)."""

    def __init__(self, context_length: int = 77, vocab_size: int = 49408,
                 width: int = 512, layers: int = 12, heads: int = 8,
                 output_dim: int = 512, rng: torch.Generator | None = None):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        with torch.no_grad():
            self.token_embedding.weight.copy_(
                _normal((vocab_size, width), 0.02, rng))
        self.positional_embedding = nn.Parameter(
            _normal((context_length, width), 0.01, rng))
        self.transformer = Transformer(width, layers, heads, rng)
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(
            _normal((width, output_dim), width ** -0.5, rng))
        self.register_buffer(
            "attn_mask",
            torch.full((context_length, context_length), float("-inf")).triu(1),
            persistent=False)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        tokens = tokens.long()
        x = self.token_embedding(tokens) + self.positional_embedding
        x = self.transformer(x, self.attn_mask)
        x = self.ln_final(x)
        eot = tokens.argmax(dim=-1)
        x = x[torch.arange(x.shape[0], device=x.device), eot]
        return x @ self.text_projection


class VisionTransformer(nn.Module):
    """x (B, H, W, 3) → (B, output_dim): a patch conv without bias, the class
    token, ``ln_pre``, the blocks, ``ln_post`` of the class token, ``proj``."""

    def __init__(self, input_resolution: int = 224, patch_size: int = 32,
                 width: int = 768, layers: int = 12, heads: int = 12,
                 output_dim: int = 512, rng: torch.Generator | None = None):
        super().__init__()
        scale = width ** -0.5
        n_patches = (input_resolution // patch_size) ** 2
        self.patch_size = patch_size
        self.conv1 = nn.Conv2d(3, width, patch_size, patch_size, bias=False)
        with torch.no_grad():
            self.conv1.weight.copy_(_normal(self.conv1.weight.shape,
                                            (3 * patch_size ** 2) ** -0.5, rng))
        self.class_embedding = nn.Parameter(_normal((width,), scale, rng))
        self.positional_embedding = nn.Parameter(
            _normal((n_patches + 1, width), scale, rng))
        self.ln_pre = nn.LayerNorm(width, eps=1e-5)
        self.transformer = Transformer(width, layers, heads, rng)
        self.ln_post = nn.LayerNorm(width, eps=1e-5)
        self.proj = nn.Parameter(_normal((width, output_dim), scale, rng))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x.permute(0, 3, 1, 2))            # (B, width, g, g)
        x = x.flatten(2).transpose(1, 2)                 # (B, g·g, width)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.transformer(self.ln_pre(x))
        return self.ln_post(x[:, 0, :]) @ self.proj


class CLIP(TextTransformer):
    """ViT-B/32 CLIP: the text tower's parameters at the top level (it is a
    ``TextTransformer``), the image tower as ``visual``, ``logit_scale``.
    ``encode_text(tokens)``, ``encode_image(image)``, and ``forward(image,
    tokens)`` → (logits_per_image, logits_per_text)."""

    def __init__(self, embed_dim: int = 512, image_resolution: int = 224,
                 vision_width: int = 768, vision_layers: int = 12,
                 vision_patch_size: int = 32, context_length: int = 77,
                 vocab_size: int = 49408, text_width: int = 512,
                 text_heads: int = 8, text_layers: int = 12,
                 vision_heads: int | None = None,
                 rng: torch.Generator | None = None):
        super().__init__(context_length, vocab_size, text_width, text_layers,
                         text_heads, embed_dim, rng)
        self.visual = VisionTransformer(
            image_resolution, vision_patch_size, vision_width, vision_layers,
            vision_heads or vision_width // 64, embed_dim, rng)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return super().forward(tokens)

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        return self.visual(image)

    def forward(self, image, tokens):
        img = self.encode_image(image)
        txt = self.encode_text(tokens)
        img = img / torch.linalg.norm(img, dim=-1, keepdim=True)
        txt = txt / torch.linalg.norm(txt, dim=-1, keepdim=True)
        logits_per_image = self.logit_scale.exp() * img @ txt.t()
        return logits_per_image, logits_per_image.t()


# keys of OpenAI's TorchScript archives that are not parameters
_CLIP_META_KEYS = ("input_resolution", "context_length", "vocab_size")


def load_clip_state(model: CLIP, state_dict: dict) -> CLIP:
    """Load an OpenAI CLIP state dict as it is (strict, but for the
    TorchScript archives' metadata entries)."""
    sd = {k: v for k, v in state_dict.items() if k not in _CLIP_META_KEYS}
    model.load_state_dict(sd)
    return model


def clip_from_state_dict(sd: dict) -> CLIP:
    """A ``CLIP`` shaped as an OpenAI state dict says (as OpenAI's
    ``build_model`` reads it), holding that state dict."""
    def blocks(prefix):
        return len({k.split(".")[2 + prefix.count(".")] for k in sd
                    if k.startswith(prefix + ".resblocks.")})

    vw = sd["visual.conv1.weight"].shape[0]
    patch = sd["visual.conv1.weight"].shape[-1]
    grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
    tw = sd["ln_final.weight"].shape[0]
    model = CLIP(embed_dim=sd["text_projection"].shape[1],
                 image_resolution=patch * grid, vision_width=vw,
                 vision_layers=blocks("visual.transformer"),
                 vision_patch_size=patch,
                 context_length=sd["positional_embedding"].shape[0],
                 vocab_size=sd["token_embedding.weight"].shape[0],
                 text_width=tw, text_heads=max(tw // 64, 1),
                 text_layers=blocks("transformer"),
                 vision_heads=max(vw // 64, 1), rng=torch.Generator())
    return load_clip_state(model, sd)


# torch-pixel preprocessing constants (OpenAI CLIP's _transform)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize_image(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] RGB NHWC → CLIP-normalised."""
    mean = torch.tensor(CLIP_MEAN, dtype=x.dtype).to(x.device, non_blocking=True)
    std = torch.tensor(CLIP_STD, dtype=x.dtype).to(x.device, non_blocking=True)
    return (x - mean) / std

"""CLIP ViT-B/32 text tower (counterpart of the text half of
where2edit_tpu/models/clip_model.py).

Parameter names follow OpenAI's CLIP state dict (``token_embedding.weight``,
``positional_embedding``, ``transformer.resblocks.{i}.*``, ``ln_final.*``,
``text_projection``), so the text keys of a reference checkpoint load as
they are. Attention is a plain matmul + softmax with an additive causal
mask; the output is read at the EOT position (the largest token id).
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

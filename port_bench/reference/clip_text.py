"""CLIP's text tower (Radford et al. 2021, ViT-B/32's: width 512, 12
layers, 8 heads, 77 positions) as plain formulas over an OpenAI-layout
state dict: token and position embeddings, pre-LayerNorm residual blocks
with causal multi-head attention and a QuickGELU MLP, the final LayerNorm,
the row at the end-of-text token (the largest id), and the projection."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _block(sd: dict, p: str, x, mask, heads: int):
    b, n, d = x.shape
    h = F.layer_norm(x, (d,), sd[f"{p}.ln_1.weight"], sd[f"{p}.ln_1.bias"], 1e-5)
    qkv = F.linear(h, sd[f"{p}.attn.in_proj_weight"], sd[f"{p}.attn.in_proj_bias"])
    q, k, v = (t.reshape(b, n, heads, d // heads).transpose(1, 2)
               for t in qkv.split(d, -1))
    att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d // heads) + mask, -1)
    o = (att @ v).transpose(1, 2).reshape(b, n, d)
    x = x + F.linear(o, sd[f"{p}.attn.out_proj.weight"], sd[f"{p}.attn.out_proj.bias"])
    h = F.layer_norm(x, (d,), sd[f"{p}.ln_2.weight"], sd[f"{p}.ln_2.bias"], 1e-5)
    h = F.linear(h, sd[f"{p}.mlp.c_fc.weight"], sd[f"{p}.mlp.c_fc.bias"])
    h = h * torch.sigmoid(1.702 * h)
    return x + F.linear(h, sd[f"{p}.mlp.c_proj.weight"], sd[f"{p}.mlp.c_proj.bias"])


def encode_text(sd: dict, cfg: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, 77) → (B, output_dim)."""
    tokens = tokens.long()
    n = tokens.shape[1]
    x = sd["token_embedding.weight"][tokens] + sd["positional_embedding"]
    mask = torch.full((n, n), float("-inf"), device=x.device).triu(1)
    for i in range(cfg["layers"]):
        x = _block(sd, f"transformer.resblocks.{i}", x, mask, cfg["heads"])
    x = F.layer_norm(x, (x.shape[-1],), sd["ln_final.weight"], sd["ln_final.bias"], 1e-5)
    x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(-1)]
    return x @ sd["text_projection"]

"""Seeded weights, drawn on the device in one call per model.

A configuration's ``init`` lists rules ``[pattern, kind, value]``, first
match by ``re.search`` on the state-dict key: ``normal`` draws value·N(0, 1),
``const`` fills value, ``fir`` is the normalised outer product of
[1, 3, 3, 1] times value. Every normal entry of a model is a slice of one
draw, in the order of the keys.
"""

from __future__ import annotations

import re

import torch


def _rule(rules: list, key: str) -> tuple:
    for pattern, kind, value in rules:
        if re.search(pattern, key):
            return kind, float(value)
    raise KeyError(f"no init rule matches {key!r}")


def draw(shapes: dict, rules: list, generator: torch.Generator, device) -> dict:
    """{key: tensor} for ``shapes`` {key: shape}, float32 on ``device``."""
    plan = [(k, tuple(s), *_rule(rules, k)) for k, s in shapes.items()]
    n = sum(torch.Size(s).numel() for _, s, kind, _ in plan if kind == "normal")
    flat = torch.randn(n, generator=generator, device=device)
    out, at = {}, 0
    fir = torch.tensor([1.0, 3.0, 3.0, 1.0], device=device)
    fir = torch.outer(fir, fir) / 64.0
    for key, shape, kind, value in plan:
        if kind == "normal":
            size = torch.Size(shape).numel()
            out[key] = flat[at:at + size].view(shape) * value
            at += size
        elif kind == "const":
            out[key] = torch.full(shape, value, device=device)
        elif kind == "fir":
            out[key] = (fir * value).reshape(shape).clone()
        else:
            raise ValueError(f"unknown init kind {kind!r} for {key!r}")
    return out


def shapes_of(module: torch.nn.Module) -> dict:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}

"""Where2edit's region-attention mapper training (the paper's phase 2,
attention/run_attention.py ``--work_in_stylespace --use_cluster``) as plain
formulas: one step from its draws.

1. Without gradient: the edit target (row 0 of the target draw, truncated
   towards the mean latent) captured with its styles and taps, and a
   conditioning batch synthesised and encoded by CLIP's image tower.
2. The mapper in training mode on the target's styles broadcast to the
   batch, with the attention text of row 0's region prompt; the edit
   synthesis from the edited styles, blended at the attention layer through
   the mapper's map.
3. InfoNCE (temperature 0.01) between the edited images' CLIP features and
   the conditioning features, the VGG16 relu2_2 perceptual loss against the
   target, and the mapper's delta, coverage and TV terms under the
   reference's ramps (its crossed names: ``lambda_ess`` weighs TV,
   ``lambda_sec`` coverage, ``lambda_id`` the perceptual loss).
4. Gradients of the mapper's trained parameters, those of the attention
   convs, their text affines and ``initial_*`` zeroed (the reference's
   freeze, which never lifts), and Adam as optax computes it at the
   ramped-cosine lr of its own update count (0 at the first update).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference import clip_image, edit, mapper, stylegan2, vgg


def lr_at(count: int, lr: float, total: int, rampdown: float = 0.25,
          rampup: float = 0.05) -> float:
    t = count / total
    ramp = min(1.0, (1.0 - t) / rampdown)
    ramp = 0.5 - 0.5 * math.cos(ramp * math.pi)
    return lr * ramp * min(1.0, t / rampup)


def trained(name: str) -> bool:
    """The mapper's trained parameters: all but the attention convs'
    modulation affines, which an S-space conv never applies."""
    return not (name.startswith("attention") and ".conv.modulation." in name)


def frozen(name: str) -> bool:
    return name.split(".")[0].startswith(("attention", "initial"))


class Trainer:
    def __init__(self, weights: dict, cfg: dict, train: dict, mean_latent):
        self.w, self.cfg, self.train = weights, cfg, train
        self.params = {k: v.detach().clone().requires_grad_(trained(k))
                       for k, v in weights["mapper"].items()}
        self.names = [k for k in self.params if trained(k)]
        self.mu = {k: torch.zeros_like(self.params[k]) for k in self.names}
        self.nu = {k: torch.zeros_like(self.params[k]) for k in self.names}
        self.count = 0
        self.mean = mean_latent

    def _wplus(self, z):
        g, gcfg = self.w["generator"], self.cfg["generator"]
        w = stylegan2.style_mlp(g, z, gcfg)
        w = self.mean + self.train["truncation"] * (w - self.mean)
        return w[:, None].expand(-1, stylegan2.n_latent(gcfg), -1)

    def _features(self, img):
        return clip_image.encode_image(self.w["clip"], self.cfg["clip_image"],
                                       clip_image.resize_224(img))

    def step(self, draws, step_idx: int, attention_bank) -> dict:
        """One step; returns its loss terms and the gradients of the
        trained parameters (the frozen ones zeroed)."""
        cond_z, target_z, att_idx = draws
        g, gcfg, tr = self.w["generator"], self.cfg["generator"], self.train
        mcfg = dict(self.cfg["mapper"], generator_size=gcfg["size"])
        b = cond_z.shape[0]
        t = step_idx / tr["step"]
        noise = stylegan2.fixed_noise(g, gcfg)
        tap_size, keep = edit.capture_taps(gcfg, mcfg)
        with torch.no_grad():
            att_text = attention_bank[att_idx[:1]].expand(b, -1)
            img2, styles, taps = stylegan2.synthesis(
                g, gcfg, self._wplus(target_z[:1]), stylespace_input=False, noise=noise,
                tap_size=tap_size, keep_taps=keep)
            img1, _, _ = stylegan2.synthesis(g, gcfg, self._wplus(cond_z),
                                             stylespace_input=False, noise=noise)
            cond = self._features(img1)
        styles = [s.expand(b, -1) for s in styles]
        taps = [None if x is None else x.expand(b, -1, -1, -1) for x in taps]
        const = g["input.input"].expand(b, -1, -1, -1)
        new_styles, amap, terms = mapper.train_forward(self.params, mcfg, cond, att_text,
                                                       styles, taps, const)
        img, _, _ = stylegan2.synthesis(g, gcfg, new_styles, stylespace_input=True,
                                        noise=noise, attention_layer=mcfg["attention_layer"],
                                        attention_map=amap, orig_taps=taps)
        consist, perceptual = self._losses(img, img2, cond)
        ramp_a = min(max((t - 0.15) / 0.1, 0.0), 1.0)
        ramp_b = min(max((t - 0.05) / 0.1, 0.0), 1.0)
        total = (consist + ramp_a * (tr["lambda_ess"] * terms["tv"]
                                     + tr["lambda_sec"] * terms["reg"])
                 + ramp_b * tr["lambda_id"] * perceptual + tr["lambda_delta"] * terms["delta"])
        gs = torch.autograd.grad(total, [self.params[k] for k in self.names], allow_unused=True)
        grads = {k: (torch.zeros_like(self.params[k]) if gr is None or frozen(k) else gr)
                 for k, gr in zip(self.names, gs)}
        self._adam(grads)
        out = {"loss": total, "consist": consist, "perceptual": perceptual, **terms}
        return {"losses": {k: float(v.detach()) for k, v in out.items()}, "grads": grads}

    def _losses(self, img, img2, cond) -> tuple:
        """(InfoNCE of the edited images' CLIP features against the
        conditioning features, the relu2_2 perceptual loss against the
        target)."""
        fi, fc = self._features(img), cond
        logits = (fi / fi.norm(dim=-1, keepdim=True)) @ (fc / fc.norm(dim=-1, keepdim=True)).t()
        consist = F.cross_entropy(logits / 0.01, torch.arange(img.shape[0], device=img.device))
        v = self.w["vgg"]
        perceptual = (vgg.relu2_2(v, clip_image.resize_224(img))
                      - vgg.relu2_2(v, clip_image.resize_224(img2))).square().mean()
        return consist, perceptual

    @torch.no_grad()
    def _adam(self, grads: dict, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        lr = lr_at(self.count, self.train["lr"], self.train["step"])
        self.count += 1
        n = np.float32(self.count)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** n)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** n)
        for k, gr in grads.items():
            self.mu[k].mul_(b1).add_(gr, alpha=1.0 - b1)
            self.nu[k].mul_(b2).addcmul_(gr, gr, value=1.0 - b2)
            upd = (self.mu[k] / bc1) / ((self.nu[k] / bc2).sqrt() + eps)
            self.params[k].add_(upd, alpha=-lr)

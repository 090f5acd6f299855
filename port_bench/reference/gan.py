"""StyleGAN2 training iterations as plain formulas (Karras et al. 2020):
non-saturating logistic losses, lazy R1 on the reals every ``d_reg_every``
iterations, lazy path-length regularisation every ``g_reg_every`` at half
the batch, style mixing, Adam with the lazy-regularisation correction
(lr·c, betas (0, 0.99^c), c = every/(every + 1)) and the generator's EMA.

The random draws of each program (z1, z2, the mixing index, the per-layer
noise and the path-length noise) and the real batches are inputs: the
benchmark hands both sides the same ones. Tensors cross this module NHWC
where they are images or noise, as the port takes them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from port_bench.reference import stylegan2


def is_buffer(key: str) -> bool:
    """State-dict entries that are not trained: the fixed noise and the FIR
    kernels."""
    return key.startswith("noises.") or key.endswith(".kernel")


class Adam:
    """torch.optim.Adam's arithmetic (no weight decay, no amsgrad). A leaf
    with no gradient takes no step, as torch.optim skips a parameter whose
    ``grad`` is None; so does one whose gradient is zero everywhere, which
    autograd gives here where a piecewise-linear derivative leaves no path
    (a bias under leaky ReLU in R1), and the port gives None."""

    def __init__(self, params: dict, lr: float, betas: tuple, eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.state = {}

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        b1, b2 = self.betas
        for k, g in grads.items():
            if g is None or not bool(g.any()):
                continue
            st = self.state.setdefault(k, {"t": 0, "m": torch.zeros_like(g),
                                           "v": torch.zeros_like(g)})
            st["t"] += 1
            st["m"].lerp_(g, 1 - b1)
            st["v"].mul_(b2).addcmul_(g, g, value=1 - b2)
            bc1 = 1 - b1 ** st["t"]
            bc2 = 1 - b2 ** st["t"]
            denom = (st["v"].sqrt() / math.sqrt(bc2)).add_(self.eps)
            self.params[k].addcdiv_(st["m"], denom, value=-self.lr / bc1)


def _adam(params: dict, lr: float, every: int) -> Adam:
    c = every / (every + 1) if every > 0 else 1.0
    return Adam(params, lr * c, (0.0, 0.99 ** c))


def _nchw(x):
    return x.permute(0, 3, 1, 2)


class Trainer:
    """G, D and the EMA generator as dicts of tensors, their optimizers and
    the running path length."""

    def __init__(self, g_state: dict, d_state: dict, cfg: dict, train: dict):
        self.cfg, self.train = cfg, train
        self.g = {k: v.detach().clone().requires_grad_(not is_buffer(k))
                  for k, v in g_state.items()}
        self.d = {k: v.detach().clone().requires_grad_(not is_buffer(k))
                  for k, v in d_state.items()}
        self.g_ema = {k: v.detach().clone() for k, v in g_state.items()}
        self.g_params = {k: v for k, v in self.g.items() if not is_buffer(k)}
        self.d_params = {k: v for k, v in self.d.items() if not is_buffer(k)}
        self.g_opt = _adam(self.g_params, train["lr"], train["g_reg_every"])
        self.d_opt = _adam(self.d_params, train["lr"], train["d_reg_every"])
        self.pl_mean = torch.zeros((), device=next(iter(g_state.values())).device)
        self.ema_beta = 0.5 ** (train["batch"] / (train["ema_kimg"] * 1000.0))
        self.step_index = 0

    def synthesize(self, draws):
        """(image NCHW, W+) from (z1, z2, inject, noise list NHWC)."""
        z1, z2, inject, noise = draws
        cfg = self.cfg
        w1 = stylegan2.style_mlp(self.g, z1, cfg)
        w2 = stylegan2.style_mlp(self.g, z2, cfg)
        rows = torch.arange(stylegan2.n_latent(cfg), device=z1.device)
        wplus = torch.where(rows[None, :, None] < inject, w1[:, None], w2[:, None])
        img, _, _ = stylegan2.synthesis(self.g, cfg, wplus, stylespace_input=False,
                                        noise=[_nchw(n) for n in noise])
        return img, wplus

    def _d(self, x, params=None):
        sd = self.d if params is None else params
        return stylegan2.discriminator(sd, self.cfg, x)

    def _grads(self, loss, params: dict) -> dict:
        keys = list(params)
        gs = torch.autograd.grad(loss, [params[k] for k in keys], allow_unused=True)
        return dict(zip(keys, gs))

    def iteration(self, real, d_draws, g_draws, path_draws=None, pl_noise=None) -> dict:
        """One iteration; returns its losses and each program's gradients
        (None where a program did not run)."""
        tr, out = self.train, {}
        real = _nchw(real)
        with torch.no_grad():
            fake, _ = self.synthesize(d_draws)
        loss = F.softplus(-self._d(real)).mean() + F.softplus(self._d(fake)).mean()
        grads = self._grads(loss, self.d_params)
        self.d_opt.step(grads)
        out["d_loss"], out["d_grads"] = loss.detach(), grads

        if tr["d_reg_every"] > 0 and self.step_index % tr["d_reg_every"] == 0:
            x = real.detach().requires_grad_(True)
            (gx,) = torch.autograd.grad(self._d(x).sum(), x, create_graph=True)
            loss = tr["r1"] / 2.0 * gx.square().sum((1, 2, 3)).mean() * tr["d_reg_every"]
            grads = self._grads(loss, self.d_params)
            self.d_opt.step(grads)
            out["r1"], out["r1_grads"] = loss.detach(), grads

        frozen = {k: v.detach() for k, v in self.d.items()}
        img, _ = self.synthesize(g_draws)
        loss = F.softplus(-self._d(img, frozen)).mean()
        grads = self._grads(loss, self.g_params)
        self.g_opt.step(grads)
        out["g_loss"], out["g_grads"] = loss.detach(), grads

        if tr["g_reg_every"] > 0 and self.step_index % tr["g_reg_every"] == 0:
            img, wplus = self.synthesize(path_draws)
            h, w = img.shape[2], img.shape[3]
            (gw,) = torch.autograd.grad((img * _nchw(pl_noise)).sum() / math.sqrt(h * w),
                                        wplus, create_graph=True)
            lengths = gw.square().sum(2).mean(1).sqrt()
            new_mean = (self.pl_mean + 0.01 * (lengths.detach().mean() - self.pl_mean)).detach()
            penalty = (lengths - new_mean).square().mean()
            self.pl_mean = new_mean
            loss = tr["path_regularize"] * tr["g_reg_every"] * penalty
            grads = self._grads(loss, self.g_params)
            self.g_opt.step(grads)
            out["path"], out["path_grads"] = loss.detach(), grads

        with torch.no_grad():
            for k, p in self.g_params.items():
                self.g_ema[k].lerp_(p, 1.0 - self.ema_beta)
        self.step_index += 1
        return out

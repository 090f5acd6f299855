"""StyleGAN2 adversarial training (counterpart of
where2edit_tpu/train/gan_trainer.py), on one card or data-parallel.

The standard StyleGAN2 objective: non-saturating logistic losses, lazy R1
on the reals every ``d_reg_every`` steps, lazy path-length regularisation
of the generator every ``g_reg_every`` steps, a generator EMA, and Adam with
the lazy-regularisation correction (StyleGAN2 App. B: lr·c, betas (0,
0.99^c), c = every/(every+1)). Each training iteration runs up to five
programs in order: ``d`` (the fake batch made without grad, then D on the
real and the fake batch separately, so each keeps its own minibatch-stddev
groups), ``r1``, ``g``, ``path`` and ``ema``.

R1 and the path length penalty take a gradient of a gradient; they go
through the kernels' autograd Functions (K1, K2, K3), whose backward is
itself differentiable. Every random draw (z, the mixing index, per-layer
noise, the path-length noise) comes from one ``torch.Generator`` on the
trainer's device; each program has a ``*_with`` form that takes its draws
explicitly (the tests feed both packages the same numbers) and one that
draws them.

Precision and memory levers, as the JAX trainer's: ``bf16`` synthesises in
bf16 and ``d_bf16`` runs the discriminator's tower in bf16 (the kernels'
bf16 forms; the losses, R1, the path penalty, the parameters, Adam's state
and the EMA stay fp32); ``remat`` recomputes the G program's synthesis in
its backward pass and ``d_remat`` each discriminator ``ResBlock``
(``torch.utils.checkpoint``); ``d_microbatch`` and ``g_microbatch`` run the
D and R1 programs, and the G program, over chunks of that many samples
with the mean of the chunk losses and gradients (the minibatch-stddev
groups per chunk, the reference's per-GPU semantics; the G chunks slice
one full-batch draw, so they see the latents the whole batch would; the
noise too is sliced from one full-batch draw, where the JAX trainer draws
each chunk's noise from a key of its own).

Data parallelism (``parallel/``): in a ``torch.distributed`` group each
rank runs the programs on its rows of the global batch (``batch_size`` is
the global batch) and the step is the single-process step on the global
batch, as the JAX trainer's sharded step is: every draw is the global draw,
made on every rank, of which each keeps its rows; the discriminator's
minibatch-stddev gathers the global batch (``global_stddev``); the
gradients are averaged over the ranks before each of the four optimizer
steps; ``pl_mean``'s running average and the metrics take the global
batch's means. The micro-batching levers are ignored in a group, as the
JAX trainer ignores them with a mesh.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from where2edit_tpu_torch import resolve_device
from where2edit_tpu_torch.models.stylegan2 import Discriminator, Generator
from where2edit_tpu_torch.parallel import dist
from where2edit_tpu_torch.utils import profiling


@dataclasses.dataclass
class GANTrainConfig:
    size: int = 1024
    batch_size: int = 8
    lr: float = 0.002
    r1: float = 10.0              # R1 gamma
    d_reg_every: int = 16         # lazy R1 cadence (0/neg disables)
    g_reg_every: int = 4          # lazy path-length cadence (0/neg disables)
    path_regularize: float = 2.0
    path_batch_shrink: int = 2    # path-length batch = batch_size // shrink
    mixing: float = 0.9           # style-mixing probability
    ema_kimg: float = 10.0        # EMA half-life in thousands of images
    channel_multiplier: int = 2
    bf16: bool = False            # bf16 synthesis (fp32 losses)
    remat: bool = False           # recompute the G program's synthesis
    d_bf16: bool = False          # bf16 discriminator tower (fp32 stddev,
    #                               losses)
    d_remat: bool = False         # recompute each D ResBlock
    d_microbatch: int = 0         # D and R1 over chunks of this many
    #                               samples (0 = the whole batch)
    g_microbatch: int = 0         # the G program over chunks likewise
    seed: int = 0


def logistic_d_loss(real_pred: torch.Tensor, fake_pred: torch.Tensor):
    """E[softplus(-D(real))] + E[softplus(D(fake))]."""
    return F.softplus(-real_pred).mean() + F.softplus(fake_pred).mean()


def logistic_g_loss(fake_pred: torch.Tensor):
    """E[softplus(-D(fake))]."""
    return F.softplus(-fake_pred).mean()


def r1_penalty(discriminator, real: torch.Tensor) -> torch.Tensor:
    """E_x[‖∇ₓD(x)‖²] over the real batch, differentiable in D's
    parameters (the gradient is taken with ``create_graph``)."""
    real = real.detach().requires_grad_(True)
    (grad,) = torch.autograd.grad(discriminator(real).sum(), real,
                                  create_graph=True)
    return grad.square().sum((1, 2, 3)).mean()


def path_length_penalty(img: torch.Tensor, wplus: torch.Tensor,
                        pl_mean: torch.Tensor, noise: torch.Tensor,
                        decay: float = 0.01):
    """StyleGAN2 §3 path length regulariser. ``img`` (B, H, W, 3) was made
    from ``wplus`` (B, L, 512) with its graph; ``noise`` is a standard normal
    draw of img's shape (scaled here by 1/√(HW)). Returns (penalty, lengths,
    new_mean): the penalty is taken against the updated running mean
    a + decay·(E[len] − a), which is returned detached."""
    h, w = img.shape[1], img.shape[2]
    (grad,) = torch.autograd.grad((img * noise).sum() / math.sqrt(h * w),
                                  wplus, create_graph=True)
    lengths = grad.square().sum(2).mean(1).sqrt()
    # the running mean follows the global batch's mean in a group
    new_mean = (pl_mean + decay * (dist.mean(lengths.detach().mean()) - pl_mean)).detach()
    return (lengths - new_mean).square().mean(), lengths, new_mean


class Draws(NamedTuple):
    """The random inputs of one synthesis: z1, z2 (B, 512), the mixing
    index (0-dim, n_latent = no mixing) and the per-layer noise list."""
    z1: torch.Tensor
    z2: torch.Tensor
    inject: torch.Tensor
    noise: list

    def chunk(self, n: int) -> list:
        """The draws of n equal batch chunks (the mixing index shared)."""
        z1s, z2s = self.z1.chunk(n), self.z2.chunk(n)
        noises = list(zip(*(nz.chunk(n) for nz in self.noise)))
        return [Draws(z1s[i], z2s[i], self.inject, list(noises[i]))
                for i in range(n)]


def n_chunks(batch: int, microbatch: int) -> int:
    """Chunks of ``microbatch`` samples in a batch, as the JAX trainer
    counts them: 1 unless microbatch divides the batch into several."""
    if microbatch and 0 < microbatch < batch and batch % microbatch == 0:
        return batch // microbatch
    return 1


def accumulate(loss_fn, chunks: list) -> torch.Tensor:
    """The mean of ``loss_fn`` over ``chunks`` (a list of argument tuples),
    its gradient accumulated into the parameters' ``.grad`` (each chunk's
    backward before the next chunk's forward, so one chunk's activations
    live at a time). Returns the mean loss, detached."""
    total = 0.0
    for args in chunks:
        loss = loss_fn(*args) / len(chunks)
        loss.backward()
        total = total + loss.detach()
    return total


def _adam(params, lr: float, every: int) -> torch.optim.Adam:
    c = every / (every + 1) if every > 0 else 1.0
    return torch.optim.Adam(params, lr=lr * c, betas=(0.0, 0.99 ** c), eps=1e-8)


class GANTrainer:
    """Owns G, D, the EMA generator, both optimizers, ``pl_mean`` and the
    draw generator ``rng``. ``step(real)`` runs one iteration on real images
    (batch, size, size, 3) in [-1, 1] on the trainer's device (in a
    data-parallel group, this rank's rows of the global batch). ``g_state``,
    a generator state dict, replaces G's seeded initial weights (a warm
    start; the EMA generator starts from it too)."""

    def __init__(self, cfg: GANTrainConfig, device=None, g_state: dict | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        init = torch.Generator().manual_seed(cfg.seed)
        self.g = Generator(cfg.size, channel_multiplier=cfg.channel_multiplier,
                           rng=init, dtype=torch.bfloat16 if cfg.bf16
                           else torch.float32).to(self.device)
        self.d = Discriminator(cfg.size, cfg.channel_multiplier, rng=init,
                               dtype=torch.bfloat16 if cfg.d_bf16 else torch.float32,
                               remat=cfg.d_remat).to(self.device)
        if g_state is not None:
            self.g.load_state_dict(g_state)
        self.g_ema = copy.deepcopy(self.g).requires_grad_(False)
        self.g_opt = _adam(self.g.parameters(), cfg.lr, cfg.g_reg_every)
        self.d_opt = _adam(self.d.parameters(), cfg.lr, cfg.d_reg_every)
        self.pl_mean = torch.zeros((), device=self.device)
        self.ema_beta = 0.5 ** (cfg.batch_size / max(cfg.ema_kimg * 1000.0, 1e-8))
        self.rng = torch.Generator(self.device).manual_seed(cfg.seed + 1)
        self.global_step = 0
        self.metrics: dict = {}
        ranks = dist.data_world()
        if cfg.batch_size % ranks or (cfg.g_reg_every > 0 and self.path_batch() % ranks):
            raise ValueError(f"the batch {cfg.batch_size} and the path-length batch "
                             f"{self.path_batch()} must split over {ranks} ranks")
        self.d.global_stddev = dist.in_group()
        if dist.in_group() and (cfg.d_microbatch or cfg.g_microbatch):
            print("[dp] --d_microbatch/--g_microbatch ignored in a data-parallel "
                  "group, as the JAX trainer ignores them with a mesh")

    # ----------------------------------------------------------------- draws
    def draw(self, batch: int) -> Draws:
        """The draws of a global batch of ``batch``; this rank's rows of
        them in a group."""
        g, r, dev = self.g, self.rng, self.device
        z1 = torch.randn(batch, g.style_dim, generator=r, device=dev)
        z2 = torch.randn(batch, g.style_dim, generator=r, device=dev)
        mixed = torch.rand((), generator=r, device=dev) < self.cfg.mixing
        inject = torch.where(mixed, torch.randint(1, g.n_latent, (), generator=r,
                                                  device=dev), g.n_latent)
        noise = [torch.randn(batch, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2), 1,
                             generator=r, device=dev)
                 for i in range(g.num_layers)]
        return Draws(dist.rows(z1), dist.rows(z2), inject, [dist.rows(n) for n in noise])

    def synthesize(self, draws: Draws, remat: bool = False):
        """(image, W+) of the generator from ``draws``, style-mixed; with
        ``remat`` the synthesis from W+ keeps no activations for its
        backward pass but recomputes them there."""
        g = self.g
        wplus = g.mix_latents(g.style_mlp(draws.z1), g.style_mlp(draws.z2),
                              draws.inject)
        if remat:
            img = checkpoint(self._synthesis, wplus, *draws.noise, use_reentrant=False)
        else:
            img = self._synthesis(wplus, *draws.noise)
        return img, wplus

    def _synthesis(self, wplus: torch.Tensor, *noise: torch.Tensor) -> torch.Tensor:
        return self.g([wplus], input_is_latent=True, noise=list(noise)).image

    # -------------------------------------------------------------- programs
    def _chunks(self, microbatch: int) -> int:
        return 1 if dist.in_group() else n_chunks(self.cfg.batch_size, microbatch)

    def d_step_with(self, real: torch.Tensor, draws: Draws) -> torch.Tensor:
        with torch.no_grad():
            fake, _ = self.synthesize(draws)
        n = self._chunks(self.cfg.d_microbatch)
        self.d_opt.zero_grad(set_to_none=True)
        loss = accumulate(lambda r, f: logistic_d_loss(self.d(r), self.d(f)),
                          list(zip(real.chunk(n), fake.chunk(n))))
        dist.all_reduce_grads(self.d.parameters())
        self.d_opt.step()
        return loss

    def r1_step(self, real: torch.Tensor) -> torch.Tensor:
        # lazy cadence: applied every d_reg_every steps, scaled back up
        cfg = self.cfg
        n = self._chunks(cfg.d_microbatch)
        self.d_opt.zero_grad(set_to_none=True)
        loss = accumulate(lambda r: cfg.r1 / 2.0 * r1_penalty(self.d, r) * cfg.d_reg_every,
                          [(r,) for r in real.chunk(n)])
        dist.all_reduce_grads(self.d.parameters())
        self.d_opt.step()
        return loss

    def g_step_with(self, draws: Draws) -> torch.Tensor:
        cfg = self.cfg
        n = self._chunks(cfg.g_microbatch)
        self.d.requires_grad_(False)  # D's weights get no gradient here
        try:
            self.g_opt.zero_grad(set_to_none=True)
            loss = accumulate(
                lambda d: logistic_g_loss(self.d(self.synthesize(d, remat=cfg.remat)[0])),
                [(d,) for d in draws.chunk(n)])
        finally:
            self.d.requires_grad_(True)
        dist.all_reduce_grads(self.g.parameters())
        self.g_opt.step()
        return loss

    def path_step_with(self, draws: Draws, pl_noise: torch.Tensor):
        """Returns (loss, mean path length); updates ``pl_mean``."""
        img, wplus = self.synthesize(draws)
        penalty, lengths, self.pl_mean = path_length_penalty(
            img, wplus, self.pl_mean, pl_noise)
        loss = self.cfg.path_regularize * self.cfg.g_reg_every * penalty
        self.g_opt.zero_grad(set_to_none=True)
        loss.backward()
        dist.all_reduce_grads(self.g.parameters())
        self.g_opt.step()
        return loss.detach(), lengths.mean().detach()

    @torch.no_grad()
    def ema_step(self) -> None:
        for e, p in zip(self.g_ema.parameters(), self.g.parameters()):
            e.lerp_(p, 1.0 - self.ema_beta)

    def path_batch(self) -> int:
        return max(1, self.cfg.batch_size // max(self.cfg.path_batch_shrink, 1))

    # ------------------------------------------------------------- iteration
    @profiling.spanned("trainer.gan.step")
    def step(self, real: torch.Tensor, span=None) -> dict:
        """One iteration: d, lazy r1, g, lazy path, ema. Returns the scalar
        metrics of what ran as device tensors (read them only when logging,
        so the host keeps queueing work), also kept as ``self.metrics`` while
        the iteration fills them in. ``span(program, trainer)`` is a context
        manager around each program; by default the tracer's
        ``trainer.gan.<program>``."""
        cfg = self.cfg
        span = span or profiling.stage_spans("trainer.gan")
        m = self.metrics = {}
        with span("d", self):
            m["d_loss"] = self.d_step_with(real, self.draw(cfg.batch_size))
        if cfg.d_reg_every > 0 and self.global_step % cfg.d_reg_every == 0:
            with span("r1", self):
                m["r1"] = self.r1_step(real)
        with span("g", self):
            m["g_loss"] = self.g_step_with(self.draw(cfg.batch_size))
        if cfg.g_reg_every > 0 and self.global_step % cfg.g_reg_every == 0:
            with span("path", self):
                batch = self.path_batch()
                draws = self.draw(batch)
                pl_noise = dist.rows(torch.randn(batch, cfg.size, cfg.size, 3,
                                                 generator=self.rng, device=self.device))
                m["path"], m["path_length"] = self.path_step_with(draws, pl_noise)
        m.update(dist.mean_scalars(m))  # the global batch's means in a group
        with span("ema", self):
            self.ema_step()
        self.global_step += 1
        return m

"""StyleCLIP latent-mapper training on one card (counterpart of
where2edit_tpu/train/coach.py), fp32.

One step, in the JAX step's order:

1. ``x``, the batch decoded without gradient (W+ rows, or with
   ``work_in_stylespace`` the batch's S-space vectors), fixed noise;
2. ``w_hat = w + 0.1·mapper(w)`` (per style vector in S-space);
3. ``x_hat``, ``w_hat`` decoded with the same noise;
4. the losses: ArcFace ``IDLoss(x_hat, x)``, CLIP ``mean(1 - logits / 100)``
   against the description, and the latent L2 (in S-space the sum of the
   per-vector means), each under its λ;
5. the backward into the mapper alone: the generator, CLIP and ArcFace are
   frozen (``requires_grad_(False)``, ``eval()``), so K1 keeps its prepared
   weights and the backward through the generator computes input and style
   gradients only;
6. the Ranger step (``optim_name="adam"``: ``MapperAdam``, Adam as optax
   computes it, at the constant lr).

The train loop is the JAX loop: ``while global_step <= max_steps``;
validation at every ``val_interval`` and at ``max_steps`` (the first one, at
step 0, is a sanity pass that returns None after 5 batches); checkpoints
``best_model.pt``, ``iteration_{step}.pt`` and ``timestamp.txt``; a
``stop_fn`` that returns True leaves ``preempt.pt``.

Departures from the JAX coach: the self-sampled latents are drawn from a
``torch.Generator`` on the card seeded with ``seed`` (so they differ from
the JAX draws), only through the mapping network (the JAX call's synthesis
is dead code that XLA drops); the S-space batches come from
``Generator.stylespace`` for the same reason; the shuffle order is drawn
from a seeded CPU ``torch.Generator`` whose state at the start of each
epoch, with the position in the epoch, rides in the checkpoint (the JAX
loop draws from numpy's global state and a resume starts a new epoch), so
a resumed run takes the batches an uninterrupted one would.

``span(stage, coach)``, when given, is a context manager around each stage
of a training step (decode, mapper, edit, id, clip, backward, optim), around
the latent sampling (sample) and around each validation (validate).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Optional

import torch

from where2edit_tpu_torch.train.attention_trainer import MapperAdam
from where2edit_tpu_torch.train.checkpoints import save_coach_checkpoint
from where2edit_tpu_torch.train.ranger import Ranger
from where2edit_tpu_torch.utils.images import save_image_grid
from where2edit_tpu_torch.utils.logging import MetricsWriter

TRUNCATION = 0.7


@dataclasses.dataclass
class CoachConfig:
    """mapper/options/train_options.py defaults."""
    exp_dir: str = "experiments/run"
    description: str = "a person with purple hair"
    mapper_type: str = "LevelsMapper"
    work_in_stylespace: bool = False
    batch_size: int = 2
    test_batch_size: int = 1
    train_dataset_size: int = 5000
    test_dataset_size: int = 1000
    learning_rate: float = 0.5
    optim_name: str = "ranger"
    id_lambda: float = 0.1
    clip_lambda: float = 1.0
    latent_l2_lambda: float = 0.8
    stylegan_size: int = 1024
    max_steps: int = 50000
    board_interval: int = 50
    image_interval: int = 100
    save_interval: Optional[int] = None
    val_interval: int = 2000
    seed: int = 0


def _nullspan(stage, coach):
    return contextlib.nullcontext()


class Coach:
    """Trains ``mapper`` against a frozen ``generator``, ``clip_loss``
    (``CLIPLoss``) and ``id_loss`` (``IDLoss``; either may be None), on the
    generator's device. ``latent_avg`` (1, 512) is the truncation centre of
    self-sampled latents; ``text_tokens`` (1, 77) the description's tokens;
    ``train_latents`` / ``test_latents`` (N, n_latent, 512) replace the
    self-sampled sets; ``opts`` is what checkpoints store as their options
    (the config's fields by default)."""

    def __init__(self, config: CoachConfig, *, generator, mapper,
                 clip_loss=None, id_loss=None,
                 latent_avg: Optional[torch.Tensor] = None,
                 text_tokens: Optional[torch.Tensor] = None,
                 train_latents=None, test_latents=None,
                 opts: Optional[dict] = None, span=None):
        self.cfg = config
        self.generator = generator.eval().requires_grad_(False)
        self.device = generator.device
        if clip_loss is not None:
            clip_loss.model.eval().requires_grad_(False)
        if id_loss is not None:
            id_loss.facenet.eval().requires_grad_(False)
        self.clip_loss = clip_loss
        self.id_loss = id_loss
        self.mapper = mapper
        self.latent_avg = latent_avg
        self.text_tokens = text_tokens
        self.opts = dict(opts) if opts is not None else dataclasses.asdict(config)
        self.span = span or _nullspan
        self.global_step = 0
        self.best_val_loss = None
        self.draw_rng = torch.Generator(self.device).manual_seed(config.seed)
        self.shuffle_rng = torch.Generator().manual_seed(config.seed)
        self.epoch_pos = 0
        self._epoch_state = None

        params = list(mapper.parameters())
        if config.optim_name == "adam":
            self.opt = MapperAdam(params, lambda count: config.learning_rate)
        else:
            self.opt = Ranger(params, lr=config.learning_rate)

        with self.span("sample", self):
            self.train_latents = self._latents(train_latents,
                                               config.train_dataset_size)
            self.test_latents = self._latents(test_latents,
                                              config.test_dataset_size)

        os.makedirs(os.path.join(config.exp_dir, "checkpoints"), exist_ok=True)
        self.log_dir = os.path.join(config.exp_dir, "logs")
        self.metrics = MetricsWriter(self.log_dir)

    # ------------------------------------------------------------------ data
    def _latents(self, given, n: int) -> torch.Tensor:
        if given is None:
            return self._generate_latents(n)
        return torch.as_tensor(given, dtype=torch.float32).to(self.device)

    @torch.no_grad()
    def _generate_latents(self, n: int) -> torch.Tensor:
        """Self-sampled W+ (n, n_latent, 512): z from the draw generator
        through the mapping network, truncated 0.7 about ``latent_avg``,
        broadcast to every row; in chunks of max(batch, 8)."""
        if self.latent_avg is None:
            raise ValueError("sampling latents needs latent_avg")
        g = self.generator
        bs = max(self.cfg.batch_size, 8)
        chunks = []
        for i in range(0, n, bs):
            z = torch.randn(min(bs, n - i), g.style_dim, generator=self.draw_rng,
                            device=self.device)
            w = g.style_mlp(z)
            w = self.latent_avg + TRUNCATION * (w - self.latent_avg)
            chunks.append(w[:, None, :].expand(-1, g.n_latent, -1))
        return torch.cat(chunks)

    def _batches(self, latents: torch.Tensor, batch_size: int, shuffle: bool,
                 start: int = 0):
        """The batches of one epoch from batch ``start`` on (a shuffled
        epoch draws its order from the shuffle generator first); S-space
        vectors with ``work_in_stylespace``."""
        n = len(latents) // batch_size * batch_size
        order = (torch.randperm(len(latents), generator=self.shuffle_rng)[:n]
                 if shuffle else torch.arange(n))
        for i in range(start * batch_size, n, batch_size):
            w = latents[order[i:i + batch_size].to(latents.device)]
            if self.cfg.work_in_stylespace:
                with torch.no_grad():
                    w = self.generator.stylespace(w)
            yield w

    def epoch_rng_state(self) -> torch.Tensor:
        """The shuffle generator's state at the start of the current epoch
        (its state now before the first epoch)."""
        return (self._epoch_state if self._epoch_state is not None
                else self.shuffle_rng.get_state())

    # ------------------------------------------------------------------ step
    def _decode(self, w) -> torch.Tensor:
        if self.cfg.work_in_stylespace:
            return self.generator(w, input_is_stylespace=True,
                                  randomize_noise=False).image
        return self.generator([w], input_is_latent=True,
                              randomize_noise=False).image

    def edit_latent(self, w):
        """``w + 0.1·mapper(w)``, per style vector in S-space."""
        if self.cfg.work_in_stylespace:
            return [c + 0.1 * d for c, d in zip(w, self.mapper(w))]
        return w + 0.1 * self.mapper(w)

    def _losses(self, w, x, w_hat, x_hat, span=None):
        """(total, {name: scalar tensor}) as the JAX ``_losses``."""
        cfg = self.cfg
        span = span or (lambda stage: contextlib.nullcontext())
        loss = torch.zeros((), device=self.device)
        aux = {}
        if cfg.id_lambda > 0 and self.id_loss is not None:
            with span("id"):
                loss_id, _ = self.id_loss(x_hat, x)
            aux["loss_id"] = loss_id
            loss = loss + loss_id * cfg.id_lambda
        if cfg.clip_lambda > 0 and self.clip_loss is not None:
            with span("clip"):
                loss_clip = self.clip_loss(x_hat, self.text_tokens).mean()
            aux["loss_clip"] = loss_clip
            loss = loss + loss_clip * cfg.clip_lambda
        if cfg.latent_l2_lambda > 0:
            if cfg.work_in_stylespace:
                l2 = sum((ch - c).square().mean() for ch, c in zip(w_hat, w))
            else:
                l2 = (w_hat - w).square().mean()
            aux["loss_l2_latent"] = l2
            loss = loss + l2 * cfg.latent_l2_lambda
        aux["loss"] = loss
        return loss, aux

    def step(self, w) -> tuple:
        """One training step on the batch ``w``; updates the mapper in
        place. Returns ({name: scalar device tensor}, x)."""
        def span(stage):
            return self.span(stage, self)

        with span("decode"), torch.no_grad():
            x = self._decode(w)
        with span("mapper"):
            w_hat = self.edit_latent(w)
        with span("edit"):
            x_hat = self._decode(w_hat)
        loss, aux = self._losses(w, x, w_hat, x_hat, span)
        with span("backward"):
            self.mapper.zero_grad(set_to_none=True)
            loss.backward()
        with span("optim"):
            if isinstance(self.opt, MapperAdam):
                self.opt.step([torch.zeros_like(p) if p.grad is None else p.grad
                               for p in self.opt.params])
            else:
                self.opt.step()
        return {k: v.detach() for k, v in aux.items()}, x

    @torch.no_grad()
    def evaluate(self, w) -> tuple:
        """(losses, x, x_hat) of a validation batch, without an update."""
        x = self._decode(w)
        w_hat = self.edit_latent(w)
        x_hat = self._decode(w_hat)
        _, aux = self._losses(w, x, w_hat, x_hat)
        return aux, x, x_hat

    # ----------------------------------------------------------------- loops
    def train(self, stop_fn: Optional[Callable[[], bool]] = None):
        """The JAX loop. ``stop_fn`` is polled before each step; True ends
        training with a ``preempt.pt`` checkpoint and returns
        "preempted"."""
        cfg = self.cfg
        save_interval = cfg.save_interval or cfg.max_steps
        while self.global_step <= cfg.max_steps:
            self._epoch_state = self.shuffle_rng.get_state()
            start = self.epoch_pos
            batches = self._batches(self.train_latents, cfg.batch_size, True, start)
            for pos, w in enumerate(batches, start):
                self.epoch_pos = pos
                if stop_fn is not None and stop_fn():
                    self.checkpoint({"preempted_at": self.global_step},
                                    is_best=False, name="preempt")
                    return "preempted"
                t0 = time.time()
                aux, _ = self.step(w)
                is_board = self.global_step % cfg.board_interval == 0
                is_val = (self.global_step % cfg.val_interval == 0
                          or self.global_step == cfg.max_steps)
                is_save = (self.global_step % save_interval == 0
                           or self.global_step == cfg.max_steps)
                if is_board or is_save:  # the loop's only per-step syncs
                    aux = {k: float(v) for k, v in aux.items()}
                    aux["step_time"] = time.time() - t0
                if is_board:
                    for k, v in aux.items():
                        self.metrics.add_scalar(f"train/{k}", v, self.global_step)
                val = None
                if is_val:
                    with self.span("validate", self):
                        val = self.validate()
                    if val and (self.best_val_loss is None
                                or val["loss"] < self.best_val_loss):
                        self.best_val_loss = val["loss"]
                        self.checkpoint(val, is_best=True)
                if is_save:
                    self.checkpoint(val or aux, is_best=False)
                if self.global_step == cfg.max_steps:
                    return None
                self.global_step += 1
            self.epoch_pos = 0
        return None

    def validate(self) -> Optional[dict]:
        """Mean losses over the test set (at most 201 batches); the first
        batch's x | x_hat grid under ``logs/images_val``. At step 0 a sanity
        pass: None after 5 batches."""
        agg = []
        for i, w in enumerate(self._batches(self.test_latents,
                                            self.cfg.test_batch_size, False)):
            if i > 200:
                break
            aux, x, x_hat = self.evaluate(w)
            agg.append({k: float(v) for k, v in aux.items()})
            if i == 0:
                path = os.path.join(self.log_dir, "images_val",
                                    f"{self.global_step:05d}.jpg")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                save_image_grid(torch.cat([x, x_hat]), path,
                                nrow=self.cfg.test_batch_size, scale_each=True)
            if self.global_step == 0 and i >= 4:
                return None
        mean = {k: sum(a[k] for a in agg) / len(agg) for k in agg[0]}
        for k, v in mean.items():
            self.metrics.add_scalar(f"test/{k}", v, self.global_step)
        return mean

    def checkpoint(self, loss_dict: dict, is_best: bool, name: str = "") -> str:
        """``checkpoints/{name}.pt`` (``best_model``, else
        ``iteration_{step}``) and a line of ``timestamp.txt``."""
        name = name or ("best_model" if is_best
                        else f"iteration_{self.global_step}")
        ckpt_dir = os.path.join(self.cfg.exp_dir, "checkpoints")
        path = save_coach_checkpoint(os.path.join(ckpt_dir, f"{name}.pt"), self)
        with open(os.path.join(ckpt_dir, "timestamp.txt"), "a") as f:
            tag = "**Best**: " if is_best else ""
            f.write(f"{tag}Step - {self.global_step}, \n{loss_dict}\n")
        return path

"""Region-attention training (the paper's phase 2) on one card or
data-parallel (counterpart of where2edit_tpu/train/attention_trainer.py),
fp32.

One step, as the JAX step computes it:

1. two syntheses without gradient: a conditioning batch (image only) and the
   edit target, whose row 0 every sample edits (the reference's
   ``dist.broadcast(src=0)``; only that row is synthesised here, the
   batch then reads it broadcast), with the mapper's taps and the const
   input appended;
2. the conditioning features: CLIP image features of the first batch, or
   rows of a text bank;
3. the mapper in training mode: an S-space one on the target's styles
   (zero attention-conv noise), or (``work_in_stylespace=False``) a W+ one
   on its W+, whose delta is added at strength one; then the edit
   synthesis from the edited styles or W+, blended at ``attention_layer``
   through the mapper's map;
4. InfoNCE between the edited images' CLIP features and the conditioning
   features, the VGG perceptual loss against the target, and the mapper's
   delta / coverage / TV terms under the reference's ramps and crossed
   names;
5. the backward into the mapper alone (generator, CLIP and VGG are frozen:
   ``requires_grad_(False)``, so K1 keeps its prepared weights and no
   kernel computes a generator weight gradient), the freeze mask on the
   ``attention*`` / ``initial*`` parameters (the W+ trunk's flat
   ``attention_*`` convs among them; ``freeze_attention_until``
   1.15: they never unfreeze in the reference run), and Adam as optax
   computes it, at the lr of ``styleclip_lr_schedule`` at Adam's own count
   (0 at the first update).

Every random input of a step is in ``Draws``; ``step_with(draws, ...)``
takes them explicitly (the tests feed both packages the same numbers) and
``step`` draws them from one ``torch.Generator`` on the trainer's device.

Data parallelism (``parallel/``): in a ``torch.distributed`` group
``batch_size`` is the global batch. Every rank makes the global draws and
keeps its rows of the conditioning batch (every rank holds the row-0 target
and region prompt, so nothing is broadcast); the InfoNCE gathers the image
and condition features with their gradient; the mapper's gradients are
averaged over the ranks before Adam; the loss terms are the global batch's,
so the NaN guard decides the same on every rank. One step is then the
single-process step on the global batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from where2edit_tpu_torch.demo.api import synthesize_edit
from where2edit_tpu_torch.editing.attention_mappers import tap_controls
from where2edit_tpu_torch.losses.infonce import infonce_consistency
from where2edit_tpu_torch.parallel import dist
from where2edit_tpu_torch.train.lr import styleclip_lr_schedule
from where2edit_tpu_torch.utils import profiling


@dataclasses.dataclass
class AttentionTrainConfig:
    """attention/run_attention.py:1549-1605 defaults (global batch)."""
    stylegan_size: int = 1024
    attention_layer: int = 8
    cluster_layer: int = 13
    batch_size: int = 1
    lr: float = 0.1
    lambda_ess: float = 0.6
    lambda_sec: float = 0.6
    lambda_id: float = 0.3
    lambda_delta: float = 0.008
    step: int = 300
    truncation: float = 0.7
    work_in_stylespace: bool = False
    freeze_attention_until: float = 1.15   # reference quirk: never unfreezes
    seed: int = 200
    remat: bool = False  # recompute the grad-pass synthesis in the backward pass


class Draws(NamedTuple):
    """The random inputs of one step.

    cond: the conditioning batch's z (B, 512); with a latent bank its row
      indices (B,); with a text bank the text bank's row indices (B,). B is
      this rank's rows in a data-parallel group (the batch of the step).
    target: the edit target's z (B, 512) or latent-bank rows (B,); only
      row 0 is used.
    att_idx: (B,) indices into the region-prompt bank; only row 0 is used.
    """
    cond: torch.Tensor
    target: torch.Tensor
    att_idx: torch.Tensor


def is_attention_param(name: str) -> bool:
    """The reference's freeze set: module names starting with 'attention'
    or 'initial'."""
    return name.split(".")[0].startswith(("attention", "initial"))


def trainable_parameters(mapper) -> list:
    """(name, parameter) of the mapper's trained parameters: every one but
    the S-space attention convs' ``conv.modulation`` (their input is a style
    vector, so the modulation is never applied; the JAX mapper has none)."""
    return [(n, p) for n, p in mapper.named_parameters()
            if not (n.startswith("attention") and ".conv.modulation." in n)]


class MapperAdam:
    """Adam as ``optax.adam(schedule)`` computes it: mu and nu in optax's
    order, bias corrections 1 - b**count in float32, and the lr the schedule
    gives at the update count before this update."""

    def __init__(self, params, schedule: Callable[[int], float],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: list) -> None:
        """Apply one update from ``grads`` (one per parameter)."""
        lr = float(self.schedule(self.count))
        self.count += 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        n = np.float32(self.count)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** n)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** n)
        upd = torch._foreach_div(self.mu, bc1)
        den = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.params, upd)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        torch._foreach_copy_(self.mu, [t.to(m.device) for t, m in zip(state["mu"], self.mu)])
        torch._foreach_copy_(self.nu, [t.to(m.device) for t, m in zip(state["nu"], self.nu)])


class AttentionTrainer:
    """Trains ``mapper`` (an S-space mapper, or with
    ``cfg.work_in_stylespace`` False a W+ one) against a frozen
    ``generator``, ``clip_loss`` (``CLIPLoss``: image features) and
    ``perceptual`` (``PerceptualLoss``), all on one device.

    ``latent_bank`` (N, n_latent, 512): synthesise from random rows of
    pre-inverted W+ codes instead of truncated z samples. ``text_bank``
    (K, 512): condition on random rows of CLIP text encodings instead of
    image features (skips the conditioning synthesis and CLIP pass).
    ``span(stage, trainer)`` is a context manager around each stage of a
    step: synthesis, cond_clip, mapper, edit, losses, backward, adam; by
    default the tracer's ``trainer.attention.<stage>``.
    """

    def __init__(self, cfg: AttentionTrainConfig, *, generator, mapper,
                 clip_loss, perceptual, mean_latent: torch.Tensor,
                 latent_bank: Optional[torch.Tensor] = None,
                 text_bank: Optional[torch.Tensor] = None, span=None):
        self.cfg = cfg
        self.generator = generator.requires_grad_(False)
        clip_loss.model.requires_grad_(False)
        perceptual.vgg.requires_grad_(False)
        self.mapper = mapper
        self.clip_loss = clip_loss
        self.perceptual = perceptual
        self.device = generator.device
        self.mean_latent = mean_latent
        self.latent_bank = latent_bank
        self.text_bank = text_bank
        self.span = span or profiling.stage_spans("trainer.attention")
        named = trainable_parameters(mapper)
        trained = {n for n, _ in named}
        for n, p in mapper.named_parameters():
            p.requires_grad_(n in trained)
        self.param_names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.frozen = [i for i, n in enumerate(self.param_names)
                       if is_attention_param(n)]
        self.opt = MapperAdam(self.params, styleclip_lr_schedule(cfg.lr, cfg.step))
        self.rng = torch.Generator(self.device).manual_seed(cfg.seed)
        self.draws_taken = 0
        self.steps_completed = 0
        self.tap_subsample, self.tap_indices = tap_controls(
            cfg.stylegan_size, cfg.attention_layer, cfg.cluster_layer)
        self._good = None

    # ------------------------------------------------------------- draws
    def draw(self, n_prompts: int) -> Draws:
        b, r, dev = self.cfg.batch_size, self.rng, self.device

        def rows(n):
            return torch.randint(0, n, (b,), generator=r, device=dev)

        def z():
            return torch.randn(b, self.generator.style_dim, generator=r, device=dev)

        bank = self.latent_bank
        if self.text_bank is not None:
            cond = rows(self.text_bank.shape[0])
        else:
            cond = z() if bank is None else rows(bank.shape[0])
        target = z() if bank is None else rows(bank.shape[0])
        self.draws_taken += 1
        return Draws(dist.rows(cond), target, rows(n_prompts))

    # ------------------------------------------------------------- plumbing
    def _wplus(self, sel: torch.Tensor) -> torch.Tensor:
        """z (B, 512) → truncated W+, or latent-bank rows (no truncation:
        the codes are W+ already)."""
        if self.latent_bank is not None:
            return self.latent_bank[sel]
        g = self.generator
        w = g.style_mlp(sel)
        w = self.mean_latent + self.cfg.truncation * (w - self.mean_latent)
        return w[:, None, :].expand(-1, g.n_latent, -1)

    def _capture(self, wplus):
        """(image, the mapper's latent: S-space styles or the W+, the
        mapper's taps + the const input)."""
        g = self.generator
        out = g([wplus], input_is_latent=True, randomize_noise=False,
                return_features=True, tap_subsample=self.tap_subsample,
                tap_indices=self.tap_indices)
        latent = out.style_vector if self.cfg.work_in_stylespace else wplus
        return out.image, latent, list(out.feature_map) + [g.input(wplus.shape[0])]

    def mapper_forward(self, cond, latent, feats, attention_text, train: bool = True):
        """(the synthesis input, the mapper's output): edited styles, or
        ``latent + delta`` in W+."""
        blend_size = feats[self.cfg.attention_layer - 1].shape[1]
        if self.cfg.work_in_stylespace:
            mo = self.mapper(cond, latent, feats, blend_size,
                             attention_text=attention_text, train=train,
                             deterministic_noise=True)
            return mo.latents, mo
        mo = self.mapper(cond, latent, feats, blend_size,
                         attention_text=attention_text, train=train)
        return latent + mo.latents, mo

    def synthesize(self, new_latents, amap, feats) -> torch.Tensor:
        """The edit synthesis, blended at the attention layer; with
        ``cfg.remat`` its activations are recomputed in the backward pass
        instead of kept (the same numbers, one more forward)."""
        if self.cfg.remat:
            return checkpoint(self._synthesize, new_latents, amap, feats,
                              use_reentrant=False)
        return self._synthesize(new_latents, amap, feats)

    def _synthesize(self, new_latents, amap, feats) -> torch.Tensor:
        return synthesize_edit(generator=self.generator, new_latents=new_latents,
                               attention_map=amap, feature_map=feats,
                               attention_layer=self.cfg.attention_layer,
                               work_in_stylespace=self.cfg.work_in_stylespace)

    # ----------------------------------------------------------------- step
    def step_with(self, draws: Draws, step_idx: int,
                  attention_bank: torch.Tensor):
        """One step from explicit draws at ``step_idx`` of ``cfg.step``;
        ``attention_bank`` (K, 512) holds the CLIP encodings of the region
        prompts. Updates the mapper in place; returns (aux: scalar device
        tensors, edited images, attention maps)."""
        cfg, g = self.cfg, self.generator

        def span(stage):
            return self.span(stage, self)

        b = draws.cond.shape[0]
        t = step_idx / cfg.step
        with span("synthesis"), torch.no_grad():
            att_text = attention_bank[draws.att_idx[:1]].expand(b, -1)
            img2, lat2, feats2 = self._capture(self._wplus(draws.target[:1]))
            if self.text_bank is not None:
                cond = self.text_bank[draws.cond]
            else:
                img1 = g([self._wplus(draws.cond)], input_is_latent=True,
                         randomize_noise=False).image
        if self.text_bank is None:
            with span("cond_clip"), torch.no_grad():
                cond = self.clip_loss.encode_image(img1)
        lat2 = ([s.expand(b, -1) for s in lat2] if cfg.work_in_stylespace
                else lat2.expand(b, -1, -1))
        feats2 = [None if f is None else f.expand(b, *f.shape[1:]) for f in feats2]
        with span("mapper"):
            new_latents, mo = self.mapper_forward(cond, lat2, feats2, att_text)
        with span("edit"):
            img_gen = self.synthesize(new_latents, mo.attention_map, feats2)
        with span("losses"):
            consist = infonce_consistency(self.clip_loss.encode_image(img_gen), cond,
                                          gather=True)
            perceptual = self.perceptual(img_gen, img2)
            ramp_a = min(max((t - 0.15) / 0.1, 0.0), 1.0)
            ramp_b = min(max((t - 0.05) / 0.1, 0.0), 1.0)
            # the reference's crossed names: loss_essence := tv,
            # loss_secphase := reg, loss_identity := vgg
            total = (consist
                     + ramp_a * (cfg.lambda_ess * mo.loss_tv + cfg.lambda_sec * mo.loss_reg)
                     + ramp_b * cfg.lambda_id * perceptual
                     + cfg.lambda_delta * mo.loss_delta)
        with span("backward"):
            for p in self.params:
                p.grad = None
            total.backward()
            dist.all_reduce_grads(self.params)
        with span("adam"):
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in self.params]
            if t < cfg.freeze_attention_until and self.frozen:
                torch._foreach_zero_([grads[i] for i in self.frozen])
            self.opt.step(grads)
        aux = {"loss": total, "consist": consist, "perceptual": perceptual,
               "delta": mo.loss_delta, "reg": mo.loss_reg, "tv": mo.loss_tv,
               "att_idx": draws.att_idx[0].float()}
        aux = dist.mean_scalars({k: v.detach() for k, v in aux.items()})
        return (aux, img_gen.detach(),
                mo.attention_map.detach())

    @profiling.spanned("trainer.attention.step")
    def step(self, step_idx: int, attention_bank: torch.Tensor):
        return self.step_with(self.draw(attention_bank.shape[0]), step_idx,
                              attention_bank)

    # ------------------------------------------------------------------ run
    def _state(self) -> list:
        return self.params + self.opt.mu + self.opt.nu

    @torch.no_grad()
    def _keep_good(self) -> None:
        if self._good is None:
            self._good = [[t.clone() for t in self._state()], self.opt.count]
        else:
            torch._foreach_copy_(self._good[0], self._state())
            self._good[1] = self.opt.count

    @torch.no_grad()
    def _restore_good(self) -> None:
        torch._foreach_copy_(self._state(), self._good[0])
        self.opt.count = self._good[1]

    def run(self, attention_bank: torch.Tensor, log_every: int = 10,
            callback: Optional[Callable] = None, nan_guard: bool = True,
            start_step: int = 0, stop_fn: Optional[Callable[[], bool]] = None):
        """The training loop from ``start_step`` to ``cfg.step``.

        The NaN guard syncs only at log points (every ``log_every`` steps
        and the last): a non-finite loss rolls the mapper and Adam back to
        the last checked state and, after 3 consecutive bad checks, raises
        ``FloatingPointError``. A fresh trainer fast-forwards the draws to
        ``start_step``, so a resumed run draws what an uninterrupted one
        would (a restored checkpoint has its draw state already).
        ``stop_fn`` is polled before each step; True ends the loop (the
        steps done are ``steps_completed``). ``callback(i, scalars, img,
        amap)`` runs at log points. Returns [(i, scalars)]."""
        if self.draws_taken != start_step:
            self.rng.manual_seed(self.cfg.seed)
            self.draws_taken = 0
            for _ in range(start_step):
                self.draw(attention_bank.shape[0])
        history = []
        bad_streak = 0
        self.steps_completed = start_step
        if nan_guard:
            self._keep_good()
        for i in range(start_step, self.cfg.step):
            if stop_fn is not None and stop_fn():
                break
            aux, img, amap = self.step(i, attention_bank)
            is_log_step = i % log_every == 0 or i == self.cfg.step - 1
            if nan_guard and is_log_step:
                loss = float(aux["loss"])  # the loop's only device sync
                if not math.isfinite(loss):
                    bad_streak += 1
                    self._restore_good()
                    if bad_streak >= 3:
                        detail = {k: float(v) for k, v in aux.items()}
                        raise FloatingPointError(
                            f"non-finite loss at step {i} ({bad_streak} "
                            f"consecutive); aux={detail}")
                    continue
                bad_streak = 0
                self._keep_good()
            self.steps_completed = i + 1
            if is_log_step:
                scal = {k: float(v) for k, v in aux.items()}
                history.append((i, scal))
                if callback:
                    callback(i, scal, img, amap)
        return history

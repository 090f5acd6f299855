"""Ranger: RAdam + Lookahead + gradient centralisation (counterpart of
where2edit_tpu/train/ranger.py, the StyleCLIP coach's optimizer).

The math is the JAX package's, step for step:

* gradient centralisation on every parameter of rank > 1: the gradient less
  its mean over every dim but dim 0 (the output dim of torch's (out, in)
  layout; the JAX code means over every axis but the last of its (in, out)
  layout); biases are not centred;
* RAdam: with the rectification length N_sma of this step above
  ``n_sma_threshold`` the update is ``rect / bias1 · m / (√v + eps)``,
  else ``m / bias1`` (the rectifier's square root would be of a negative
  number there, so that branch is chosen in Python and never formed);
* weight decay ``- weight_decay · lr · p``, on the parameter before the
  update;
* integrated Lookahead: every ``k`` steps, after the update,
  ``slow += alpha · (fast - slow)``, then ``fast = slow``; the slow copy
  starts as a copy of the parameters.

The step's scalars (β^t, N_sma, the rectifier, the bias correction, the
step size times lr) are float32 in the JAX code, and N_sma is a difference
of near-equal numbers there (N_max - 2t·β₂^t / (1 - β₂^t)), so they are
computed here in numpy float32 in the same order: a float64 N_sma moves the
update by up to ~1 % around the threshold.
"""

from __future__ import annotations

import numpy as np
import torch


def _f32(x) -> np.float32:
    return np.float32(x)


def step_scalars(step: int, lr: float, beta1: float, beta2: float,
                 n_sma_threshold: float) -> tuple:
    """(uses the second moment, the update's factor ``-step_size · lr``)
    of step ``step`` (1-based), in float32 as the JAX code computes them."""
    t = _f32(step)
    beta2_t = _f32(beta2) ** t
    n_sma_max = 2.0 / (1 - beta2) - 1.0
    n_sma = _f32(n_sma_max) - _f32(2.0) * t * beta2_t / (_f32(1.0) - beta2_t)
    bias1 = _f32(1.0) - _f32(beta1) ** t
    use_var = bool(n_sma > _f32(n_sma_threshold))
    if use_var:
        rect = np.sqrt((_f32(1.0) - beta2_t) * (n_sma - _f32(4.0))
                       / _f32(n_sma_max - 4) * (n_sma - _f32(2.0)) / n_sma
                       * _f32(n_sma_max) / _f32(n_sma_max - 2))
        step_size = rect / bias1
    else:
        step_size = _f32(1.0) / bias1
    return use_var, float(-step_size * _f32(lr))


def centralize(grad: torch.Tensor) -> torch.Tensor:
    """The gradient less its mean over every dim but dim 0 (rank > 1)."""
    if grad.dim() > 1:
        return grad - grad.mean(dim=tuple(range(1, grad.dim())), keepdim=True)
    return grad


class Ranger(torch.optim.Optimizer):
    """``Ranger(params, lr, betas=(0.95, 0.999), eps=1e-5, weight_decay=0,
    alpha=0.5, k=6, n_sma_threshold=5, use_gc=True)``. Per parameter its
    state holds ``step``, ``exp_avg``, ``exp_avg_sq`` and ``slow_buffer``
    (the reference's names); ``state_dict`` / ``load_state_dict`` resume a
    run exactly."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.95, 0.999),
                 eps: float = 1e-5, weight_decay: float = 0.0,
                 alpha: float = 0.5, k: int = 6, n_sma_threshold: float = 5,
                 use_gc: bool = True):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"invalid slow update rate {alpha}")
        if k < 1:
            raise ValueError(f"invalid lookahead steps {k}")
        defaults = dict(lr=lr, betas=tuple(betas), eps=eps,
                        weight_decay=weight_decay, alpha=alpha, k=k,
                        n_sma_threshold=n_sma_threshold, use_gc=use_gc)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            beta1, beta2 = group["betas"]
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                    state["slow_buffer"] = p.detach().clone()
                state["step"] += 1
            step = self.state[params[0]]["step"]
            if any(self.state[p]["step"] != step for p in params):
                raise RuntimeError("Ranger: the parameters of a group must "
                                   "step together")
            grads = [centralize(p.grad) if group["use_gc"] else p.grad
                     for p in params]
            m = [self.state[p]["exp_avg"] for p in params]
            v = [self.state[p]["exp_avg_sq"] for p in params]
            torch._foreach_mul_(m, beta1)
            torch._foreach_add_(m, grads, alpha=1 - beta1)
            torch._foreach_mul_(v, beta2)
            torch._foreach_addcmul_(v, grads, grads, value=1 - beta2)
            use_var, factor = step_scalars(step, group["lr"], beta1, beta2,
                                           group["n_sma_threshold"])
            if use_var:
                den = torch._foreach_sqrt(v)
                torch._foreach_add_(den, group["eps"])
                upd = torch._foreach_div(m, den)
            else:
                upd = m
            delta = torch._foreach_mul(upd, factor)
            if group["weight_decay"] != 0:
                torch._foreach_add_(delta, params,
                                    alpha=-group["weight_decay"] * group["lr"])
            torch._foreach_add_(params, delta)
            if step % group["k"] == 0:
                slow = [self.state[p]["slow_buffer"] for p in params]
                diff = torch._foreach_sub(params, slow)
                torch._foreach_add_(slow, diff, alpha=group["alpha"])
                torch._foreach_copy_(params, slow)
        return loss

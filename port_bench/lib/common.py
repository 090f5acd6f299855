"""Small helpers shared by the drivers: derived seeds, percentiles, the
comparison numbers and the floating-point policy of the reference."""

from __future__ import annotations

import contextlib
import math
import time
from collections import deque

import torch

_M = 2 ** 63


def derived_seed(seed: int, *parts: int) -> int:
    """A 63-bit seed from the run's seed and ``parts`` (a splitmix64 step
    per part), for torch.Generator.manual_seed."""
    x = seed % (2 ** 64)
    for p in (*parts, 0x5EED):
        x = (x + 0x9E3779B97F4A7C15 + p) % (2 ** 64)
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) % (2 ** 64)
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) % (2 ** 64)
        x ^= x >> 31
    return x % _M


def p95(values: list) -> float:
    """95th percentile by nearest rank."""
    s = sorted(values)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)]


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| / max |want|, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def leaf_gaps(got: dict, want: dict, floor_share: float = 1e-3) -> dict:
    """Per leaf of two {name: norm} readings: |got − want| over the larger
    of the reference's norm of that leaf and of the median leaf. Leaves
    whose reference norm is under ``floor_share`` of the median leaf's are
    left out (their gradient is nought to rounding)."""
    norms = sorted(want.values())
    median = norms[len(norms) // 2]
    out = {}
    for k, w in want.items():
        if w < floor_share * median:
            continue
        scale = max(w, median)
        out[k] = abs(got.get(k, 0.0) - w) / scale if scale > 0 else float(got.get(k, 0.0) != w)
    return out


def leaf_gap(got: dict, want: dict, floor_share: float = 1e-3) -> tuple:
    """The worst leaf of ``leaf_gaps``: (gap, leaf)."""
    gaps = leaf_gaps(got, want, floor_share)
    leaf = max(gaps, key=gaps.get, default="")
    return gaps.get(leaf, 0.0), leaf


def median(values) -> float:
    s = sorted(values)
    return s[len(s) // 2] if s else 0.0


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 on or off in cuBLAS and cuDNN for the block, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old



def closed_loop(env, step, seconds: float, traced_steps: int, in_flight: int = 2) -> tuple:
    """Call ``step()`` (which enqueues one step's work) with at most
    ``in_flight`` steps on the device: the host enqueues step i+1 before it
    waits for step i. Until ``seconds`` have passed since the start or,
    traced, for ``traced_steps`` steps. Returns (steps enqueued, steps
    completed, seconds from the start to the last completion)."""
    pending = deque()
    t0 = time.perf_counter()
    t_last, i, done = t0, 0, 0

    def finish(ev):
        nonlocal t_last, done
        with env.span("bench.wait"):
            if ev is not None:
                ev.synchronize()
        t_last = time.perf_counter()
        done += 1

    while (i < traced_steps) if env.trace else (time.perf_counter() - t0 < seconds):
        step()
        ev = None
        if env.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
        pending.append(ev)
        while len(pending) >= in_flight:
            finish(pending.popleft())
        i += 1
    while pending:
        finish(pending.popleft())
    return i, done, t_last - t0

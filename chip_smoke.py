#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (where2edit_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py [--out FILE.jsonl]

Phases, each printing JSON lines (also appended to ``--out`` when given):

1. device  — requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them; turns TF32 off (the port's fp32 policy).
2. build   — compiles the kernels from ``where2edit_tpu_torch/csrc`` with
   nvcc for sm_90a (in parallel) and prints the build seconds and ptxas'
   register / shared-memory report; checks with ``cuobjdump --dump-sass``
   that K1's and K2's libraries (both on ``csrc/conv3x3_tc.cuh``) hold
   tensor-core (``HGMMA``) instructions.
3. kernels — every shape the 1024² edit path gives K1 (``modconv3x3``) and
   K3 (``modconv1x1``) at batch 1, every shape the 1024² discriminator
   gives K2 (``conv3x3``) at batch 8, and K3's ToRGB shapes again at the
   trainer's batch 8: the kernel against its plain PyTorch version on the
   same inputs (fp32, max |Δ| / max |plain| <= 1e-4), the kernel's, the
   plain version's and a library call's time (CUDA events around eager
   calls back to back), the kernel's and the library call's device time
   alone (calls replayed from a CUDA graph), and the bound: for K1 and K2
   max(bytes / 3.35 TB/s, FLOP / 165 TFLOP/s, the 3xTF32 tensor-core rate),
   the fp32 FMA time (FLOP / 67 TFLOP/s) beside it; for K3 max(bytes /
   3.35 TB/s, FLOP / 67 TFLOP/s). A device time under 0.95 of its bound
   fails the run (a timing that cannot be right). K3's launch grid is
   printed per shape (``blocks``). K1 is also run and timed with its
   weights prepared once (``prepared=``, as the edit path calls it), which
   must give the same bits as the call that prepares them itself.
4. backward — K1, K2 and K3 at every shape of the 1024² training path:
   the forward as the trainer runs it (K1 with per-sample noise, bias and
   the activation; K2 with bias and the activation; K3 as ToRGB with bias
   and skip), at batch 8 and, for K1 and K3, at the path-length batch of 4,
   against the plain version (``KERNEL_REL_TOL``); then, at batch 8, every
   input gradient of the autograd Function against autograd through the
   plain version (``BACKWARD_REL_TOL``); and the region-attention trainer's
   shapes at batch 8: K3 at the mapper's 19 attention convs (blending at
   layer 8) with its weight gradient, K1 at 4²-16² on a frozen weight (style
   and demod gradients, no weight gradient).
5. slice   — the edit path at full width (1024², 18 W+ rows, 26 taps,
   seeded random weights): one seeded face, three edits and one 2-prompt
   sweep through ``EditSession``, with the launch counters set to 0 just
   before and read just after (K1 +9 and K3 +9 per capture, K1 +9 and
   K3 +28 per edit, and no K1 weight preparation in an edit: the layers
   keep K1's prepared weights per weight version); then the p50 edit
   latency, its stage split, the peak memory and the size of that cache.
6. profile — phase 5's session runs 5 more edits under ``torch.profiler``:
   wall and device-busy ms per edit (the profiler's own cost is inside that
   wall time), the device's idle share, kernel launches per edit, device
   busy time inside each stage, device time by kernel category and by
   kernel; more than ``MAX_EDIT_LAUNCHES`` launches per edit fail.
7. whole   — the same seeded session at 256² on the card (kernels) and on
   the CPU (plain versions), from the same W+ and prompts.
7a. invert — the real-photo path at full width: ``Encoder4Editing`` on the
   IR-SE50 trunk (stylegan_size 1024, 18 W+ rows, seeded random weights,
   1-D ``latent_avg`` = the generator's mean latent), saved as a
   reference-layout checkpoint and loaded through ``demo/app.py::load_psp``;
   8 of phase 5's seeded 1024² faces, face-pooled to 256², stand in for
   photos. With the launch counters set to 0 just before: the inversion
   (W+ (8, 18, 512), finite; no port kernel), ``load_latent`` of the first
   face and one edit (phase 5's counts, no K1 weight preparation), one
   ``PSp.__call__`` (a finite 256² image), and ``cli/edit.main`` with
   ``--latent`` (a 2-face .npy bank, 2 prompts) and ``--celeb "Celeb 1"``
   (one row per face and prompt). Then, fenced: the p50 of ``psp.encode`` at
   batch 1 (12 calls) and ms per image at batch 8, the stage split of a
   real-photo edit (invert, capture, text, mapper, synthesis), peak memory;
   and 5 inversions under ``torch.profiler`` (device busy, idle share,
   launches, categories) beside the fp32 FMA bound of the encoder's FLOP,
   counted from its convs and linears by forward hooks.
7b. invert_whole — that encoder at 256² batch 1 on the card and on the CPU
   from the same checkpoint and input (W+ max |Δ| / max |CPU| <= 1e-4); then
   the whole real-photo path at 256² generator size (e4e with 14 rows ->
   ``load_latent`` -> one edit), card against CPU, at phase 7's tolerances.
8. train   — adversarial training at full width through
   ``cli/train_stylegan.main``: 1024², channel_multiplier 2, batch 8, 5
   iterations from seed 0 (iteration 0 runs R1 and path length, iteration
   4 path length again), the launch counters set to 0 just before; K1, K2
   and K3 launches per program (d, r1, g, path) against the counts the
   architecture gives (``train_launches``); finite losses, every parameter
   of G and D moved, every generator parameter with a non-zero gradient
   after each G step; ms per program, images/s and peak memory.
9. train_profile — one more iteration of that trainer, at a step that runs
   every program, under ``torch.profiler``: device busy, the idle share,
   device time by kernel category and by kernel.
10. train_whole — one training iteration at 64² on the card and on the CPU
   from the same weights and draws, each program from the same state: the
   losses and every parameter's gradient (``TRAIN_*_TOL``).
11. cluster — ``cli/run_clustering.main`` at 1024², channel multiplier 2,
   layer 13, 10 clusters, batch 5, ``--step 4`` (327,680 × 576 rows; its one
   cut), the fit the CLI's default (native C++ Lloyd on the host where
   sklearn is missing): K1 and K3 per synthesis pass, the pickle's shape,
   ms of collection and fit; then the device Lloyd (``kmeans_fit(backend=
   "torch")``, 50 iterations) on the default ``--step 20`` matrix
   (1,638,400 × 576, 3.77 GB), and the card's Lloyd against the CPU's on
   65,536 rows, each of 50 iterations from the CPU's centres
   (``KMEANS_REL_TOL``).
12. attention — ``cli/run_attention.main`` at 1024², ``--work_in_stylespace
   --use_cluster`` on phase 11's pickle, batch 8, 6 steps, seeded random
   ViT-B/32 and VGG16, with ``AttentionProbe`` as its span: finite losses,
   nothing moved at step 0 (lr 0), every trained mapper parameter moved at
   step 1, the attention*/initial* ones never, no generator, CLIP or VGG
   parameter with a gradient, no K1 weight preparation, K1 and K3 launches
   per stage against ``attention_launches``; then ``--resume`` of its final
   checkpoint. ms per step over steps 1-5 and the stage split, samples/s,
   peak memory.
13. attention_profile — one more step of that trainer under
   ``torch.profiler``: device busy, idle share, launches, categories.
14. attention_whole — one step at 64² on the card and on the CPU from the
   same weights and draws, every mapper gradient unmasked: the loss terms
   (``TRAIN_LOSS_REL_TOL``) and the mapper's gradient (``TRAIN_*_GRAD_TOL``).
15. the ``kernels`` summary line, then the last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch
import torch.nn.functional as F

from where2edit_tpu_torch.cli import edit as edit_cli
from where2edit_tpu_torch.cli import run_attention, run_clustering, train_stylegan
from where2edit_tpu_torch.cli.common import (
    build_generator,
    load_cluster_centers,
    mean_latent,
)
from where2edit_tpu_torch.cli.run_clustering import collect_features
from where2edit_tpu_torch.demo.app import build_argparser as app_argparser
from where2edit_tpu_torch.demo.app import build_session, load_psp
from where2edit_tpu_torch.editing.attention_mappers import (
    FullSpaceMapperFEATClusterLinStyle,
    attention_tables,
    tap_resolution,
)
from where2edit_tpu_torch.editing.clustering import _lloyd, kmeans_fit
from where2edit_tpu_torch.kernels import common
from where2edit_tpu_torch.kernels import conv3x3 as k2
from where2edit_tpu_torch.kernels import modconv1x1 as k3
from where2edit_tpu_torch.kernels import modconv3x3 as k1
from where2edit_tpu_torch.losses.clip_loss import CLIPLoss
from where2edit_tpu_torch.losses.perceptual import PerceptualLoss
from where2edit_tpu_torch.models.clip_model import CLIP
from where2edit_tpu_torch.models.clip_tokenizer import tokenize
from where2edit_tpu_torch.models.encoders import Encoder4Editing
from where2edit_tpu_torch.models.psp import PSp
from where2edit_tpu_torch.models.stylegan2 import Generator, channel_table
from where2edit_tpu_torch.models.vgg import Vgg16
from where2edit_tpu_torch.nn.layers import EqualLinear
from where2edit_tpu_torch.ops.interpolate import adaptive_avg_pool
from where2edit_tpu_torch.train.attention_trainer import (
    AttentionTrainConfig,
    AttentionTrainer,
    Draws,
    is_attention_param,
)
from where2edit_tpu_torch.train.corpus import ATTENTION_PROMPTS
from where2edit_tpu_torch.train.gan_trainer import Draws as GANDraws
from where2edit_tpu_torch.train.gan_trainer import GANTrainConfig, GANTrainer
from where2edit_tpu_torch.utils.logging import read_scalars

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, fp32 outside tensor cores
# fp32-accurate products on the tensor cores: three TF32 products each, at
# the data sheet's dense TF32 rate of 495 TFLOP/s
TC_3XTF32_FLOP_PER_S = 495e12 / 3
BOUND_FLOOR = 0.95          # a device time under this share of its bound fails
MAX_EDIT_LAUNCHES = 1441    # kernel launches per 1024² edit, phase 6
SIZE, ATTENTION_LAYER = 1024, 13
KERNEL_REL_TOL = 1e-4
# Whole-path tolerance, card against CPU at 256²: both run fp32 (TF32 off),
# but every conv sums in another order, through 12 synthesis layers twice
# (capture, then edit). 1e-3 of the image's largest magnitude is well under
# one 8-bit level (2/255 of the [-1, 1] range); the attention map is a
# sigmoid pooled over clusters, 1e-4 absolute.
WHOLE_IMAGE_REL_TOL = 1e-3
WHOLE_MAP_ABS_TOL = 1e-4
# e4e W+, card against CPU, max |Δ| / max |CPU|: fp32 both sides (cuDNN
# without TF32), 50 residual blocks and up to 6 stride-2 convs summed in
# another order.
INVERT_REL_TOL = 1e-4
# Backward, kernel Function against autograd through the plain version, per
# input gradient, max |Δ| / max |plain|: fp32 both sides, but the weight,
# style and demod gradients are sums over B·H·W (up to 8.4M) products taken
# in another order (a per-sample weight gradient contracted afterwards
# against cuDNN's batched one), with cancellation. The checks run without
# the activation: where a pre-activation rounds to opposite signs in the two
# forwards, lrelu' takes the other slope there, an O(1) difference at that
# element that no elementwise bar can hold (the activation's factor is held
# by gradcheck on the CPU, tests/test_torch_autograd.py).
BACKWARD_REL_TOL = 1e-3
# One training iteration, card against CPU at 64², each program started
# from the same parameters: the losses within 1e-3 relative; the gradient
# of every parameter tensor within 5e-2 in relative L2 norm and the whole
# model's within 1e-3. fp32 reductions run in another order, an element
# whose pre-activation is within rounding of 0 takes the other leaky-ReLU
# slope, and a noise gain's gradient is one scalar summed over every pixel
# of the batch with heavy cancellation; a wrong formula moves a gradient by
# O(1).
TRAIN_LOSS_REL_TOL = 1e-3
TRAIN_PARAM_GRAD_TOL = 5e-2
TRAIN_MODEL_GRAD_TOL = 1e-3
TRAIN_ARGS = ["--synthetic", "16", "--size", str(SIZE), "--channel_multiplier",
              "2", "--batch", "8", "--iter", "5", "--seed", "0",
              "--save_every", "0"]

_out_file = None


def emit(obj: dict) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if _out_file is not None:
        _out_file.write(line + "\n")
        _out_file.flush()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, budget_ms: float = 150.0) -> float:
    """Mean time of one call, from CUDA events around back-to-back calls,
    after warm-up; the repetitions fill about ``budget_ms``."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps = max(3, min(200, int(budget_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph and
    replayed, so the host's cost of launching them drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (5 * reps)
    del graph
    return ms


def bound(nbytes: int, flops: int, flop_per_s: float = FP32_FLOP_PER_S
          ) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def conv_bounds(rec: dict, nbytes: int, flops: int) -> None:
    """K1's and K2's bound at the 3xTF32 tensor-core rate, and the fp32 FMA
    bound beside it."""
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, TC_3XTF32_FLOP_PER_S)
    rec["fma_bound_ms"] = bound(nbytes, flops)[0]


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    seconds = common.build()
    wall = time.perf_counter() - t0
    report = {}
    for name in common.KERNEL_SOURCES:
        log = common.BUILD_DIR / f"{name}.log"
        if log.exists():
            report[name] = [ln.strip() for ln in log.read_text().splitlines()
                            if "registers" in ln or "Compiling entry" in ln
                            or "spill" in ln]
    hgmma = {}
    for name in ("modconv3x3", "conv3x3"):  # K1 and K2, on the tensor-core core
        sass = subprocess.run([common.cuda_tool("cuobjdump"), "--dump-sass",
                               str(common.library_path(name))],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        hgmma[name] = sum(1 for ln in sass.splitlines() if "HGMMA" in ln)
    emit({"phase": "build", "arch": "sm_90a", "seconds": seconds,
          "wall_s": wall, "hgmma_instructions": hgmma, "ptxas": report})
    for name, n in hgmma.items():
        check(n > 0, f"{name}'s library holds no HGMMA (tensor-core) instruction")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions at the main path's shapes
# ---------------------------------------------------------------------------

def k1_shapes():
    ch = channel_table(2)
    return [(r, ch[r], ch[r]) for r in (4, 8, 16, 32, 64, 128, 256, 512, 1024)]


def mapper_conv_shapes(attention_layer: int) -> list:
    """(name, res, Cin, Cout) of the 1024² mapper's 19 attention convs
    (attention_first, the 17 tap convs, attention_last) blending at
    ``attention_layer``: each runs at the smaller of its tap's and the blend
    resolution."""
    blend = tap_resolution(attention_layer)
    tab = attention_tables(SIZE)
    return ([("attention_first", 4, channel_table(2)[4], 32)]
            + [(f"attention_{c}", min(tap_resolution(c + 1), blend),
                tab["tap_channels"][c], 32) for c in tab["layer_num"]]
            + [("attention_last", blend, 32 * tab["n_latent"], 1)])


def k3_shapes():
    """(name, res, Cin, Cout, demod_act_noise, residual): the 9 ToRGBs, then
    the edit mapper's attention convs."""
    ch = channel_table(2)
    shapes = [(f"to_rgb_{r}", r, ch[r], 3, False, r > 4)
              for r in (4, 8, 16, 32, 64, 128, 256, 512, 1024)]
    return shapes + [(*shape, True, False)
                     for shape in mapper_conv_shapes(ATTENTION_LAYER)]


def k2_shapes():
    """(res, Cin, Cout) of the 1024² discriminator's stride-1 3x3 convs: each
    ResBlock's conv1, then final_conv (512 + the minibatch-stddev channel)."""
    ch = channel_table(2)
    return ([(r, ch[r], ch[r]) for r in (1024, 512, 256, 128, 64, 32, 16, 8)]
            + [(4, ch[4] + 1, ch[4])])


def phase_kernels() -> dict:
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    summed = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
              "bound_ms", "fma_bound_ms")
    totals = {k: {**dict.fromkeys(summed, 0.0), "bytes_s": 0.0, "ops_s": 0.0,
                  "max_abs_err": 0.0, "max_rel_err": 0.0}
              for k in ("modconv3x3", "conv3x3", "modconv1x1")}

    def add(name, rec, in_total=True):
        """Emit one shape's record; fold it into the kernel's totals (the
        main path's shapes) unless ``in_total`` is false."""
        emit({"phase": "kernels", "kernel": name, **rec})
        for key in ("device_ms", "prepared_device_ms"):
            check(key not in rec or rec[key] >= BOUND_FLOOR * rec["bound_ms"],
                  f"{name} {rec['shape']}: {key} {rec.get(key)} ms under "
                  f"{BOUND_FLOOR} of its bound {rec['bound_ms']} ms")
        if not in_total:
            return
        tot = totals[name]
        for key in summed:
            tot[key] += rec[key]
        for key in ("prepared_ms", "prepared_device_ms"):  # K1's alone
            if key in rec:
                tot[key] = tot.get(key, 0.0) + rec[key]
        tot["bytes_s" if rec["bound_by"] == "bytes" else "ops_s"] += rec["bound_ms"]
        tot["max_abs_err"] = max(tot["max_abs_err"], rec["max_abs_err"])
        tot["max_rel_err"] = max(tot["max_rel_err"], rec["max_rel_err"])

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    for res, cin, cout in k1_shapes():
        x = randn(1, res, res, cin)
        s = randn(1, cin)
        w = randn(3, 3, cin, cout)
        scale = 1.0 / math.sqrt(cin * 9)
        demod = torch.rsqrt(s.square() @ (scale * w).square().sum((0, 1)) + 1e-8)
        style = (scale * s).contiguous()
        noise, nw, bias = randn(1, res, res), randn(1), randn(cout)
        args = (x, style, w, demod, noise, nw, bias, True)
        got = k1.modconv3x3(*args)
        want = k1.modconv3x3_plain(*args)
        # the edit path's call: the weights prepared once, outside the call
        wp = k1.prepare_weight(w)
        got_prepared = k1.modconv3x3(*args, prepared=wp)
        torch.cuda.synchronize()
        abs_err, rel = rel_err(got, want)
        check(rel <= KERNEL_REL_TOL, f"modconv3x3 {res}² {cin}->{cout}: rel {rel}")
        check(torch.equal(got_prepared, got),
              f"modconv3x3 {res}² {cin}->{cout}: prepared weights change the result")
        # library yardstick: one cuDNN conv with the per-sample modulation and
        # demod folded into the weights (exact at batch 1), then the epilogue
        w_lib = (w.permute(3, 2, 0, 1) * style[0][None, :, None, None]
                 * demod[0][:, None, None, None]).contiguous(
                     memory_format=torch.channels_last)
        x_lib = x.permute(0, 3, 1, 2)

        def library():
            y = F.conv2d(x_lib, w_lib, bias, padding=1)
            y.add_(nw * noise[:, None])
            return F.leaky_relu_(y, 0.2).mul_(math.sqrt(2.0))

        rec = {"shape": f"{res}x{res} {cin}->{cout}",
               "max_abs_err": abs_err, "max_rel_err": rel,
               "ms": time_ms(lambda: k1.modconv3x3(*args)),
               "device_ms": graph_ms(lambda: k1.modconv3x3(*args)),
               "prepared_ms": time_ms(lambda: k1.modconv3x3(*args, prepared=wp)),
               "prepared_device_ms": graph_ms(lambda: k1.modconv3x3(*args, prepared=wp)),
               "plain_ms": time_ms(lambda: k1.modconv3x3_plain(*args)),
               "library_ms": time_ms(library), "library_device_ms": graph_ms(library)}
        nbytes = 4 * (x.numel() + style.numel() + w.numel() + demod.numel()
                      + noise.numel() + 1 + bias.numel() + got.numel())
        conv_bounds(rec, nbytes, 2 * res * res * cin * cout * 9)
        add("modconv3x3", rec)
        del x, w, wp, got, got_prepared, want, w_lib

    def k3_shape(name, res, cin, cout, styled, has_res, batch, in_total):
        p = res * res
        x, s, w = randn(batch, p, cin), randn(batch, cin), randn(cin, cout)
        scale = 1.0 / math.sqrt(cin)
        style = (scale * s).contiguous()
        demod = (torch.rsqrt(s.square() @ (scale * w).square() + 1e-8)
                 if styled else None)
        noise, nw = (randn(1, p), randn(1)) if styled else (None, None)
        bias = randn(cout)
        residual = randn(batch, p, cout) if has_res else None
        args = (x, style, w, demod, noise, nw, bias, styled, residual)
        got = k3.modconv1x1(*args)
        want = k3.modconv1x1_plain(*args)
        torch.cuda.synchronize()
        abs_err, rel = rel_err(got, want)
        check(rel <= KERNEL_REL_TOL, f"modconv1x1 {name} batch {batch}: rel {rel}")
        # library yardstick: one batched product with the per-sample style
        # and demod folded into the weights, then the epilogue
        w_lib = style[:, :, None] * w * (demod[:, None, :] if styled else 1.0)

        def library():
            y = torch.einsum("bpi,bio->bpo", x, w_lib)
            if styled:
                y.add_(nw * noise[:, :, None]).add_(bias)
                return F.leaky_relu_(y, 0.2).mul_(math.sqrt(2.0))
            y.add_(bias)
            return y if residual is None else y.add_(residual)

        rec = {"shape": f"{name} {res}x{res} {cin}->{cout}"
                        + (f" batch {batch}" if batch > 1 else ""),
               "blocks": k3.blocks(batch, p, cin, cout, dev.index),
               "max_abs_err": abs_err, "max_rel_err": rel,
               "ms": time_ms(lambda: k3.modconv1x1(*args)),
               "device_ms": graph_ms(lambda: k3.modconv1x1(*args)),
               "plain_ms": time_ms(lambda: k3.modconv1x1_plain(*args)),
               "library_ms": time_ms(library), "library_device_ms": graph_ms(library)}
        nbytes = 4 * sum(t.numel() for t in (x, style, w, demod, noise, nw, bias,
                                             residual, got) if t is not None)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 2 * batch * p * cin * cout)
        rec["fma_bound_ms"] = rec["bound_ms"]  # K3 runs on the FMA units
        add("modconv1x1", rec, in_total)
        return rec

    for shape in k3_shapes():
        rec = k3_shape(*shape, 1, True)
        if shape[0] == "to_rgb_16":  # the design spreads even this over the card
            check(rec["blocks"] > 1, f"K3 at to_rgb_16 launched {rec['blocks']} block")
    for shape in k3_shapes()[:9]:  # the ToRGBs at the trainer's batch
        k3_shape(*shape, 8, False)

    batch = 8
    for res, cin, cout in k2_shapes():
        x, w, bias = randn(batch, res, res, cin), randn(3, 3, cin, cout), randn(cout)
        scale = 1.0 / math.sqrt(cin * 9)
        args = (x, w, scale, bias, True)
        got = k2.conv3x3(*args)
        want = k2.conv3x3_plain(*args)
        torch.cuda.synchronize()
        abs_err, rel = rel_err(got, want)
        check(rel <= KERNEL_REL_TOL, f"conv3x3 {res}² {cin}->{cout}: rel {rel}")
        # library yardstick: one cuDNN conv (weights pre-scaled), then the epilogue
        w_lib = (w.permute(3, 2, 0, 1) * scale).contiguous(
            memory_format=torch.channels_last)
        x_lib = x.permute(0, 3, 1, 2)

        def library():
            y = F.conv2d(x_lib, w_lib, bias, padding=1)
            return F.leaky_relu_(y, 0.2).mul_(math.sqrt(2.0))

        rec = {"shape": f"{res}x{res} {cin}->{cout} batch {batch}",
               "max_abs_err": abs_err, "max_rel_err": rel,
               "ms": time_ms(lambda: k2.conv3x3(*args)),
               "device_ms": graph_ms(lambda: k2.conv3x3(*args)),
               "plain_ms": time_ms(lambda: k2.conv3x3_plain(*args)),
               "library_ms": time_ms(library), "library_device_ms": graph_ms(library)}
        nbytes = 4 * (x.numel() + w.numel() + bias.numel() + got.numel())
        conv_bounds(rec, nbytes, 2 * batch * res * res * cin * cout * 9)
        add("conv3x3", rec)
        del x, w, got, want, w_lib
    return totals


# ---------------------------------------------------------------------------
# phase 4: the kernels' backward against autograd through the plain versions
# ---------------------------------------------------------------------------

def _grads(fn, inputs: dict, dy: torch.Tensor, frozen: tuple = ()) -> dict:
    """{name: d(Σ fn(**inputs)·dy)/d input} for the inputs that are tensors
    and not ``frozen`` (those enter without a gradient)."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in inputs.items()
              if isinstance(v, torch.Tensor) and k not in frozen}
    out = fn(**{**inputs, **leaves})
    got = torch.autograd.grad(out, list(leaves.values()), dy)
    return dict(zip(leaves, got))


def phase_backward() -> tuple:
    """K1, K2 and K3 at every shape of the 1024² training path. Forward, as
    the trainer runs each (K1 as StyledConv: demod, noise of shape (B,H,W),
    bias, the activation; K2 as ConvLayer: bias, the activation; K3 as
    ToRGB: bias and the upsampled skip), at batch 8 and, for the generator's
    K1 and K3, at the path-length batch of 4: the kernel against the plain
    version at ``KERNEL_REL_TOL``. Backward at batch 8: every input gradient
    of the kernel's Function against autograd through the plain version.
    Returns ({kernel: worst forward rel error}, {kernel: worst backward rel
    error})."""
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(1)
    batch, path_batch = 8, 4
    worst_fwd = {"modconv3x3": 0.0, "conv3x3": 0.0, "modconv1x1": 0.0}
    worst = dict(worst_fwd)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def forward(name, shape, kernel_fn, plain_fn, inputs):
        before = counts()
        with torch.no_grad():
            got = kernel_fn(**inputs)
            launched = tuple(a - b for a, b in zip(counts(), before))
            want = plain_fn(**inputs)
        torch.cuda.synchronize()
        one = tuple(int(k == name) for k in ("modconv3x3", "conv3x3", "modconv1x1"))
        check(launched == one, f"{name} forward {shape}: launches {launched}")
        err = rel_err(got, want)[1]
        worst_fwd[name] = max(worst_fwd[name], err)
        check(err <= KERNEL_REL_TOL, f"{name} forward {shape}: rel {err}")
        return err

    def compare(name, shape, kernel_fn, plain_fn, make, train_kw, batches,
                frozen=()):
        """``make(b)`` gives the inputs at batch b; ``train_kw`` what the
        trainer's forward adds to them (the activation); ``frozen`` the
        inputs that take no gradient (a frozen generator's weight)."""
        fwd = {f"batch {b}": forward(name, shape, kernel_fn, plain_fn,
                                     {**make(b), **train_kw}) for b in batches}
        inputs = make(batch)
        x = inputs["x"]
        dy = randn(*x.shape[:-1], inputs["w"].shape[-1])
        got = _grads(kernel_fn, inputs, dy, frozen)
        want = _grads(plain_fn, inputs, dy, frozen)
        torch.cuda.synchronize()
        errs = {k: rel_err(got[k], want[k])[1] for k in got}
        worst[name] = max(worst[name], *errs.values())
        emit({"phase": "backward", "kernel": name, "shape": shape,
              "forward_max_rel_err": fwd, "forward_tol": KERNEL_REL_TOL,
              "max_rel_err": errs, "tol": BACKWARD_REL_TOL})
        bad = {k: e for k, e in errs.items() if not e <= BACKWARD_REL_TOL}
        check(not bad, f"{name} backward {shape}: {bad}")

    ch = channel_table(2)
    for res, cin, cout in k1_shapes():
        scale = 1.0 / math.sqrt(cin * 9)

        def k1_inputs(b, res=res, cin=cin, cout=cout, scale=scale):
            return {"x": randn(b, res, res, cin), "style": scale * randn(b, cin),
                    "w": randn(3, 3, cin, cout), "demod": randn(b, cout).abs() + 0.5,
                    "noise": randn(b, res, res), "noise_weight": randn(1),
                    "bias": randn(cout), "act": False}

        compare("modconv3x3", f"{res}x{res} {cin}->{cout}", k1.modconv3x3,
                k1.modconv3x3_plain, k1_inputs, {"act": True}, (batch, path_batch))
    for res, cin, cout in k2_shapes():
        def k2_inputs(b, res=res, cin=cin, cout=cout):
            return {"x": randn(b, res, res, cin), "w": randn(3, 3, cin, cout),
                    "scale": 1.0 / math.sqrt(cin * 9), "bias": randn(cout),
                    "act": False}

        compare("conv3x3", f"{res}x{res} {cin}->{cout}", k2.conv3x3,
                k2.conv3x3_plain, k2_inputs, {"act": True}, (batch,))
    for res in (4, 8, 16, 32, 64, 128, 256, 512, 1024):
        p, cin = res * res, ch[res]

        def k3_inputs(b, p=p, cin=cin, res=res):  # the 4² ToRGB has no skip
            return {"x": randn(b, p, cin), "style": randn(b, cin) / math.sqrt(cin),
                    "w": randn(cin, 3), "bias": randn(3),
                    "residual": randn(b, p, 3) if res > 4 else None}

        compare("modconv1x1", f"to_rgb_{res} {res}x{res} {cin}->3", k3.modconv1x1,
                k3.modconv1x1_plain, k3_inputs, {}, (batch, path_batch))
    # region-attention training: the mapper's attention convs, whose weight
    # is a trained parameter, and the frozen generator's K1 at the layers
    # whose styles the mapper edits (4²-16²: style and demod gradients, no
    # weight gradient)
    for name, res, cin, cout in mapper_conv_shapes(TRAIN_ATTENTION_LAYER):
        p = res * res

        def k3m_inputs(b, p=p, cin=cin, cout=cout):
            return {"x": randn(b, p, cin), "style": randn(b, cin) / math.sqrt(cin),
                    "w": randn(cin, cout), "demod": randn(b, cout).abs() + 0.5,
                    "noise": randn(b, p), "noise_weight": randn(1),
                    "bias": randn(cout), "act": False}

        compare("modconv1x1", f"{name} {res}x{res} {cin}->{cout}", k3.modconv1x1,
                k3.modconv1x1_plain, k3m_inputs, {"act": True}, (batch,))
    for res, cin, cout in k1_shapes()[:3]:
        scale = 1.0 / math.sqrt(cin * 9)

        def k1f_inputs(b, res=res, cin=cin, cout=cout, scale=scale):
            return {"x": randn(b, res, res, cin), "style": scale * randn(b, cin),
                    "w": randn(3, 3, cin, cout), "demod": randn(b, cout).abs() + 0.5,
                    "noise": randn(b, res, res), "noise_weight": randn(1),
                    "bias": randn(cout), "act": False}

        compare("modconv3x3", f"frozen w {res}x{res} {cin}->{cout}", k1.modconv3x3,
                k1.modconv3x3_plain, k1f_inputs, {"act": True}, (batch,),
                frozen=("w",))
    return worst_fwd, worst


# ---------------------------------------------------------------------------
# phase 5: the 1024² edit path through the kernels
# ---------------------------------------------------------------------------

PROMPTS = [  # (prompt, attention prompt, strength, threshold)
    ("a person with grey hair", "grey hair", 0.1, 0.75),
    ("a face with pale skin", "tanned skin", 0.2, 0.9),
    ("purple hair", "thin eyebrows", 0.3, 1.0),
]


STAGES = ("text", "mapper", "synthesis")


def staged_edit(session, toks, att, span) -> None:
    """One edit as its three stages, each inside the context ``span(stage)``."""
    with span("text"):
        text, att_f = session.encode(toks, att)
    with span("mapper"):
        new_lat, amap = session.predict(text, att_f)
    with span("synthesis"):
        session.render(new_lat, amap)


def check_edit(img, amap, batch):
    check(tuple(img.shape) == (batch, SIZE, SIZE, 3), f"image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "image is finite")
    check(amap.shape[0] == batch and amap.shape[-1] == 1, f"map shape {tuple(amap.shape)}")
    check(float(amap.min()) >= 0.0 and float(amap.max()) <= 1.0, "map in [0, 1]")


def phase_slice() -> dict:
    t0 = time.perf_counter()
    session = build_session(SIZE, ATTENTION_LAYER, ATTENTION_LAYER, seed=0,
                            device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "slice", "step": "build_session", "seconds": time.perf_counter() - t0,
          "size": SIZE, "n_latent": session.generator.n_latent})

    def counts():
        return k1.launches, k3.launches

    def expect(before, d1, d3, what):
        after = counts()
        check(after == (before[0] + d1, before[1] + d3),
              f"{what}: launches {before} -> {after}, expected +({d1}, {d3})")

    def expect_no_prepare(before, what):
        check(k1.prepares == before,
              f"{what}: {k1.prepares - before} K1 weight preparations, expected 0 "
              "(the layers keep them per weight version)")

    # one K1 per non-upsampling conv and one K3 per ToRGB in each synthesis,
    # one K3 per attention conv of the mapper: (9, 9) and (9, 28) at 1024²
    per_pass = 1 + len(session.generator.to_rgbs)
    per_capture = (per_pass, per_pass)
    per_edit = (per_pass, per_pass + len(session.mapper.layer_num) + 2)
    k1.launches = 0
    k3.launches = 0
    # --- the main path: one capture, three edits, one 2-prompt sweep ---
    before = counts()
    img = session.load_synthetic(7)
    torch.cuda.synchronize()
    check(tuple(img.shape) == (1, SIZE, SIZE, 3) and bool(torch.isfinite(img).all()),
          "captured image")
    expect(before, *per_capture, "load_synthetic")
    n_taps = sum(f is not None for f in session.feature_map)
    for prompt, att, strength, thr in PROMPTS:
        before, prepares = counts(), k1.prepares
        img, amap = session.edit(tokenize([prompt]), tokenize([att]),
                                 strength_alpha=strength, attention_threshold=thr)
        torch.cuda.synchronize()
        check_edit(img, amap, 1)
        expect(before, *per_edit, f"edit {prompt!r}")
        expect_no_prepare(prepares, f"edit {prompt!r}")
    before, prepares = counts(), k1.prepares
    img, amap = session.edit(tokenize([p[0] for p in PROMPTS[:2]]),
                             tokenize([p[1] for p in PROMPTS[:2]]))
    torch.cuda.synchronize()
    check_edit(img, amap, 2)
    expect(before, *per_edit, "2-prompt sweep")
    expect_no_prepare(prepares, "2-prompt sweep")
    launches = {"modconv3x3": k1.launches, "modconv1x1": k3.launches}
    emit({"phase": "slice", "step": "main_path", "edits": len(PROMPTS),
          "sweeps": 1, "stored_taps": n_taps, "launches": launches,
          "per_capture": per_capture, "per_edit": per_edit,
          "map_shape": list(amap.shape)})

    # --- latency at batch 1, then the stage split ---
    toks, att = tokenize([PROMPTS[0][0]]), tokenize([PROMPTS[0][1]])
    lat = []
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.edit(toks, att)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    stages = defaultdict(list)

    @contextlib.contextmanager
    def fenced(stage):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        stages[stage].append((time.perf_counter() - t0) * 1e3)

    for _ in range(10):
        staged_edit(session, toks, att, fenced)
    for _ in range(5):
        with fenced("capture"):
            session.load_synthetic(7)
    rec = {"phase": "slice", "step": "latency", "batch": 1, "edits": len(lat),
           "p50_edit_ms": statistics.median(lat), "edit_ms": lat,
           "p50_stage_ms": {k: statistics.median(v) for k, v in stages.items()},
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           # inside that peak: K1's prepared weights, kept per layer
           "k1_prepared_cache_mib": sum(
               m._prepared[2].numel() * 4 for m in session.generator.modules()
               if getattr(m, "_prepared", None) is not None
               and m._prepared[2] is not None) / 2 ** 20}
    emit(rec)
    return launches, session


# ---------------------------------------------------------------------------
# phase 6: where the time of an edit goes
# ---------------------------------------------------------------------------

# kernel-name substrings -> category, first match wins
CATEGORIES = (
    ("K1 modconv3x3", ("modconv3x3",)),
    ("K2 conv3x3", ("conv3x3_tc",)),
    ("K3 modconv1x1", ("modconv1x1",)),
    ("cuDNN depthwise conv (blurs)", ("conv2d_grouped",)),
    ("cuDNN weight gradients", ("wgrad",)),
    ("cuDNN transposed conv (up-conv) and input gradients", ("dgrad",)),
    ("BatchNorm (running statistics)", ("batch_norm", "bn_fw")),
    ("cuDNN other", ("cudnn", "fprop", "implicit_convolve")),
    ("GEMM / GEMV", ("gemm", "gemv")),
    ("bilinear resize (FPN merge)", ("upsample_bilinear",)),
    ("elementwise / reduce / copy", ("elementwise", "reduce", "copy", "cat",
                                     "index", "layer_norm", "softmax")),
)


def _union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def device_profile(run, spans: tuple, reps: int, count_ops: tuple = ()) -> dict:
    """``reps`` calls of ``run(record_function)`` under ``torch.profiler``,
    per call: wall and device-busy ms, the idle share, kernel launches,
    device busy inside each ``record_function`` span named in ``spans``,
    device time by kernel category and by kernel, and how often each host
    op or autograd node named in ``count_ops`` ran."""
    from torch.profiler import ProfilerActivity, profile, record_function  # noqa: PLC0415

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run(record_function)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    op_counts = dict.fromkeys(count_ops, 0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in op_counts:
            op_counts[e.name] += 1
    marks = [e for e in cuda if e.name in spans]
    kernels = [e for e in cuda if e.name not in spans
               and not getattr(e, "is_user_annotation", False)]
    intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy_us = _union_us(intervals)
    span_busy = dict.fromkeys(spans, 0.0)
    for span in marks:
        lo, hi = span.time_range.start, span.time_range.end
        span_busy[span.name] += _union_us(
            (max(s, lo), min(e, hi)) for s, e in intervals if s < hi and e > lo)
    by_name, by_cat = defaultdict(lambda: [0.0, 0]), defaultdict(lambda: [0.0, 0])
    for e in kernels:
        low = e.name.lower()
        cat = next((c for c, keys in CATEGORIES if any(k in low for k in keys)), "other")
        for rec in (by_name[e.name], by_cat[cat]):
            rec[0] += e.time_range.end - e.time_range.start
            rec[1] += 1

    def per_call(table, n=None):
        rows = sorted(table.items(), key=lambda kv: -kv[1][0])[:n]
        return [{"name": k[:90], "ms": v[0] / 1e3 / reps, "launches": v[1] / reps}
                for k, v in rows]

    return {"wall_ms": wall_us / 1e3 / reps, "device_busy_ms": busy_us / 1e3 / reps,
            "device_idle_share": 1.0 - busy_us / wall_us,
            "kernel_launches": len(kernels) / reps,
            "span_device_busy_ms": {k: v / 1e3 / reps for k, v in span_busy.items()},
            "categories": per_call(by_cat), "top_kernels": per_call(by_name, 25),
            **({"op_counts": {k: v / reps for k, v in op_counts.items()}}
               if count_ops else {})}


def phase_profile(session, card: str, edits: int = 5) -> None:
    toks, att = tokenize([PROMPTS[0][0]]), tokenize([PROMPTS[0][1]])
    rec = device_profile(lambda span: staged_edit(session, toks, att, span), STAGES,
                         edits)
    emit({"phase": "profile", "card": card, "size": SIZE, "batch": 1, "edits": edits,
          "wall_ms_per_edit": rec["wall_ms"],
          "device_busy_ms_per_edit": rec["device_busy_ms"],
          "device_idle_share": rec["device_idle_share"],
          "kernel_launches_per_edit": rec["kernel_launches"],
          "stage_device_busy_ms_per_edit": rec["span_device_busy_ms"],
          "categories": rec["categories"], "top_kernels": rec["top_kernels"]})
    check(rec["kernel_launches"] <= MAX_EDIT_LAUNCHES,
          f"{rec['kernel_launches']} launches per edit, more than {MAX_EDIT_LAUNCHES}")


# ---------------------------------------------------------------------------
# phase 7: whole path, card against CPU at 256²
# ---------------------------------------------------------------------------

def whole_sessions(size: int) -> tuple:
    """The seeded session at ``size`` on the CPU and on the card, with the
    same non-zero noise gains on both, so the fused noise path counts."""
    cpu = build_session(size, ATTENTION_LAYER, ATTENTION_LAYER, seed=0, device="cpu")
    gpu = build_session(size, ATTENTION_LAYER, ATTENTION_LAYER, seed=0, device="cuda")
    for sess in (cpu, gpu):
        g = torch.Generator().manual_seed(1)
        for name, p in sess.generator.named_parameters():
            if name.endswith("noise.weight"):
                p.data.copy_(0.1 * torch.randn(1, generator=g))
    return cpu, gpu


def phase_whole() -> None:
    size = 256
    cpu, gpu = whole_sessions(size)
    wplus = cpu.sample_wplus(7)
    n = (k1.launches, k3.launches)
    cpu.load_latent(wplus)
    gpu.load_latent(wplus.cuda())
    toks, att = tokenize([PROMPTS[0][0]]), tokenize([PROMPTS[0][1]])
    img_c, map_c = cpu.edit(toks, att, strength_alpha=0.2)
    img_g, map_g = gpu.edit(toks, att, strength_alpha=0.2)
    torch.cuda.synchronize()
    per_pass = 1 + len(gpu.generator.to_rgbs)  # conv1 + one conv per octave
    mapper_convs = len(gpu.mapper.layer_num) + 2
    check((k1.launches - n[0], k3.launches - n[1])
          == (2 * per_pass, 2 * per_pass + mapper_convs),
          "the card's 256² session ran on the kernels")
    cap_err, cap_rel = rel_err(gpu.image.cpu(), cpu.image)
    img_err, img_rel = rel_err(img_g.cpu(), img_c)
    map_err = float((map_g.cpu() - map_c).abs().max())
    emit({"phase": "whole", "size": size, "capture_max_abs_err": cap_err,
          "capture_rel_err": cap_rel, "image_max_abs_err": img_err,
          "image_rel_err": img_rel, "map_max_abs_err": map_err,
          "image_rel_tol": WHOLE_IMAGE_REL_TOL, "map_abs_tol": WHOLE_MAP_ABS_TOL})
    check(cap_rel <= WHOLE_IMAGE_REL_TOL and img_rel <= WHOLE_IMAGE_REL_TOL,
          f"256² image card vs CPU: rel {cap_rel}, {img_rel}")
    check(map_err <= WHOLE_MAP_ABS_TOL, f"256² map card vs CPU: {map_err}")


# ---------------------------------------------------------------------------
# phase 7a-7b: real-photo editing, e4e inversion at full width
# ---------------------------------------------------------------------------

INVERT_STAGES = ("invert", "capture") + STAGES


def e4e_checkpoint(generator, stylegan_size: int, seed: int) -> dict:
    """A reference-layout e4e checkpoint: a seeded random
    ``Encoder4Editing`` (drawn on the CPU), ``generator``'s weights as the
    decoder, and its mean latent, 1-D, as ``latent_avg``."""
    encoder = Encoder4Editing(stylegan_size=stylegan_size,
                              rng=torch.Generator().manual_seed(seed))
    state = {f"encoder.{k}": v for k, v in encoder.state_dict().items()}
    state.update({f"decoder.{k}": v.cpu() for k, v in generator.state_dict().items()})
    rng = torch.Generator(generator.device).manual_seed(0)
    with torch.no_grad():
        avg = generator.mean_latent(4096, rng)[0].cpu()
    return {"state_dict": state, "latent_avg": avg}


def encoder_flops(encoder, x) -> int:
    """FLOP of one forward at ``x``'s shape: 2 · multiply-adds of every
    conv and linear, counted by forward hooks (what the encoder really runs,
    e4e's gating included)."""
    total = 0

    def conv(m, _, out):
        nonlocal total
        total += 2 * out.numel() * m.in_channels // m.groups * math.prod(m.kernel_size)

    def linear(m, inp, _):
        nonlocal total
        total += 2 * inp[0].numel() * m.weight.shape[0]

    hooks = [m.register_forward_hook(conv if isinstance(m, torch.nn.Conv2d) else linear)
             for m in encoder.modules() if isinstance(m, (torch.nn.Conv2d, EqualLinear))]
    with torch.no_grad():
        encoder(x)
    for h in hooks:
        h.remove()
    return total


def phase_invert(session, card: str) -> tuple:
    """Returns ({kernel: launches} of the main path, the card's PSp, its
    checkpoint, the batch-1 input)."""
    gen = session.generator
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ckpt = e4e_checkpoint(gen, SIZE, seed=2)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "e4e.pt")
        torch.save(ckpt, path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        psp = load_psp(app_argparser().parse_args([
            "--e4e_ckpt", path, "--stylegan_size", str(SIZE), "--device", "cuda"]))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in psp.encoder.parameters())
    # 8 seeded faces at 1024², face-pooled to the encoder's 256², stand in for photos
    with torch.no_grad():
        faces = gen([session.sample_wplus(11, batch=8)], input_is_latent=True,
                    randomize_noise=False).image
    x8 = adaptive_avg_pool(faces, 256).clamp(-1.0, 1.0)
    x1 = x8[:1].contiguous()
    del faces

    def counts3():
        return k1.launches, k2.launches, k3.launches

    def expect(before, d1, d3, what):
        got = tuple(a - b for a, b in zip(counts3(), before))
        check(got == (d1, 0, d3), f"{what}: launches (K1, K2, K3) +{got}, "
                                  f"expected +({d1}, 0, {d3})")

    per_pass = 1 + len(gen.to_rgbs)
    mapper_convs = len(session.mapper.layer_num) + 2
    toks, att = tokenize([PROMPTS[0][0]]), tokenize([PROMPTS[0][1]])
    k1.launches = k2.launches = k3.launches = 0
    # --- the main path: invert, capture, edit; PSp.__call__; the CLI ---
    before = counts3()
    w8 = psp.encode(x8)
    torch.cuda.synchronize()
    check(tuple(w8.shape) == (8, gen.n_latent, 512), f"W+ shape {tuple(w8.shape)}")
    check(bool(torch.isfinite(w8).all()), "W+ is finite")
    expect(before, 0, 0, "psp.encode (cuDNN, no port kernel)")
    before, prepares = counts3(), k1.prepares
    img = session.load_latent(w8[:1])
    torch.cuda.synchronize()
    check(tuple(img.shape) == (1, SIZE, SIZE, 3) and bool(torch.isfinite(img).all()),
          "captured image of the inverted face")
    expect(before, per_pass, per_pass, "load_latent of the inverted face")
    before = counts3()
    img, amap = session.edit(toks, att)
    torch.cuda.synchronize()
    check_edit(img, amap, 1)
    expect(before, per_pass, per_pass + mapper_convs, "edit of the inverted face")
    check(k1.prepares == prepares, "capture and edit prepared no K1 weights")
    before = counts3()
    out = psp(x1)
    torch.cuda.synchronize()
    check(tuple(out.shape) == (1, 256, 256, 3) and bool(torch.isfinite(out).all()),
          f"PSp.__call__ image {tuple(out.shape)}")
    expect(before, per_pass, per_pass, "PSp.__call__ (its decoder's synthesis)")
    cli_rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        bank = os.path.join(tmp, "bank.npy")
        np.save(bank, w8[:2].cpu().numpy())
        common_args = ["--stylegan_size", str(SIZE), "--device", "cuda",
                       "--output_dir", os.path.join(tmp, "out"), "--text"]
        texts = [p[0] for p in PROMPTS[:2]]
        for name, source, n_faces in (("latent", ["--latent", bank], 2),
                                      ("celeb", ["--celeb", "Celeb 1"], 1)):
            n_texts = len(texts) if name == "latent" else 1
            before = counts3()
            rows = edit_cli.main([*source, *common_args, *texts[:n_texts]])
            torch.cuda.synchronize()
            check([(r["text"], r["face"]) for r in rows]
                  == [(t, f) for t in texts[:n_texts] for f in range(n_faces)],
                  f"cli --{name}: rows {[(r['text'], r['face']) for r in rows]}")
            expect(before, per_pass * (1 + n_texts),
                   per_pass * (1 + n_texts) + mapper_convs * n_texts, f"cli --{name}")
            cli_rows[name] = len(rows)
    launches = {"modconv3x3": k1.launches, "conv3x3": k2.launches,
                "modconv1x1": k3.launches}
    emit({"phase": "invert", "step": "main_path", "card": card,
          "encoder": "Encoder4Editing, IR-SE50", "stylegan_size": SIZE,
          "n_latent": gen.n_latent, "encoder_params": n_params,
          "ckpt_save_s": save_s, "load_psp_s": load_s, "batch": 8,
          "launches": launches, "cli_rows": cli_rows})

    # --- latency: batch 1 and 8, then the stage split of a real-photo edit ---
    def fenced_ms(fn, reps):
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms

    b1 = fenced_ms(lambda: psp.encode(x1), 12)
    b8 = fenced_ms(lambda: psp.encode(x8), 5)
    stages = defaultdict(list)

    @contextlib.contextmanager
    def fenced(stage):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        stages[stage].append((time.perf_counter() - t0) * 1e3)

    for _ in range(10):
        with fenced("invert"):
            w1 = psp.encode(x1)
        with fenced("capture"):
            session.load_latent(w1)
        staged_edit(session, toks, att, fenced)
    flops = encoder_flops(psp.encoder, x1)
    nbytes = 4 * (n_params + x1.numel() + gen.n_latent * 512)
    bound_ms, bound_by = bound(nbytes, flops)
    emit({"phase": "invert", "step": "latency", "card": card,
          "p50_encode_ms_batch1": statistics.median(b1), "encode_ms_batch1": b1,
          "ms_per_image_batch8": statistics.median(b8) / 8, "encode_ms_batch8": b8,
          "p50_stage_ms": {k: statistics.median(stages[k]) for k in INVERT_STAGES},
          "p50_real_photo_edit_ms": sum(statistics.median(stages[k])
                                        for k in INVERT_STAGES),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "encoder_flop_per_image": flops, "encoder_bytes": nbytes,
          "fp32_bound_ms": bound_ms, "bound_by": bound_by})

    # --- where the time of an inversion goes ---
    rec = device_profile(lambda span: psp.encode(x1), (), 5)
    emit({"phase": "invert_profile", "card": card, "batch": 1, "inversions": 5,
          "wall_ms_per_inversion": rec["wall_ms"],
          "device_busy_ms_per_inversion": rec["device_busy_ms"],
          "device_idle_share": rec["device_idle_share"],
          "kernel_launches_per_inversion": rec["kernel_launches"],
          "fp32_bound_ms": bound_ms, "bound_share_of_busy": bound_ms / rec["device_busy_ms"],
          "categories": rec["categories"], "top_kernels": rec["top_kernels"]})
    return launches, psp, ckpt, x1


def phase_invert_whole(psp, ckpt: dict, x1) -> None:
    """The full-width encoder on the card and the CPU from one checkpoint
    and input; then e4e (14 rows) -> capture -> edit at 256², card against
    CPU."""
    cpu_psp = PSp.from_state_dict(ckpt, stylegan_size=SIZE, device="cpu")
    with torch.no_grad():
        w_c = cpu_psp.encoder(x1.cpu())
        w_g = psp.encoder(x1).cpu()
    w_err, w_rel = rel_err(w_g, w_c)
    rec = {"phase": "invert_whole", "stylegan_size": SIZE, "wplus_shape": list(w_c.shape),
           "wplus_max_abs_err": w_err, "wplus_rel_err": w_rel, "wplus_rel_tol": INVERT_REL_TOL}
    del cpu_psp
    check(w_rel <= INVERT_REL_TOL, f"e4e W+ card vs CPU: rel {w_rel}")

    size = 256
    cpu, gpu = whole_sessions(size)
    small = e4e_checkpoint(cpu.generator, size, seed=3)
    psp_c = PSp.from_state_dict(small, stylegan_size=size, device="cpu")
    psp_g = PSp.from_state_dict(small, stylegan_size=size, device="cuda")
    x = cpu.load_synthetic(5).clamp(-1.0, 1.0)  # a 256² face as the photo
    n = (k1.launches, k3.launches)
    toks, att = tokenize([PROMPTS[0][0]]), tokenize([PROMPTS[0][1]])
    w_c, w_g = psp_c.encode(x), psp_g.encode(x.cuda())
    cpu.load_latent(w_c)
    gpu.load_latent(w_g)
    img_c, map_c = cpu.edit(toks, att, strength_alpha=0.2)
    img_g, map_g = gpu.edit(toks, att, strength_alpha=0.2)
    torch.cuda.synchronize()
    per_pass = 1 + len(gpu.generator.to_rgbs)
    mapper_convs = len(gpu.mapper.layer_num) + 2
    check((k1.launches - n[0], k3.launches - n[1])
          == (2 * per_pass, 2 * per_pass + mapper_convs),
          "the card's 256² real-photo path ran on the kernels")
    small_rel = rel_err(w_g.cpu(), w_c)[1]
    cap_rel = rel_err(gpu.image.cpu(), cpu.image)[1]
    img_err, img_rel = rel_err(img_g.cpu(), img_c)
    map_err = float((map_g.cpu() - map_c).abs().max())
    rec.update({"path_size": size, "path_n_latent": int(w_c.shape[1]),
                "path_wplus_rel_err": small_rel, "path_capture_rel_err": cap_rel,
                "path_image_max_abs_err": img_err, "path_image_rel_err": img_rel,
                "path_map_max_abs_err": map_err, "image_rel_tol": WHOLE_IMAGE_REL_TOL,
                "map_abs_tol": WHOLE_MAP_ABS_TOL})
    emit(rec)
    check(small_rel <= INVERT_REL_TOL, f"256² e4e W+ card vs CPU: rel {small_rel}")
    check(cap_rel <= WHOLE_IMAGE_REL_TOL and img_rel <= WHOLE_IMAGE_REL_TOL,
          f"256² real-photo image card vs CPU: rel {cap_rel}, {img_rel}")
    check(map_err <= WHOLE_MAP_ABS_TOL, f"256² real-photo map card vs CPU: {map_err}")


# ---------------------------------------------------------------------------
# phase 8: adversarial training at full width through the CLI
# ---------------------------------------------------------------------------

PROGRAMS = ("d", "r1", "g", "path")


def train_launches(n_oct: int) -> dict:
    """{program: ((K1, K2, K3) forward, (K1, K2, K3) backward)} launches of
    one training program at a size with ``n_oct`` octaves above 4²: L =
    n_oct + 1 layers per kernel (the generator's conv1 and one 3x3 conv per
    octave for K1, its ToRGBs for K3; each ResBlock's conv1 and final_conv
    for K2). A Function launches its kernel once forward and once for each
    backward through it that needs its input gradient (the kernel itself);
    weight, style and demod gradients are plain.

    d: the fake batch (G forward, no grad), then D forward and backward on
    the real and on the fake batch. r1: D forward, the input gradient
    (create_graph), then the backward of that: through each of the L input
    gradients, and through the n_oct forward nodes ahead of the minibatch
    stddev, whose second derivative reaches the activations. g: G forward and
    backward, D forward and backward to the fake images (D's weights frozen).
    path: G forward, the W+ gradient (create_graph), then the backward of
    that: through the L input gradients but conv1's (it points at the
    constant input, not at W+), and through the L forward nodes (the style
    gradients read each layer's input)."""
    lay = n_oct + 1
    return {"d": ((lay, 2 * lay, lay), (0, 2 * lay, 0)),
            "r1": ((0, lay, 0), (0, 2 * lay + n_oct, 0)),
            "g": ((lay, lay, lay), (lay, lay, 0)),
            "path": ((lay, 0, lay), (3 * lay - 1, 0, 0))}


def total(a: tuple, b: tuple) -> tuple:
    return tuple(x + y for x, y in zip(a, b))


def counts() -> tuple:
    return k1.launches, k2.launches, k3.launches


class TrainProbe:
    """The ``span`` of ``cli/train_stylegan.main``: fences each program with
    ``torch.cuda.synchronize``, times it, reads the launch counters around
    it, and checks after each G step that every generator parameter has a
    non-zero gradient; snapshots G and D before the first program."""

    def __init__(self):
        self.records = []          # (step, program, ms, (K1, K2, K3))
        self.losses = []           # per iteration {name: float}
        self.start = None

    @contextlib.contextmanager
    def __call__(self, program, trainer):
        if self.start is None:
            self.start = {m: [p.detach().clone() for p in getattr(trainer, m).parameters()]
                          for m in ("g", "d")}
        torch.cuda.synchronize()
        before, t0 = counts(), time.perf_counter()
        yield
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = counts()
        self.records.append((trainer.global_step, program, ms,
                             tuple(a - b for a, b in zip(after, before))))
        if program == "g":
            zero = [n for n, p in trainer.g.named_parameters()
                    if p.grad is None or not bool(p.grad.abs().max() > 0)]
            check(not zero, f"G step {trainer.global_step}: no gradient for {zero}")
        if program == "ema":
            m = {k: float(v) for k, v in trainer.metrics.items()}
            check(all(math.isfinite(v) for v in m.values()),
                  f"iteration {trainer.global_step}: losses {m}")
            self.losses.append(m)


def phase_train(card: str) -> tuple:
    """Returns ({kernel: launches}, {kernel: launches inside backward
    passes}) of the training run."""
    probe = TrainProbe()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    k1.launches = k2.launches = k3.launches = 0
    # --- the main path: 5 iterations through the CLI ---
    with tempfile.TemporaryDirectory() as results:
        trainer = train_stylegan.main([*TRAIN_ARGS, "--results_dir", results],
                                      span=probe)
    launches = {"modconv3x3": k1.launches, "conv3x3": k2.launches,
                "modconv1x1": k3.launches}
    peak = torch.cuda.max_memory_allocated()
    for m in ("g", "d"):
        still = [n for (n, p), p0 in zip(getattr(trainer, m).named_parameters(),
                                         probe.start[m]) if torch.equal(p, p0)]
        check(not still, f"{m} parameters that did not move: {still}")
    expect = train_launches(trainer.g.log_size - 2)
    none = ((0, 0, 0), (0, 0, 0))
    backward = (0, 0, 0)
    for step, program, _, got in probe.records:
        fwd, bwd = expect.get(program, none)
        check(got == total(fwd, bwd), f"iteration {step} {program}: launches "
                                      f"(K1, K2, K3) {got}, expected {fwd} + {bwd}")
        backward = total(backward, bwd)
    ms = defaultdict(list)
    iteration_ms = defaultdict(float)
    for step, program, t, _ in probe.records:
        ms[program].append(t)
        iteration_ms[step] += t
    n_iter, batch = len(iteration_ms), trainer.cfg.batch_size
    plain_iters = [t for step, t in iteration_ms.items()
                   if step % trainer.cfg.g_reg_every and step % trainer.cfg.d_reg_every]
    emit({"phase": "train", "card": card, "size": SIZE, "batch": batch,
          "iterations": n_iter, "launches": launches,
          "launches_per_program": {p: total(*expect[p]) for p in PROGRAMS},
          "backward_launches_per_program": {p: expect[p][1] for p in PROGRAMS},
          "ms_per_program": {p: v for p, v in ms.items()},
          "iteration_ms": [iteration_ms[s] for s in sorted(iteration_ms)],
          "images_per_s": batch * n_iter / (sum(iteration_ms.values()) / 1e3),
          "images_per_s_without_regularizers":
              batch * len(plain_iters) / (sum(plain_iters) / 1e3),
          "losses": probe.losses, "peak_mem_gib": peak / 2 ** 30})
    return launches, dict(zip(launches, backward)), trainer


def phase_train_profile(trainer, card: str) -> None:
    """One more iteration of phase 8's trainer under ``torch.profiler``, at a
    step that runs every program (d, r1, g, path, ema). No per-program
    spans: backward kernels are launched from autograd's own thread, which
    a ``record_function`` span on the caller's thread does not cover (phase
    8's fenced ms per program is the split by program)."""
    g = torch.Generator("cuda").manual_seed(3)
    real = torch.rand(trainer.cfg.batch_size, SIZE, SIZE, 3, generator=g,
                      device="cuda") * 2 - 1
    trainer.global_step = 16 * trainer.cfg.g_reg_every * trainer.cfg.d_reg_every
    # PyTorch's own convolution backward and double backward (the latter ran
    # depthwise blurs one channel at a time) against ops/conv.py's Functions
    rec = device_profile(lambda span: trainer.step(real), (), 1, count_ops=(
        "ConvolutionBackward0", "ConvolutionBackwardBackward0",
        "_Conv2dBackward", "_ConvTranspose2dBackward"))
    emit({"phase": "train_profile", "card": card, "size": SIZE,
          "batch": trainer.cfg.batch_size,
          "losses": {k: float(v) for k, v in trainer.metrics.items()}, **rec})


# ---------------------------------------------------------------------------
# phase 10: one training iteration, card against CPU at 64²
# ---------------------------------------------------------------------------

def phase_train_whole() -> None:
    size, batch = 64, 4
    cfg = GANTrainConfig(size=size, batch_size=batch, channel_multiplier=2)
    cpu, gpu = GANTrainer(cfg, device="cpu"), GANTrainer(cfg, device="cuda")
    real = torch.from_numpy(np.random.default_rng(0).uniform(
        -1.0, 1.0, (batch, size, size, 3)).astype(np.float32))
    draws = cpu.draw(batch)
    path_draws = cpu.draw(cpu.path_batch())
    pl_noise = torch.randn(cpu.path_batch(), size, size, 3, generator=cpu.rng)

    def to_gpu(d: GANDraws) -> GANDraws:
        return GANDraws(d.z1.cuda(), d.z2.cuda(), d.inject.cuda(),
                        [n.cuda() for n in d.noise])

    # non-zero noise gains (they start at 0), so each layer's per-sample
    # noise reaches the images and the losses
    g = torch.Generator().manual_seed(1)
    for name, p in cpu.g.named_parameters():
        if name.endswith("noise.weight"):
            p.data.copy_(0.1 * torch.randn(1, generator=g))
    programs = [
        ("d", "d", lambda t, dev: t.d_step_with(real.to(dev),
                                               draws if dev == "cpu" else to_gpu(draws))),
        ("r1", "d", lambda t, dev: t.r1_step(real.to(dev))),
        ("g", "g", lambda t, dev: t.g_step_with(draws if dev == "cpu" else to_gpu(draws))),
        ("path", "g", lambda t, dev: t.path_step_with(
            path_draws if dev == "cpu" else to_gpu(path_draws), pl_noise.to(dev))[0]),
    ]
    n = counts()
    rec = {"phase": "train_whole", "size": size, "batch": batch,
           "loss_rel_tol": TRAIN_LOSS_REL_TOL, "param_grad_tol": TRAIN_PARAM_GRAD_TOL,
           "model_grad_tol": TRAIN_MODEL_GRAD_TOL}
    for program, model, run in programs:
        # each program from the same state on both sides
        for m in ("g", "d"):
            getattr(gpu, m).load_state_dict(getattr(cpu, m).state_dict())
        gpu.pl_mean = cpu.pl_mean.cuda()
        loss_c, loss_g = float(run(cpu, "cpu")), float(run(gpu, "cuda"))
        loss_rel = abs(loss_g - loss_c) / max(abs(loss_c), 1e-30)
        diff2 = ref2 = 0.0
        worst, worst_name = 0.0, None
        for (name, pc), pg in zip(getattr(cpu, model).named_parameters(),
                                  getattr(gpu, model).parameters()):
            if pc.grad is None and pg.grad is None:  # not in this loss's graph
                continue
            check(pc.grad is not None and pg.grad is not None,
                  f"64² {program} {name}: a gradient on one side only")
            gc, gg = pc.grad.double(), pg.grad.double().cpu()
            d2, r2 = float((gg - gc).square().sum()), float(gc.square().sum())
            diff2, ref2 = diff2 + d2, ref2 + r2
            e = math.sqrt(d2 / max(r2, 1e-60))
            if e > worst:
                worst, worst_name = e, name
        model_rel = math.sqrt(diff2 / ref2)
        rec[program] = {"loss_cpu": loss_c, "loss_card": loss_g, "loss_rel": loss_rel,
                        "model_grad_rel": model_rel, "worst_param_grad_rel": worst,
                        "worst_param": worst_name}
        check(loss_rel <= TRAIN_LOSS_REL_TOL, f"64² {program} loss: rel {loss_rel}")
        check(model_rel <= TRAIN_MODEL_GRAD_TOL, f"64² {program} grads: rel {model_rel}")
        check(worst <= TRAIN_PARAM_GRAD_TOL, f"64² {program} {worst_name}: rel {worst}")
    want = (0, 0, 0)
    for fwd, bwd in train_launches(int(math.log2(size)) - 2).values():
        want = total(want, total(fwd, bwd))
    got = tuple(a - b for a, b in zip(counts(), n))
    rec["launches"] = got
    emit(rec)
    check(got == want, f"64² card programs launched {got}, expected {want}")


# ---------------------------------------------------------------------------
# phase 11: k-means regions at full width (cli/run_clustering.py)
# ---------------------------------------------------------------------------

# the device of phases 11-14 ("cpu" rehearses them at a small SIZE)
DEV = "cuda"
CLUSTER_LAYER, N_CLUSTERS, CLUSTER_STEPS = 13, 10, 4
LLOYD_STEPS, LLOYD_ITERS, LLOYD_SUBSAMPLE = 20, 50, 65536
# Lloyd, card against CPU, each iteration from the CPU's centres of the one
# before (a trajectory held for 50 iterations is chaotic: one row that
# lands in the other centre changes every later step; a first chip run saw
# 20,723 of 65,536 rows end apart), max |Δ| / max |CPU| of the centres: fp32
# products summed in another order move a distance by ~1e-6 relative, and a
# row that close to two centres can take the other one (its centre's mean
# moves by ~1/count of the row's offset).
KMEANS_REL_TOL = 1e-3


def sync() -> None:
    if DEV == "cuda":
        torch.cuda.synchronize()


def cluster_args() -> list:
    return ["--stylegan_size", str(SIZE), "--channel_multiplier", "2",
            "--attention_layer", str(CLUSTER_LAYER), "--cluster_num",
            str(N_CLUSTERS), "--batch_size", "5", "--step", str(CLUSTER_STEPS),
            "--device", DEV]


def fenced_span(records: list):
    """A ``span(stage)`` that fences the stage with ``torch.cuda.synchronize``
    and appends (stage, ms, (K1, K2, K3) launches) to ``records``."""
    @contextlib.contextmanager
    def span(stage):
        sync()
        before, t0 = counts(), time.perf_counter()
        yield
        sync()
        records.append((stage, (time.perf_counter() - t0) * 1e3,
                        tuple(a - b for a, b in zip(counts(), before))))
    return span


def phase_cluster(card: str, keep_dir: str) -> tuple:
    """``cli/run_clustering.main`` at full width (its launches per pass and
    its pickle), then the device Lloyd at the CLI's default size, then the
    card's Lloyd against the CPU's. Returns ({kernel: launches}, the pickle's
    path, copied into ``keep_dir``)."""
    records = []
    k1.launches = k2.launches = k3.launches = 0
    # --- the main path: the CLI, with --step 4 (its one cut) ---
    with tempfile.TemporaryDirectory() as results:
        path = run_clustering.main([*cluster_args(), "--results_dir", results],
                                   span=fenced_span(records))
        centers = load_cluster_centers(path)
        kept = shutil.copy(path, keep_dir)
    launches = {"modconv3x3": k1.launches, "conv3x3": k2.launches,
                "modconv1x1": k3.launches}
    per_pass = (1 + int(math.log2(SIZE)) - 2, 0, 1 + int(math.log2(SIZE)) - 2)
    steps = CLUSTER_STEPS
    expect = {"collect": tuple(steps * n for n in per_pass), "fit": (0, 0, 0),
              "visualize": per_pass}
    for stage, _, got in records:
        check(got == expect[stage], f"run_clustering {stage}: launches {got}, "
                                    f"expected {expect[stage]}")
    width = channel_table(2)[tap_resolution(CLUSTER_LAYER)]
    check(centers.shape == (N_CLUSTERS, width + 2 * (width // 16))
          and bool(np.isfinite(centers).all()), f"centres {centers.shape}")
    ms = {stage: t for stage, t, _ in records}

    # --- the device Lloyd on the production-size matrix (--step 20) ---
    dev = torch.device(DEV)
    gen, _ = build_generator(SIZE, None, 2, device=dev)
    rng = torch.Generator(dev).manual_seed(200)
    mean_w = mean_latent(gen, rng)
    sync()
    t0 = time.perf_counter()
    data = collect_features(gen, mean_w, rng, layer=CLUSTER_LAYER, batch=5,
                            steps=LLOYD_STEPS)
    sync()
    collect_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    fit = kmeans_fit(data, N_CLUSTERS, backend="torch", num_iters=LLOYD_ITERS)
    lloyd_ms = (time.perf_counter() - t0) * 1e3
    check(fit.shape == centers.shape and bool(np.isfinite(fit).all()),
          f"device Lloyd centres {fit.shape}")

    # --- the card's Lloyd against the CPU's, iteration by iteration ---
    pick = torch.randperm(data.shape[0], generator=torch.Generator().manual_seed(0))
    sub = data[pick[:LLOYD_SUBSAMPLE].to(dev)]
    sub_cpu, c_cpu = sub.cpu(), sub[:N_CLUSTERS].cpu()
    abs_err = rel = 0.0
    ids_differ = 0
    for _ in range(LLOYD_ITERS):
        c_card = _lloyd(sub, c_cpu.to(dev), N_CLUSTERS, 1).cpu()
        ids_differ = max(ids_differ, int((assign_rows(sub, c_cpu.to(dev)).cpu()
                                          != assign_rows(sub_cpu, c_cpu)).sum()))
        c_cpu = _lloyd(sub_cpu, c_cpu, N_CLUSTERS, 1)
        err = rel_err(c_card, c_cpu)
        abs_err, rel = max(abs_err, err[0]), max(rel, err[1])
    nbytes = data.numel() * 4
    emit({"phase": "cluster", "card": card, "size": SIZE, "layer": CLUSTER_LAYER,
          "cli_args": cluster_args(), "cli_matrix": [steps * 5 * (2 * tap_resolution(
              CLUSTER_LAYER)) ** 2, centers.shape[1]],
          "cli_ms": ms, "cli_launches": launches, "launches_per_pass": per_pass,
          "pickle_shape": list(centers.shape),
          "lloyd_matrix": list(data.shape), "lloyd_gb": nbytes / 1e9,
          "lloyd_collect_ms": collect_ms, "lloyd_iters": LLOYD_ITERS,
          "lloyd_ms": lloyd_ms, "lloyd_ms_per_iter": lloyd_ms / LLOYD_ITERS,
          # each iteration reads the matrix twice (distances, one-hot sums)
          "lloyd_read_bound_ms": 2 * LLOYD_ITERS * nbytes / HBM_BYTES_PER_S * 1e3,
          "card_vs_cpu": {"rows": LLOYD_SUBSAMPLE, "iterations": LLOYD_ITERS,
                          "max_abs_err": abs_err, "max_rel_err": rel,
                          "tol": KMEANS_REL_TOL, "max_ids_differ": ids_differ}})
    check(rel <= KMEANS_REL_TOL, f"Lloyd card vs CPU: rel {rel}")
    del data, sub, gen
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return launches, kept


def assign_rows(data: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    d = (data.square().sum(-1, keepdim=True) - 2.0 * (data @ centers.t())
         + centers.square().sum(-1)[None, :])
    return d.argmin(dim=1)


# ---------------------------------------------------------------------------
# phases 12-14: region-attention training (cli/run_attention.py)
# ---------------------------------------------------------------------------

TRAIN_ATTENTION_LAYER = 8
ATTENTION_BATCH, ATTENTION_STEPS = 8, 6
ATTENTION_STAGES = ("synthesis", "cond_clip", "mapper", "edit", "losses",
                    "backward", "adam")


def attention_launches(n_oct: int, mapper_convs: int) -> dict:
    """{stage: (K1, K2, K3) launches} of one production training step at a
    size with ``n_oct`` octaves above 4²: L = n_oct + 1 layers per kernel
    (the generator's conv1 and one 3x3 conv per octave for K1, its ToRGBs
    for K3). synthesis: the target (row 0) and the conditioning batch;
    mapper: its attention convs; edit: the blended synthesis; backward: K1's
    input gradient at every 3x3 conv but conv1 (its input is the frozen
    constant), K3's backward is plain."""
    lay = n_oct + 1
    return {"synthesis": (2 * lay, 0, 2 * lay), "cond_clip": (0, 0, 0),
            "mapper": (0, 0, mapper_convs), "edit": (lay, 0, lay),
            "losses": (0, 0, 0), "backward": (n_oct, 0, 0), "adam": (0, 0, 0)}


class AttentionProbe:
    """The ``span`` of ``cli/run_attention.main``: fences each stage, times
    it, reads the launch and K1-preparation counters around it; checks
    after each backward that no generator, CLIP or VGG parameter has a
    gradient, after step 0 that nothing moved (lr 0), after step 1 that
    every trained mapper parameter moved."""

    def __init__(self):
        self.records = []          # (step, stage, ms, (K1, K2, K3), prepares)
        self.trainer = None
        self.start = None
        self.step = -1

    @contextlib.contextmanager
    def __call__(self, stage, trainer):
        if self.trainer is None:
            self.trainer = trainer
            self.start = {n: p.detach().clone()
                          for n, p in trainer.mapper.named_parameters()}
        if stage == "synthesis":
            self.step += 1
        sync()
        before, prep, t0 = counts(), k1.prepares, time.perf_counter()
        yield
        sync()
        self.records.append((self.step, stage, (time.perf_counter() - t0) * 1e3,
                             tuple(a - b for a, b in zip(counts(), before)),
                             k1.prepares - prep))
        if stage == "backward":
            frozen = [m for m in (trainer.generator, trainer.clip_loss.model,
                                  trainer.perceptual.vgg)
                      for p in m.parameters() if p.grad is not None]
            check(not frozen, f"step {self.step}: {len(frozen)} frozen "
                              "parameters have a gradient")
        if stage == "adam" and self.step in (0, 1):
            moved = {n for n, p in trainer.mapper.named_parameters()
                     if not torch.equal(p, self.start[n])}
            if self.step == 0:
                check(not moved, f"step 0 (lr 0) moved {sorted(moved)[:5]}")
            else:
                want = {n for n in trainer.param_names if not is_attention_param(n)}
                check(want <= moved, f"step 1: did not move {sorted(want - moved)[:5]}")


def phase_attention(card: str, cluster_path: str) -> tuple:
    """Returns ({kernel: launches}, {kernel: launches in backward passes},
    the trainer)."""
    probe = AttentionProbe()
    if DEV == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    k1.launches = k2.launches = k3.launches = 0
    with tempfile.TemporaryDirectory() as results:
        args = ["--stylegan_size", str(SIZE), "--work_in_stylespace",
                "--use_cluster", "--cluster_path",
                cluster_path, "--batch_size", str(ATTENTION_BATCH), "--step",
                str(ATTENTION_STEPS), "--save_intermediate_image_every", "0",
                "--device", DEV, "--results_dir", results]
        out_dir = run_attention.main(args, span=probe)
        launches = {"modconv3x3": k1.launches, "conv3x3": k2.launches,
                    "modconv1x1": k3.launches}
        peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
        trainer = probe.trainer
        (log_dir,) = glob.glob(os.path.join(results, "logs", "*"))
        losses = [r["value"] for r in read_scalars(log_dir) if r["tag"] == "loss/loss"]
        ckpt_path = os.path.join(out_dir, "final_mapper.pt")
        check(os.path.isfile(ckpt_path), "no final checkpoint")
        resumed = run_attention.main(args[:-1] + [os.path.join(results, "resumed"),
                                                  "--resume", ckpt_path])
        a = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        b = torch.load(os.path.join(resumed, "final_mapper.pt"), map_location="cpu",
                       weights_only=True)
    check(len(losses) == ATTENTION_STEPS and all(map(math.isfinite, losses)),
          f"losses {losses}")
    check(b["step"] == a["step"] == ATTENTION_STEPS
          and all(torch.equal(a["mapper"][k], b["mapper"][k]) for k in a["mapper"])
          and a["adam"]["count"] == b["adam"]["count"], "--resume did not load the checkpoint")
    unchanged = [n for n, p in trainer.mapper.named_parameters()
                 if is_attention_param(n) and not torch.equal(p, probe.start[n])]
    check(not unchanged, f"frozen attention parameters moved: {unchanged[:5]}")
    expect = attention_launches(trainer.generator.log_size - 2,
                                len(trainer.mapper.layer_num) + 2)
    stage_ms = defaultdict(list)
    step_ms = defaultdict(float)
    for step, stage, ms, got, prep in probe.records:
        check(got == expect[stage], f"step {step} {stage}: launches {got}, "
                                    f"expected {expect[stage]}")
        check(prep == 0, f"step {step} {stage}: {prep} K1 weight preparations")
        if step >= 1:
            stage_ms[stage].append(ms)
            step_ms[step] += ms
    backward = expect["backward"]
    steps = sorted(step_ms)
    per_step = [step_ms[s] for s in steps]
    emit({"phase": "attention", "card": card, "size": SIZE, "batch": ATTENTION_BATCH,
          "steps": ATTENTION_STEPS, "attention_layer": TRAIN_ATTENTION_LAYER,
          "cluster_layer": CLUSTER_LAYER, "losses": losses, "launches": launches,
          "launches_per_step": {k: v for k, v in expect.items() if any(v)},
          "step_ms": per_step, "mean_step_ms": statistics.mean(per_step),
          "stage_ms_mean": {k: statistics.mean(v) for k, v in stage_ms.items()},
          "samples_per_s": ATTENTION_BATCH * len(per_step) / (sum(per_step) / 1e3),
          "peak_mem_gib": peak / 2 ** 30,
          "note": "steps 1-5 (step 0 builds cuDNN plans and caches), each "
                  "stage fenced by torch.cuda.synchronize"})
    n_steps = 1 + max(s for s, *_ in probe.records)
    return (launches, dict(zip(launches, (n * n_steps for n in backward))), trainer)


def phase_attention_profile(trainer, card: str) -> None:
    """One more step of phase 12's trainer under ``torch.profiler`` (no
    stage spans: backward kernels run on autograd's own thread)."""
    trainer.span = lambda stage, tr: contextlib.nullcontext()
    with torch.no_grad():
        bank = trainer.clip_loss.encode_text(
            torch.from_numpy(np.asarray(tokenize(list(ATTENTION_PROMPTS)))).long().to(DEV))
    out = {}

    def run(span):
        out["aux"] = trainer.step(ATTENTION_STEPS, bank)[0]

    rec = device_profile(run, (), 1)
    emit({"phase": "attention_profile", "card": card, "size": SIZE,
          "batch": trainer.cfg.batch_size,
          "losses": {k: float(v) for k, v in out["aux"].items()}, **rec})


def attention_parts(size: int, device: str, seed: int = 0) -> tuple:
    """(generator, mapper, CLIP loss, perceptual loss) at ``size`` with
    seeded random weights, full-width CLIP ViT-B/32 and VGG16; the mapper's
    centres carry no feature part (only position), so every pixel's region
    is set by geometry alone and the card and the CPU cannot split a
    near-tie two ways."""
    rng = torch.Generator().manual_seed(seed)
    gen = Generator(size, rng=rng)
    with torch.no_grad():  # non-zero noise gains, so the noise path counts
        for name, p in gen.named_parameters():
            if name.endswith("noise.weight"):
                p.copy_(0.1 * torch.randn(1, generator=rng))
    mapper = FullSpaceMapperFEATClusterLinStyle(
        layers=gen.n_latent, attention_layer=TRAIN_ATTENTION_LAYER,
        cluster_layer=CLUSTER_LAYER, generator_size=size, rng=rng)
    pos = torch.rand(N_CLUSTERS, 2, generator=rng) * 2 - 1
    with torch.no_grad():
        mapper.initial_state.zero_()
        mapper.initial_state[:, 512:544] = pos[:, :1]
        mapper.initial_state[:, 544:] = pos[:, 1:]
    clip = CLIP(rng=torch.Generator().manual_seed(seed + 1))
    vgg = Vgg16(rng=torch.Generator().manual_seed(seed + 2))
    gen, mapper, clip, vgg = (m.to(device).eval() for m in (gen, mapper, clip, vgg))
    return gen, mapper, CLIPLoss(clip, size), PerceptualLoss(vgg, size)


def phase_attention_whole() -> None:
    """One training step at 64² on the card and on the CPU from the same
    weights and draws, every mapper gradient unmasked
    (``freeze_attention_until`` 0): each loss term within
    ``TRAIN_LOSS_REL_TOL``, the mapper's gradient within
    ``TRAIN_MODEL_GRAD_TOL`` (whole model) and ``TRAIN_PARAM_GRAD_TOL`` (per
    tensor)."""
    size, batch, step_idx = 64, 4, 60
    cfg = AttentionTrainConfig(stylegan_size=size, attention_layer=TRAIN_ATTENTION_LAYER,
                               cluster_layer=CLUSTER_LAYER, batch_size=batch,
                               step=300, work_in_stylespace=True,
                               freeze_attention_until=0.0)
    cpu_parts = attention_parts(size, "cpu")
    gpu_parts = attention_parts(size, DEV)
    g = torch.Generator().manual_seed(5)
    draws = Draws(torch.randn(batch, 512, generator=g), torch.randn(batch, 512, generator=g),
                  torch.randint(0, 7, (batch,), generator=g))
    bank = torch.randn(7, 512, generator=g)
    mean_w = cpu_parts[0].mean_latent(256, torch.Generator().manual_seed(6))
    n = counts()
    result = {}
    for dev, (gen, mapper, clip_loss, perceptual) in (("cpu", cpu_parts),
                                                        (DEV, gpu_parts)):
        trainer = AttentionTrainer(cfg, generator=gen, mapper=mapper,
                                   clip_loss=clip_loss, perceptual=perceptual,
                                   mean_latent=mean_w.to(dev))
        aux, _, _ = trainer.step_with(Draws(*(t.to(dev) for t in draws)), step_idx,
                                      bank.to(dev))
        result[dev] = ({k: float(v) for k, v in aux.items()},
                       {name: p.grad.double().cpu()
                        for name, p in zip(trainer.param_names, trainer.params)})
    launches = tuple(a - b for a, b in zip(counts(), n))
    (loss_c, grad_c), (loss_g, grad_g) = result["cpu"], result[DEV]
    loss_rel = {k: abs(loss_g[k] - loss_c[k]) / max(abs(loss_c[k]), 1e-30)
                for k in loss_c}
    diff2 = ref2 = 0.0
    worst, worst_name = 0.0, None
    for name, gc in grad_c.items():
        d2, r2 = float((grad_g[name] - gc).square().sum()), float(gc.square().sum())
        diff2, ref2 = diff2 + d2, ref2 + r2
        e = math.sqrt(d2 / max(r2, 1e-60)) if d2 > 0 else 0.0
        if e > worst:
            worst, worst_name = e, name
    model_rel = math.sqrt(diff2 / ref2)
    emit({"phase": "attention_whole", "size": size, "batch": batch, "step_idx": step_idx,
          "losses_cpu": loss_c, "losses_card": loss_g, "loss_rel": loss_rel,
          "model_grad_rel": model_rel, "worst_param_grad_rel": worst,
          "worst_param": worst_name, "card_launches": launches,
          "loss_rel_tol": TRAIN_LOSS_REL_TOL, "param_grad_tol": TRAIN_PARAM_GRAD_TOL,
          "model_grad_tol": TRAIN_MODEL_GRAD_TOL})
    bad = {k: v for k, v in loss_rel.items() if not v <= TRAIN_LOSS_REL_TOL}
    check(not bad, f"64² attention step losses: {bad}")
    check(model_rel <= TRAIN_MODEL_GRAD_TOL, f"64² mapper grads: rel {model_rel}")
    check(worst <= TRAIN_PARAM_GRAD_TOL, f"64² mapper {worst_name}: rel {worst}")


def main(argv=None) -> None:
    global _out_file
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also append every JSON line here")
    args = ap.parse_args(argv)
    if args.out:
        _out_file = open(args.out, "a")  # noqa: SIM115
    try:
        card = phase_device()
        phase_build()
        totals = phase_kernels()
        train_fwd_err, backward_err = phase_backward()
        edit_launches, session = phase_slice()
        phase_profile(session, card)
        phase_whole()
        invert_launches, psp, ckpt, x1 = phase_invert(session, card)
        del session
        phase_invert_whole(psp, ckpt, x1)
        del psp, ckpt
        train_launches_run, backward_launches, trainer = phase_train(card)
        phase_train_profile(trainer, card)
        del trainer
        phase_train_whole()
        with tempfile.TemporaryDirectory() as keep:
            cluster_launches, cluster_path = phase_cluster(card, keep)
            attention_run, attention_backward, trainer = phase_attention(
                card, cluster_path)
        phase_attention_profile(trainer, card)
        del trainer
        torch.cuda.empty_cache()
        phase_attention_whole()
    finally:
        if _out_file is not None:
            _out_file.close()
    sources = {"modconv3x3": ("where2edit_tpu_torch/csrc/modconv3x3.cu",
                              "tools/conv3x3_bench.py:185"),
               "conv3x3": ("where2edit_tpu_torch/csrc/conv3x3.cu",
                           "tools/conv3x3_bench.py:92"),
               "modconv1x1": ("where2edit_tpu_torch/csrc/modconv1x1.cu",
                              "tools/pallas_bench.py:56")}
    backward_checks = {  # what phase 4's backward comparison holds
        "modconv3x3": "kernel input gradient, plain style/w/demod/noise/bias "
                      "gradients, against autograd through the plain version",
        "conv3x3": "kernel input gradient, plain w/bias gradients, against "
                   "autograd through the plain version",
        "modconv1x1": "plain backward only (no kernel launch: the input "
                      "gradient's width is Cin > 32), hand-written formulas "
                      "against autograd through the plain version"}
    cores = {  # what computes each kernel
        "modconv3x3": "tensor cores (wgmma), 3xTF32, on csrc/conv3x3_tc.cuh",
        "conv3x3": "tensor cores (wgmma), 3xTF32, on csrc/conv3x3_tc.cuh",
        "modconv1x1": "fp32 FMA units"}
    kernels = []
    for name, (src, replaces) in sources.items():
        tot = totals[name]
        by_path = {"edit": edit_launches.get(name, 0), "invert": invert_launches[name],
                   "train": train_launches_run[name], "cluster": cluster_launches[name],
                   "attention": attention_run[name]}
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "train_backward_launches": backward_launches[name],
            "attention_backward_launches": attention_backward[name],
            "max_abs_err": tot["max_abs_err"],
            "max_rel_err": tot["max_rel_err"],
            "train_forward_max_rel_err": train_fwd_err[name],
            "backward_max_rel_err": backward_err[name],
            "backward_check": backward_checks[name], "ms": tot["ms"],
            "device_ms": tot["device_ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if tot["bytes_s"] >= tot["ops_s"] else "operations",
            "fma_bound_ms": tot["fma_bound_ms"],
            "library_ms": tot["library_ms"],
            "library_device_ms": tot["library_device_ms"],
            **({"prepared_ms": tot["prepared_ms"],
                "prepared_device_ms": tot["prepared_device_ms"]}
               if name == "modconv3x3" else {}),
            "core": cores[name],
            "note": "ms, device_ms, plain_ms, bound_ms, library_ms: sums over "
                    + ("the 1024² discriminator's shapes at batch 8"
                       if name == "conv3x3" else "the edit path's shapes at batch 1")
                    + ", one call each; ms, plain_ms and library_ms are eager "
                    "calls back to back (the host's launch cost included), "
                    "device_ms and library_device_ms are the kernel and the "
                    "library call replayed from a CUDA graph (modconv3x3's "
                    "prepared_ms and prepared_device_ms: with its weights "
                    "prepared once, as the edit path calls it); bound_ms at the "
                    "3xTF32 tensor-core rate for modconv3x3 and conv3x3 "
                    "(fma_bound_ms at the fp32 FMA rate), at the fp32 FMA "
                    "rate for modconv1x1; "
                    "launches: the edit path's run (phase 5), the real-photo "
                    "path's (phase 7a), the training run's (phase 8), of "
                    "which train_backward_launches inside backward passes, "
                    "the k-means CLI's (phase 11) and the attention "
                    "trainer's CLI run (phase 12), of which "
                    "attention_backward_launches inside backward passes"})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

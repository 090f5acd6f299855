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
   that K1's and K2's libraries (both on ``csrc/conv3x3_tc.cuh``, fp32, and
   ``csrc/conv3x3_bf16.cuh``, bf16) and K3's (its bf16 form) hold
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
3b. kernels_bf16 — the bf16 forms against their plain twins (the bf16
   operands upcast, the kernels' roundings, fp32 arithmetic, one rounding):
   K1-bf16 at the generator's 9 shapes and K2-bf16 at the
   discriminator's 9 (final_conv's 513 inputs included), each at batch 1,
   2, 4 and 8, K3-bf16 at the 28 edit-path 1x1 shapes at batch 1 with fp32
   and with bf16 output, at the 9 ToRGBs at batch 8 and 2 with fp32 output,
   at the attention trainer's 18 bf16-input mapper convs at batch 8 with
   bf16 output and at its core's tile edges (P = 16 and 64, batch 1 and 8,
   both outputs); the kernels line sums the shapes the bf16 trainers
   launch; max |Δ| / max
   |twin| <= 8e-3, K1-bf16 prepared against per call bitwise, ms, device
   ms, the bf16 bound (2 bytes per bf16 value; operations at the tensor
   cores' 989 TFLOP/s for all three kernels: K3-bf16's ToRGBs sum on the
   FMA units but are bound by their bytes),
   the twin's ms and the library's bf16 ms; a device time under 0.95 of
   its bound fails.
3c. kernels_k5 — K5 (``upfirdn2d``) at every call site of the 1024²
   generator and discriminator at batch 8 (the up-conv's blur at 8²-1024²,
   the ToRGB skip at 3 channels, the discriminator's two blurs), in fp32
   and, bar the skip, in bf16: against its plain version (fp32
   ``KERNEL_REL_TOL``; bf16 the plain version on the upcast input, rounded
   once, ``BF16_KERNEL_REL_TOL``), two calls bitwise, one launch a call;
   its plan (form, rows a thread, grid); ms, device ms (CUDA graph), the
   plain version's ms and cuDNN's depthwise conv alone on the stuffed,
   padded input as ``library_ms`` (what the port ran before; never called
   by the port); the bound (bytes: x read once, the output written once;
   or the taps that land on real samples at 67 TFLOP/s) and
   ``bound_share``; a device time under 0.95 of its bound fails.
3d. kernels_k4 — K4 (``upconv``) at the eight up-convs of the 1024²
   generator (8²-1024² out, Cin/Cout 512…64/32) at batch 8: against its
   plain twin (modulate, cuDNN's ``conv_transpose2d``, demod; ``K4_REL_TOL``),
   two calls bitwise, one launch a call; its plan (items and blocks per
   phase, shared memory); ms, device ms (CUDA graph), the twin's ms, and
   ``library_ms``: cuDNN's ``conv_transpose2d`` on the modulated input plus
   the demod pass (what the port ran before K4; never called by the port);
   the bound (9·Cin·Cout MACs per input pixel at the 3xTF32 rate, bytes
   beside it) and ``bound_share``, summed over the eight shapes (0.274 ms
   per image); a device time under 0.95 of its bound fails.
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
4b. backward_bf16 — K1-bf16 and K2-bf16 at the trainer's shapes, batch 8:
   every input gradient (the input gradient on the bf16 kernel) against
   autograd through the plain twins, relative L2 <= 1e-2.
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
7c. wplus_edit — ``EditSession(work_in_stylespace=False)`` with the W+
   production mapper ``FullSpaceMapperFEATClusterLin`` (attention and
   cluster layer 13, seeded random weights) on phase 5's generator and text
   tower: with the counters at 0, one capture, three edits and one 2-prompt
   sweep (K1 as the S-space edit, K3 less its mapper's 19 attention convs:
   the W+ trunk's convs are plain matmuls; no K1 weight preparation); the
   p50 of 12 edits and the fenced stage split; 5 edits under
   ``torch.profiler`` (as phase 6); card against CPU at 256² on phase 7's
   sessions, at phase 7's bars.
7d. server — ``demo/server.py``'s ``ThreadingHTTPServer`` on 127.0.0.1 (an
   ephemeral port, in a thread) over a fresh 1024² S-space session: GET
   ``/`` and ``/celebs``; the 400s of ``/invert`` without e4e, an unknown
   gallery face and ``source=session`` before any face; then 8 seeded edit
   requests with the counters at 0 (a capture and an edit each), over HTTP
   when Pillow can encode the JPEGs, else through ``edit_request`` (the
   route is printed); their p50 beside phases 5 and 7c.
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
   device time by kernel category and by kernel; a cuDNN depthwise conv or
   depthwise input gradient there fails (every blur is K5).
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
14a. mapper_load — ``demo/app.py::load_session`` with ``--mapper`` at
   1024² on a reference ``.pt`` (DDP ``module.`` keys, dead
   ``mapper_textca_{c}`` entries), the same without ``initial_state``, and
   phase 12's ``final_mapper.pt``: an edit equals, bitwise, that of a
   session holding the same mapper in memory and differs from the random
   mapper's; without centres the load succeeds and the edit refuses, as the
   JAX mapper without its clusters collection does.
14b. wplus_train — ``cli/run_attention.py --use_cluster`` in W+
   (``FullSpaceMapperFEATClusterLin``) on phase 11's pickle, 1024², batch
   8, 4 steps, with phase 12's probe and launch table (no K3 in the mapper
   stage): ms per step over steps 1-3, stages, samples/s, peak memory (≤ 80
   GB); ``FullSpaceMapperFEATLin`` and ``FullSpaceMapperFEATLinStyle`` for
   2 steps at 256², batch 2; one W+ step at 64² card against CPU at phase
   14's bars.
15a. evaluate_edits — ``cli/evaluate.py edits`` through ``main`` at 1024²
   (the edit cell's seeded session, ViT-B/32 CLIP with seeded random
   weights, the seeded InceptionV3 and ArcFace IR-SE50 of
   ``tests/torch_parity.py`` from files), batch 2, 8 iterations, with the
   launch counters set to 0 just before: the result's keys and ranges, K1
   and K3 per stage and per iteration (a capture and an edit: 18 and 37,
   no K2), ms per stage fenced over iterations 1-5, peak memory; iterations
   6-7 under ``torch.profiler`` (``evaluate_profile``: device busy per
   stage, idle share, categories).
15b. evaluate_iou — ``cli/evaluate.py iou`` at 1024² on 8 synthetic
   CelebAMask-HQ pairs (phase 7a's faces as JPEGs, seeded 0-13 label
   PNGs) with phase 7a's e4e checkpoint: per-class and macro IoU in [0, 1],
   launches per image (a capture and 8 mapper calls: K1 9, K3 9 + 8 x 19),
   ms per image by stage (invert, capture, mapper).
15c. evaluate_whole — card against CPU on the same seeded weights:
   InceptionV3 at batch 2, 299² and ArcFace at batch 2, 112²
   (``EVAL_REL_TOL``); the edit sweep's ``EditEvaluator`` at 64² from the
   same W+ and token ids through the CLI's loaders (``EVAL_*_TOL``).
15d. train_fid — ``cli/train_stylegan.py`` at 1024², batch 8, 2 iterations
   with ``--fid_every 2 --fid_n 16 --fid_batch 8`` and the seeded
   InceptionV3: the programs' launches as phase 8, the FID pass's (two
   EMA syntheses), a finite printed and logged ``eval/fid``, the FID
   pass's ms.
16a. styleclip_train — ``cli/mapper_train.main`` at 1024²: ``LevelsMapper``,
   batch 2, test batch 1, Ranger at lr 0.5, λ_id 0.1 (the seeded ArcFace
   IR-SE50 of ``tests/torch_parity.py`` from a file), λ_clip 1.0 (ViT-B/32
   with seeded random weights), λ_l2 0.8; 7 steps (``--max_steps 6``) over
   16 self-sampled latents, 8 test latents (the defaults' 5000 and 1000 cut
   for the run's time); a ``CoachProbe`` span: every stage fenced, K1 and K3
   launches per stage against ``styleclip_launches`` (forward: a decode and
   an edit synthesis; backward: K1's input gradient), K1's weights prepared
   once (the first synthesis) and never again, no gradient in a frozen model, one in every mapper
   parameter; finite losses at every step; the checkpoints; the p50 step
   and its stage split over steps 1-6, samples/s, peak memory, the latent
   sampling's and each validation's ms.
16b. styleclip_stylespace — the same with ``--work_in_stylespace
   --mapper_type WithoutToRGBStyleSpaceMapper``, 3 steps:
   ``Generator.stylespace`` and the S-space decode.
16c. styleclip_inference — ``cli/mapper_inference.main`` on 16a's
   ``best_model.pt``, 8 of its test latents, test batch 2,
   ``--couple_outputs``: launches (two syntheses per batch) held exactly,
   ms per batch from ``stats.txt``, the saved latents against
   ``w + 0.1·mapper(w)`` from the checkpoint's weights.
16d. styleclip_whole — one coach step at 64², batch 2, card against CPU
   from the same weights and W+, for ``LevelsMapper`` and
   ``FullStyleSpaceMapper``: loss terms, the mapper's gradient (phase 10's
   bars), under ``cudnn.deterministic``; 7 Ranger steps from the same
   parameters and gradients (``RANGER_REL_TOL``).
17a. train_bf16 — ``cli/train_stylegan.main`` at 1024², batch 8, 5
   iterations with ``--bf16 --d_bf16 --workers 2 --hflip --sample_every 5
   --n_sample 4``, warm-started with ``--ckpt`` from a ``g_ema`` file the
   phase writes: every K1, K2 and K3 launch a bf16 form, launches per
   program as phase 8, images/s, ms per program, peak memory beside phase
   8's; the sample grid; then one iteration profiled with shapes
   (``train_bf16_profile``): kernel time by form, and no cuDNN
   convolution on a K1 or K2 shape.
17b. train_levers — 2 iterations at 1024², batch 16, ``--bf16 --remat
   --d_bf16 --d_remat --d_microbatch 4 --g_microbatch 8``: peak memory, ms
   per program, and the launches remat's second forwards add.
17c. attention_bf16, styleclip_bf16 — ``cli/run_attention.main --bf16
   --remat`` (1024², batch 8, 4 steps, S-space production branch) and
   ``cli/mapper_train.main --bf16`` (1024², batch 2, 4 steps): ms per step
   with the fenced stage split, peak memory, every launch a bf16 form.
17d. bf16_whole — card against CPU in bf16 under ``cudnn.deterministic``:
   one GAN iteration at 64² (every K1 and K2 conv at 512 or 513 input
   channels) and one at 256² with channel multiplier 1 (64 and 128 at
   256² and 128²: the bf16 core's single-accumulator side), one mapper
   step, one coach step at 64²; loss terms rel <= 1e-2, whole-model
   gradient rel L2 <= 5e-2, the GANs' image rel <= 1e-2.
18. dp — data parallelism (``where2edit_tpu_torch/parallel/``) at world
   size 1 over NCCL, in this process, under ``cudnn.deterministic`` (but
   the fp32 GAN pair: cuDNN's deterministic fp32 input gradient of the
   strided convs is too slow at 1024²): each
   of the five CLIs with ``--dp 1`` (``--use_mesh`` for
   ``cli/mapper_train.py``) against the same run without a group, each
   run under ``torch.profiler`` with the launch counters set to 0 just
   before: ``train_stylegan`` at 1024², batch 8, 3 iterations with R1 and
   path length at 0 and 2, in fp32 and with ``--bf16 --d_bf16`` (the step
   lines it prints, every iteration's metrics and the final checkpoint's
   G, D, G_ema and ``pl_mean``), ``run_attention`` (1024², batch 8, 2
   steps: every logged loss), ``run_clustering`` (1024², layer 13, batch 2,
   1 step: the centres), ``evaluate edits`` (batch 2, 2 iterations: the
   JSON result) and ``mapper_train`` (batch 2, 2 steps: the logged losses
   and the final mapper). Expected bitwise (the average divides by 1, the
   draws are the same); the fp32 GAN pair, on cuDNN's atomic sums, runs a
   second time without the group, whose spread must be there and bound the
   group's (``DP_SPREAD``), with the weights within 5·lr. The same K1/K2/K3 launches with and without the group
   (nothing gives way to a plain version), and none in fp32 in the bf16
   run. Per path: ms per iteration with and without the group, the NCCL
   kernels' device ms and launches per iteration, the device events the
   group adds. With more than one card, also ``train_stylegan --dp
   count`` against ``--dp 0`` (weights within 5·lr, ``pl_mean`` 1e-6).
19. validate, export_weights — ``cli/validate.main`` on random full-size
   reference-layout files written with the port's modules (g_ema at 1024,
   phase 7a's e4e, IR-SE50, VGG16, CLIP ViT-B/32, both cluster mappers):
   ``ok`` on the card with the CPU-plain oracle, each gate's value, K1/K3
   launches per validator; then ``cli/export_weights.main
   --with_latent_avg 4096`` on phase 8's trainer saved by
   ``train/checkpoints.py::save_checkpoint``: the export loads strictly into
   the port's Generator and Discriminator and its g_ema synthesises the
   checkpoint's image bitwise; stages timed by ``utils/profiling.StageTimer``.
20. sp_tp — the 1024² synthesis at batch 1 with the capture taps and the
   layer-13 blend, banded over n = 2 and 4 in-process
   (``parallel/sp.py``) and TP-split over n = 2 and 4 (``parallel/tp.py``),
   with the counters at 0: against the whole synthesis, both under
   ``cudnn.deterministic`` (bitwise, else 1e-5 of max |whole|), K1/K3
   launches as the architecture gives them, ms beside the whole (on
   cuDNN's default algorithms); each
   banded op alone against the whole op's rows, and K1 on a Cout slice
   (which ops are bitwise, K1's split-K counts); TP with SP raises; one
   ``EditSession`` edit through a banded generator; the NCCL form with
   more than one card.
21. the ``kernels`` summary line (K1, K2, K3, K5 and their bf16 forms), then
   the last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import glob
import importlib.util
import io
import json
import math
import os
import random
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from collections import defaultdict
from http.server import ThreadingHTTPServer

import numpy as np
import torch
import torch.nn.functional as F

from where2edit_tpu_torch.cli import edit as edit_cli
from where2edit_tpu_torch.cli import evaluate, mapper_inference, mapper_train
from where2edit_tpu_torch.cli import run_attention, run_clustering, train_stylegan
from where2edit_tpu_torch.cli import export_weights, validate
from where2edit_tpu_torch.cli.common import (
    build_generator,
    load_cluster_centers,
    mean_latent,
)
from where2edit_tpu_torch.cli.run_clustering import collect_features
from where2edit_tpu_torch.demo import server as demo_server
from where2edit_tpu_torch.demo.api import EditSession
from where2edit_tpu_torch.demo.app import build_argparser as app_argparser
from where2edit_tpu_torch.demo.app import (
    build_models,
    build_session,
    load_psp,
    load_session,
)
from where2edit_tpu_torch.demo.gallery import CelebGallery
from where2edit_tpu_torch.editing.attention_mappers import (
    FullSpaceMapperFEATClusterLin,
    FullSpaceMapperFEATClusterLinStyle,
    FullSpaceMapperFEATLin,
    FullSpaceMapperFEATLinStyle,
    attention_tables,
    tap_controls,
    tap_resolution,
)
from where2edit_tpu_torch.editing.clustering import _lloyd, kmeans_fit
from where2edit_tpu_torch.editing.latent_mappers import stylespace_count
from where2edit_tpu_torch.editing.styleclip_mapper import build_mapper
from where2edit_tpu_torch.eval.metrics import EditEvaluator
from where2edit_tpu_torch.kernels import common
from where2edit_tpu_torch.kernels import conv3x3 as k2
from where2edit_tpu_torch.kernels import modconv1x1 as k3
from where2edit_tpu_torch.kernels import modconv3x3 as k1
from where2edit_tpu_torch.kernels import upconv as k4
from where2edit_tpu_torch.kernels import upfirdn2d as k5
from where2edit_tpu_torch.losses.clip_loss import CLIPLoss
from where2edit_tpu_torch.losses.id_loss import IDLoss
from where2edit_tpu_torch.losses.perceptual import PerceptualLoss
from where2edit_tpu_torch.models.clip_model import CLIP
from where2edit_tpu_torch.models.clip_tokenizer import tokenize
from where2edit_tpu_torch.models.encoders import Encoder4Editing
from where2edit_tpu_torch.models.inception import InceptionV3
from where2edit_tpu_torch.models.irse import Backbone
from where2edit_tpu_torch.models.psp import PSp, get_keys
from where2edit_tpu_torch.models.stylegan2 import Discriminator, Generator, channel_table
from where2edit_tpu_torch.models.vgg import Vgg16
from where2edit_tpu_torch.nn.layers import EqualLinear, ModulatedConv2d, StyledConv
from where2edit_tpu_torch.ops.interpolate import adaptive_avg_pool
from where2edit_tpu_torch.ops.upfirdn2d import make_kernel, upfirdn2d, upfirdn2d_plain
from where2edit_tpu_torch.parallel import dist
from where2edit_tpu_torch.parallel.sp import InProcess, SpatialGroup, banded
from where2edit_tpu_torch.parallel.tp import shard_generator_params
from where2edit_tpu_torch.train.attention_trainer import (
    AttentionTrainConfig,
    AttentionTrainer,
    Draws,
    is_attention_param,
)
from where2edit_tpu_torch.train.coach import Coach, CoachConfig
from where2edit_tpu_torch.train.corpus import ATTENTION_PROMPTS, IOU_PROMPTS
from where2edit_tpu_torch.train.gan_trainer import Draws as GANDraws
from where2edit_tpu_torch.train.gan_trainer import GANTrainConfig, GANTrainer
from where2edit_tpu_torch.train.checkpoints import save_checkpoint
from where2edit_tpu_torch.train.ranger import Ranger
from where2edit_tpu_torch.utils.logging import read_scalars
from where2edit_tpu_torch.utils.profiling import StageTimer

# the seeded InceptionV3 and ArcFace state dicts the CPU tests draw too
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
from torch_parity import arcface_state, inception_state  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, fp32 outside tensor cores
# fp32-accurate products on the tensor cores: three TF32 products each, at
# the data sheet's dense TF32 rate of 495 TFLOP/s
TC_3XTF32_FLOP_PER_S = 495e12 / 3
TC_BF16_FLOP_PER_S = 989e12  # H100 SXM data sheet, dense bf16 tensor cores
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
# The bf16 forms (phases 3b-17d). A kernel against its plain twin, max |Δ| /
# max |twin|: both round the same bf16 operands and sum in fp32, in another
# order, then round once, so a value near a rounding boundary may land one
# bf16 step apart: 2^-7 of the largest value, under 8e-3. The bf16 input
# gradient against autograd through the twins, relative L2: the backward's
# dz is bf16 on both sides, rounded from sums taken in another order. Card
# against CPU at 64² in bf16: each side rounds activations to bf16 at every
# layer (cuDNN and the CPU's convs in other orders), so a loss moves by
# ~1e-3 and the gradient, through a second rounding in the backward, by
# ~1e-2.
BF16_KERNEL_REL_TOL = 8e-3
# K4 against its plain twin: 3xTF32 keeps fp32 accuracy; sums over at most
# 4·512 K positions in another order, each stage's tensor-core sum
# (truncating) added in fp32 (tests/test_torch_cuda_kernels.py)
K4_REL_TOL = 2e-6
BF16_BACKWARD_REL_L2 = 1e-2
BF16_LOSS_REL_TOL = 1e-2
BF16_MODEL_GRAD_TOL = 5e-2
BF16_IMAGE_REL_TOL = 1e-2

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
    for name in ("modconv3x3", "conv3x3", "modconv1x1", "upconv"):  # K1-K4 run wgmma
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
# phase 3b: the bf16 forms against their plain twins at the main path's shapes
# ---------------------------------------------------------------------------

BF16_NAMES = {"modconv3x3": "modconv3x3_bf16", "conv3x3": "conv3x3_bf16",
              "modconv1x1": "modconv1x1_bf16"}


def counts_bf16() -> tuple:
    return k1.launches_bf16, k2.launches_bf16, k3.launches_bf16


def phase_kernels_bf16() -> dict:
    """K1-bf16 at the generator's 9 shapes at batch 1 (validate's g_ema), 2
    (the StyleCLIP coach), 4 and 8 (the GAN and attention trainers), K2-bf16
    at the discriminator's 9 shapes at batch 1, 2, 4 (17b's D chunks) and 8
    (final_conv's 513 inputs included), K3-bf16 at the 28 edit-path 1x1
    shapes at batch 1 with fp32 and with bf16 output, then at the shapes the
    bf16 trainers launch it: the 9 ToRGBs at batch 8 and 2 with fp32 output,
    and the attention trainer's mapper convs (``TRAIN_ATTENTION_LAYER``, bar
    ``attention_first``, whose input is the generator's fp32 constant and
    takes the fp32 form) at batch 8 with bf16 output, then at its core's
    tile edges (P = 16 and 64, a mapper conv and a ToRGB, batch 1 and 8,
    both outputs): the kernel against its
    plain twin (``BF16_KERNEL_REL_TOL``), K1 prepared against per call
    (bitwise), the kernel's, the twin's and the library call's ms (cuDNN
    ``F.conv2d`` in bf16, channels last, then the epilogue in bf16; for K3
    the einsum in bf16), the device ms from a CUDA graph and the bf16 bound
    (2 bytes per bf16 activation and weight, 4 per fp32 operand; operations
    at the bf16 tensor cores' 989 TFLOP/s for all three kernels; K3-bf16's
    ToRGBs sum on the FMA units but are bound by their bytes). A device
    time under ``BOUND_FLOOR`` of its bound fails. Returns the totals over
    the shapes the bf16 trainers (phases 17a-17c) launch: K1 and K2 at batch
    8, K3 at its trainer shapes above."""
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(10)
    bf = torch.bfloat16
    summed = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
              "bound_ms")
    totals = {k: {**dict.fromkeys(summed, 0.0), "bytes_s": 0.0, "ops_s": 0.0,
                  "max_abs_err": 0.0, "max_rel_err": 0.0}
              for k in BF16_NAMES.values()}

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def timed(rec, kernel, plain, library, budget=60.0):
        rec.update(ms=time_ms(kernel, budget), device_ms=graph_ms(kernel, 10),
                   plain_ms=time_ms(plain, budget), library_ms=time_ms(library, budget),
                   library_device_ms=graph_ms(library, 10))

    def add(name, rec, in_total):
        emit({"phase": "kernels_bf16", "kernel": name, **rec})
        check(rec["max_rel_err"] <= BF16_KERNEL_REL_TOL,
              f"{name} {rec['shape']}: rel {rec['max_rel_err']}")
        for key in ("device_ms", "prepared_device_ms"):
            check(key not in rec or rec[key] >= BOUND_FLOOR * rec["bound_ms"],
                  f"{name} {rec['shape']}: {key} {rec.get(key)} ms under "
                  f"{BOUND_FLOOR} of its bound {rec['bound_ms']} ms")
        if not in_total:
            return
        tot = totals[name]
        for key in summed:
            tot[key] += rec[key]
        tot["bytes_s" if rec["bound_by"] == "bytes" else "ops_s"] += rec["bound_ms"]
        tot["max_abs_err"] = max(tot["max_abs_err"], rec["max_abs_err"])
        tot["max_rel_err"] = max(tot["max_rel_err"], rec["max_rel_err"])

    sqrt2 = math.sqrt(2.0)
    for batch in (1, 2, 4, 8):
        for res, cin, cout in k1_shapes():
            x = randn(batch, res, res, cin).to(bf)
            s, w = randn(batch, cin), randn(3, 3, cin, cout)
            scale = 1.0 / math.sqrt(cin * 9)
            demod = torch.rsqrt(s.square() @ (scale * w).square().sum((0, 1)) + 1e-8)
            style = (scale * s).contiguous()
            noise, nw, bias = randn(batch, res, res), randn(1), randn(cout)
            args = (x, style, w, demod, noise, nw, bias, True)
            got = k1.modconv3x3(*args)
            want = k1.modconv3x3_plain(*args)
            wp = k1.prepare_weight(w, dtype=bf)
            got_prepared = k1.modconv3x3(*args, prepared=wp)
            torch.cuda.synchronize()
            check(got.dtype == bf, "K1-bf16 stores bf16")
            check(torch.equal(got_prepared, got),
                  f"modconv3x3_bf16 {res}² batch {batch}: prepared weights change the result")
            abs_err, rel = rel_err(got.float(), want.float())
            x_lib, s_lib = x.permute(0, 3, 1, 2), style.to(bf)[:, :, None, None]
            w_lib = w.permute(3, 2, 0, 1).to(bf).contiguous(memory_format=torch.channels_last)
            d_lib, b_lib = demod.to(bf)[:, :, None, None], bias.to(bf)[None, :, None, None]
            n_lib = (nw * noise).to(bf)[:, None]

            def library():
                y = F.conv2d(x_lib * s_lib, w_lib, padding=1)
                y = y * d_lib + n_lib + b_lib
                return F.leaky_relu_(y, 0.2).mul_(sqrt2)

            rec = {"shape": f"{res}x{res} {cin}->{cout} batch {batch}",
                   "max_abs_err": abs_err, "max_rel_err": rel}
            timed(rec, lambda: k1.modconv3x3(*args), lambda: k1.modconv3x3_plain(*args),
                  library)
            rec["prepared_device_ms"] = graph_ms(lambda: k1.modconv3x3(*args, prepared=wp), 10)
            nbytes = (2 * (x.numel() + w.numel() + got.numel())
                      + 4 * (style.numel() + demod.numel() + noise.numel() + 1 + bias.numel()))
            rec["bound_ms"], rec["bound_by"] = bound(
                nbytes, 2 * batch * res * res * cin * cout * 9, TC_BF16_FLOP_PER_S)
            add("modconv3x3_bf16", rec, batch == 8)
            del x, w, wp, got, got_prepared, want, x_lib, w_lib

    for batch, res, cin, cout in [(b, *shape) for b in (1, 2, 4, 8) for shape in k2_shapes()]:
        x, w, bias = randn(batch, res, res, cin).to(bf), randn(3, 3, cin, cout), randn(cout)
        scale = 1.0 / math.sqrt(cin * 9)
        args = (x, w, scale, bias, True)
        got = k2.conv3x3(*args)
        want = k2.conv3x3_plain(*args)
        torch.cuda.synchronize()
        check(got.dtype == bf, "K2-bf16 stores bf16")
        abs_err, rel = rel_err(got.float(), want.float())
        x_lib = x.permute(0, 3, 1, 2)
        w_lib = (w.permute(3, 2, 0, 1) * scale).to(bf).contiguous(
            memory_format=torch.channels_last)
        b_lib = bias.to(bf)

        def library():
            y = F.conv2d(x_lib, w_lib, b_lib, padding=1)
            return F.leaky_relu_(y, 0.2).mul_(sqrt2)

        rec = {"shape": f"{res}x{res} {cin}->{cout} batch {batch}",
               "max_abs_err": abs_err, "max_rel_err": rel}
        timed(rec, lambda: k2.conv3x3(*args), lambda: k2.conv3x3_plain(*args), library)
        nbytes = 2 * (x.numel() + w.numel() + got.numel()) + 4 * bias.numel()
        rec["bound_ms"], rec["bound_by"] = bound(
            nbytes, 2 * batch * res * res * cin * cout * 9, TC_BF16_FLOP_PER_S)
        add("conv3x3_bf16", rec, batch == 8)
        del x, w, got, want, x_lib, w_lib

    def k3_shape(name, res, cin, cout, styled, has_res, batch, out_dtype, in_total):
        p = res * res
        x, s, w = randn(batch, p, cin).to(bf), randn(batch, cin), randn(cin, cout)
        scale = 1.0 / math.sqrt(cin)
        style = (scale * s).contiguous()
        demod = (torch.rsqrt(s.square() @ (scale * w).square() + 1e-8) if styled else None)
        noise, nw = (randn(1, p), randn(1)) if styled else (None, None)
        bias = randn(cout)
        residual = randn(batch, p, cout).to(out_dtype) if has_res else None
        args = (x, style, w, demod, noise, nw, bias, styled, residual)
        got = k3.modconv1x1(*args, out_dtype=out_dtype)
        want = k3.modconv1x1_plain(*args, out_dtype=out_dtype)
        torch.cuda.synchronize()
        check(got.dtype == out_dtype, f"K3-bf16 stores {out_dtype}")
        abs_err, rel = rel_err(got.float(), want.float())
        w_lib = (style[:, :, None] * w * (demod[:, None, :] if styled else 1.0)).to(bf)
        b_lib = bias.to(bf)

        def library():
            y = torch.einsum("bpi,bio->bpo", x, w_lib)
            if styled:
                y = y + (nw * noise[:, :, None]).to(bf) + b_lib
                y = F.leaky_relu_(y, 0.2).mul_(sqrt2)
            else:
                y = y + b_lib
            y = y.to(out_dtype)
            return y if residual is None else y.add_(residual)

        rec = {"shape": f"{name} {res}x{res} {cin}->{cout} batch {batch} "
                        f"out {str(out_dtype).split('.')[-1]}",
               "max_abs_err": abs_err, "max_rel_err": rel}
        timed(rec, lambda: k3.modconv1x1(*args, out_dtype=out_dtype),
              lambda: k3.modconv1x1_plain(*args, out_dtype=out_dtype), library, 30.0)
        out_bytes = got.element_size() * (got.numel() + (residual.numel() if has_res else 0))
        nbytes = 2 * x.numel() + out_bytes + 4 * sum(
            t.numel() for t in (style, w, demod, noise, nw, bias) if t is not None)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 2 * batch * p * cin * cout,
                                                 TC_BF16_FLOP_PER_S)
        add("modconv1x1_bf16", rec, in_total)

    for shape in k3_shapes():  # the edit path's shapes, both outputs
        for out_dtype in (torch.float32, bf):
            k3_shape(*shape, 1, out_dtype, False)
    for batch in (8, STYLECLIP_BATCH):  # the trainers' ToRGBs, fp32 out
        for shape in k3_shapes()[:9]:
            k3_shape(*shape, batch, torch.float32, True)
    for shape in mapper_conv_shapes(TRAIN_ATTENTION_LAYER)[1:]:  # 17c's mapper
        k3_shape(*shape, True, False, ATTENTION_BATCH, bf, True)
    # the core's tile edges (after the trainer shapes, so that their inputs
    # stay those of earlier runs): P = 16 (under its 64-pixel tile, TMA's
    # zero rows) and P = 64 (one whole tile), a mapper conv and a ToRGB
    for res in (4, 8):
        for batch in (1, 8):
            for out_dtype in (torch.float32, bf):
                k3_shape(f"tile_edge_{res * res}", res, 512, 32, True, False, batch,
                         out_dtype, False)
                k3_shape(f"tile_edge_{res * res}", res, 512, 3, False, True, batch,
                         out_dtype, False)
    return totals


def phase_backward_bf16() -> dict:
    """4b: K1-bf16 and K2-bf16 at the 1024² trainer's shapes, batch 8:
    every input gradient of the Function (the input gradient the bf16
    kernel, the rest plain in fp32) against autograd through the plain
    twins, relative L2 <= ``BF16_BACKWARD_REL_L2``; without the activation
    (phase 4 says why). Returns {kernel: worst relative L2}."""
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(11)
    bf = torch.bfloat16
    batch = 8
    worst = {"modconv3x3_bf16": 0.0, "conv3x3_bf16": 0.0}

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def compare(name, shape, kernel_fn, plain_fn, inputs, dy):
        before = counts_bf16()
        got = _grads(kernel_fn, inputs, dy)
        launched = tuple(a - b for a, b in zip(counts_bf16(), before))
        want = _grads(plain_fn, inputs, dy)
        torch.cuda.synchronize()
        errs = {k: float((got[k].float() - want[k].float()).norm()
                         / max(float(want[k].float().norm()), 1e-30)) for k in got}
        worst[name] = max(worst[name], *errs.values())
        emit({"phase": "backward_bf16", "kernel": name, "shape": shape,
              "bf16_launches": launched, "rel_l2": errs, "tol": BF16_BACKWARD_REL_L2,
              "dtypes": {k: str(v.dtype) for k, v in got.items()}})
        check(got["x"].dtype == bf, f"{name} {shape}: dx is {got['x'].dtype}")
        bad = {k: e for k, e in errs.items() if not e <= BF16_BACKWARD_REL_L2}
        check(not bad, f"{name} backward {shape}: {bad}")
        return launched

    for res, cin, cout in k1_shapes():
        scale = 1.0 / math.sqrt(cin * 9)
        inputs = {"x": randn(batch, res, res, cin).to(bf), "style": scale * randn(batch, cin),
                  "w": randn(3, 3, cin, cout), "demod": randn(batch, cout).abs() + 0.5,
                  "noise": randn(batch, res, res), "noise_weight": randn(1),
                  "bias": randn(cout), "act": False}
        launched = compare("modconv3x3_bf16", f"{res}x{res} {cin}->{cout}", k1.modconv3x3,
                           k1.modconv3x3_plain, inputs,
                           randn(batch, res, res, cout).to(bf))
        check(launched == (2, 0, 0), f"K1-bf16 {res}²: bf16 launches {launched}")
        del inputs
    for res, cin, cout in k2_shapes():
        inputs = {"x": randn(batch, res, res, cin).to(bf), "w": randn(3, 3, cin, cout),
                  "scale": 1.0 / math.sqrt(cin * 9), "bias": randn(cout), "act": False}
        launched = compare("conv3x3_bf16", f"{res}x{res} {cin}->{cout}", k2.conv3x3,
                           k2.conv3x3_plain, inputs,
                           randn(batch, res, res, cout).to(bf))
        check(launched == (0, 2, 0), f"K2-bf16 {res}²: bf16 launches {launched}")
        del inputs
    return worst


# ---------------------------------------------------------------------------
# phase 3c: K5 (upfirdn2d) at every call site of the 1024² models
# ---------------------------------------------------------------------------

def k5_shapes(skip: bool = True) -> list:
    """(name, x shape, up, down, pad, FIR) of every upfirdn2d call of the
    1024² generator and discriminator at batch 8: the up-conv's blur at each
    output size and Cout, the ToRGB skip's Upsample (3 channels; ``skip``),
    the discriminator's blur before each ResBlock's 3x3 and 1x1 stride-2
    convs."""
    ch, blur = channel_table(2), make_kernel([1, 3, 3, 1])
    shapes = [(f"g_blur_{r}", (8, r + 1, r + 1, ch[r]), 1, 1, (1, 1), blur * 4)
              for r in (8, 16, 32, 64, 128, 256, 512, 1024)]
    if skip:
        shapes += [(f"skip_{2 * r}", (8, r, r, 3), 2, 1, (2, 1), blur * 4)
                   for r in (4, 8, 16, 32, 64, 128, 256, 512)]
    for r in (1024, 512, 256, 128, 64, 32, 16, 8):
        shapes += [(f"d_blur_conv_{r}", (8, r, r, ch[r]), 1, 1, (2, 2), blur),
                   (f"d_blur_skip_{r}", (8, r, r, ch[r]), 1, 1, (1, 1), blur)]
    return shapes


def phase_kernels_k5() -> dict:
    """3c: K5 against its plain version (the stuffed, padded input through
    cuDNN's depthwise conv; in bf16 the plain version on the upcast input,
    rounded once) at ``k5_shapes`` in fp32 and, bar the fp32 skip, in bf16:
    max |Δ| / max |plain| (``KERNEL_REL_TOL``, ``BF16_KERNEL_REL_TOL``), two
    calls bitwise, one launch a call, the kernel's plan (form, rows a
    thread, grid); ms, device ms (CUDA graph), the plain version's ms and,
    as ``library_ms``, cuDNN's depthwise conv alone on the prepared input
    (what the port ran before K5; timed only, never called by the port);
    the bound, bytes (x read once, the output written once) or operations
    (the taps that land on real samples, at the fp32 FMA rate), and the
    device time's share of it (``bound_share``). A device time under
    ``BOUND_FLOOR`` of its bound fails. Returns the totals per form over
    every shape."""
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(12)
    summed = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms")
    totals = {k: {**dict.fromkeys(summed, 0.0), "bytes_s": 0.0, "ops_s": 0.0,
                  "max_abs_err": 0.0, "max_rel_err": 0.0}
              for k in ("upfirdn2d", "upfirdn2d_bf16")}
    for dtype in (torch.float32, torch.bfloat16):
        bf = dtype == torch.bfloat16
        name = "upfirdn2d_bf16" if bf else "upfirdn2d"
        for site, shape, up, down, pad, fir in k5_shapes(skip=not bf):
            x = torch.randn(*shape, generator=g, device=dev).to(dtype)
            pads = (*pad, *pad)

            def kernel():
                return upfirdn2d(x, fir, up=up, down=down, pad=pad)

            def plain():
                return upfirdn2d_plain(x.float() if bf else x, fir, up, down, pads).to(dtype)

            n5 = k5.launches
            got, again = kernel(), kernel()
            torch.cuda.synchronize()
            check(k5.launches == n5 + 2, f"{name} {site}: launches {k5.launches - n5}")
            check(torch.equal(got, again), f"{name} {site}: two calls differ")
            abs_err, rel = rel_err(got.float(), plain().float())
            check(rel <= (BF16_KERNEL_REL_TOL if bf else KERNEL_REL_TOL),
                  f"{name} {site}: rel {rel}")
            # library yardstick: cuDNN's depthwise conv on the stuffed, padded
            # input (channels last), the call the port made before K5
            xs = x.permute(0, 3, 1, 2)
            if up > 1:
                stuffed = xs.new_zeros((shape[0], shape[3], shape[1] * up, shape[2] * up))
                stuffed[:, :, ::up, ::up] = xs
                xs = stuffed
            xs = F.pad(xs, [pad[0], pad[1], pad[0], pad[1]]).contiguous(
                memory_format=torch.channels_last)
            w = torch.flip(torch.as_tensor(fir, dtype=dtype, device=dev), (0, 1))
            w = w[None, None].expand(shape[3], 1, *fir.shape).contiguous(
                memory_format=torch.channels_last)

            def library():
                return F.conv2d(xs, w, stride=down, groups=shape[3])

            rec = {"shape": f"{site} {'x'.join(map(str, shape))}", "up": up, "down": down,
                   "pad": pad, "max_abs_err": abs_err, "max_rel_err": rel,
                   "plan": k5.plan(x, got.shape[1], got.shape[2], up, down, *fir.shape),
                   "ms": time_ms(kernel, 60.0), "device_ms": graph_ms(kernel, 10),
                   "plain_ms": time_ms(plain, 60.0), "library_ms": time_ms(library, 60.0),
                   "library_device_ms": graph_ms(library, 10)}
            taps = -(-fir.shape[0] // up) * -(-fir.shape[1] // up)
            rec["bound_ms"], rec["bound_by"] = bound(
                x.element_size() * (x.numel() + got.numel()), 2 * taps * got.numel())
            rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
            emit({"phase": "kernels_bf16" if bf else "kernels", "kernel": name, **rec})
            check(rec["device_ms"] >= BOUND_FLOOR * rec["bound_ms"],
                  f"{name} {site}: device_ms {rec['device_ms']} under {BOUND_FLOOR} of "
                  f"its bound {rec['bound_ms']}")
            tot = totals[name]
            for key in summed:
                tot[key] += rec[key]
            tot["bytes_s" if rec["bound_by"] == "bytes" else "ops_s"] += rec["bound_ms"]
            tot["max_abs_err"] = max(tot["max_abs_err"], abs_err)
            tot["max_rel_err"] = max(tot["max_rel_err"], rel)
            del x, got, again, xs, w
    return totals


def k4_shapes(batch: int = 8) -> list:
    """(name, b, h, cin, cout) of the 1024² generator's eight up-convs: the
    input at r/2, config-f's channels at r/2 in and at r out."""
    ch = channel_table(2)
    return [(f"up_{r}", batch, r // 2, ch[r // 2], ch[r])
            for r in (8, 16, 32, 64, 128, 256, 512, 1024)]


def phase_kernels_k4() -> dict:
    """3d: K4 against its plain twin at ``k4_shapes``: max |Δ| / max |twin|
    (``K4_REL_TOL``), two calls bitwise, one launch a call, the plan; ms,
    device ms (CUDA graph), the twin's ms and, as ``library_ms``, cuDNN's
    ``conv_transpose2d`` on the modulated input plus the demod multiply
    (timed only, never called by the port); the bound at the 3xTF32 rate
    (bytes beside it: x, the style, the weights, demod and the output once)
    and ``bound_share``. A device time under ``BOUND_FLOOR`` of its bound
    fails. Returns the totals over the eight shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(14)
    summed = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms")
    tot = {**dict.fromkeys(summed, 0.0), "bytes_s": 0.0, "ops_s": 0.0,
           "max_abs_err": 0.0, "max_rel_err": 0.0, "launches_per_call": 1}
    for site, b, h, cin, cout in k4_shapes():
        x, style = torch.randn(b, h, h, cin, generator=g, device=dev), torch.randn(
            b, cin, generator=g, device=dev)
        w = torch.randn(cout, cin, 3, 3, generator=g, device=dev)
        demod = torch.rand(b, cout, generator=g, device=dev) + 0.5
        wp = k4.prepare_weight(w)

        def kernel():
            return k4.modupconv3x3(x, style, w, demod, prepared=wp)

        def plain():
            return k4.upconv_plain(x, style, w, demod)

        xm = (x * style[:, None, None, :]).permute(0, 3, 1, 2)
        wt = w.transpose(0, 1)

        def library():
            y = F.conv_transpose2d(xm, wt, stride=2)
            return y * demod[:, :, None, None]

        n4 = k4.launches
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        check(k4.launches == n4 + 2, f"upconv {site}: launches {k4.launches - n4}")
        check(torch.equal(got, again), f"upconv {site}: two calls differ")
        abs_err, rel = rel_err(got, plain())
        check(rel <= K4_REL_TOL, f"upconv {site}: rel {rel}")
        rec = {"shape": f"{site} {b}x{h}x{h}x{cin}->{cout}", "max_abs_err": abs_err,
               "max_rel_err": rel, "plan": k4.plan(b, h, h, cout),
               "ms": time_ms(kernel, 60.0), "device_ms": graph_ms(kernel, 10),
               "plain_ms": time_ms(plain, 60.0), "library_ms": time_ms(library, 60.0),
               "library_device_ms": graph_ms(library, 10)}
        nbytes = 4 * (x.numel() + style.numel() + w.numel() + demod.numel() + got.numel())
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 2 * 9 * cin * cout * b * h * h,
                                                 TC_3XTF32_FLOP_PER_S)
        rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
        emit({"phase": "kernels", "kernel": "upconv", **rec})
        check(rec["device_ms"] >= BOUND_FLOOR * rec["bound_ms"],
              f"upconv {site}: device_ms {rec['device_ms']} under {BOUND_FLOOR} of its "
              f"bound {rec['bound_ms']}")
        for key in summed:
            tot[key] += rec[key]
        tot["bytes_s" if rec["bound_by"] == "bytes" else "ops_s"] += rec["bound_ms"]
        tot["max_abs_err"] = max(tot["max_abs_err"], abs_err)
        tot["max_rel_err"] = max(tot["max_rel_err"], rel)
        del x, got, again, xm, w, wp
    tot["bound_share"] = tot["bound_ms"] / tot["device_ms"]
    emit({"phase": "kernels", "kernel": "upconv", "shape": "total", **tot})
    return tot


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
# launch counters: each main path's run reads them, set to 0 just before it
# ---------------------------------------------------------------------------

KERNEL_NAMES = ("modconv3x3", "conv3x3", "modconv1x1")
COUNTERS = {"modconv3x3": k1, "conv3x3": k2, "modconv1x1": k3, "upfirdn2d": k5,
            "upconv": k4}


def zero_counters() -> None:
    for k in COUNTERS.values():
        k.launches = 0
        if hasattr(k, "launches_bf16"):  # K4 has no bf16 form
            k.launches_bf16 = 0


def launch_forms() -> dict:
    """{kernel: {"bf16": launches, "fp32": launches}} since the counters
    were set to 0."""
    forms = {}
    for name, k in COUNTERS.items():
        bf = getattr(k, "launches_bf16", 0)
        forms[name] = {"bf16": bf, "fp32": k.launches - bf}
    return forms


def launch_totals(forms: dict) -> dict:
    """{kernel: fp32 + bf16 launches} of a ``launch_forms()`` record."""
    return {k: v["fp32"] + v["bf16"] for k, v in forms.items()}


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


# the device of the phases after 5 that build their own models ("cpu"
# rehearses them at a small SIZE)
DEV = "cuda"


def sync() -> None:
    if DEV == "cuda":
        torch.cuda.synchronize()


def fenced_stages(session, toks, att, reps: int = 10, captures: int = 5) -> dict:
    """p50 ms of each stage of ``reps`` edits and of ``captures`` captures,
    each fenced by ``torch.cuda.synchronize``."""
    stages = defaultdict(list)

    @contextlib.contextmanager
    def fenced(stage):
        sync()
        t0 = time.perf_counter()
        yield
        sync()
        stages[stage].append((time.perf_counter() - t0) * 1e3)

    for _ in range(reps):
        staged_edit(session, toks, att, fenced)
    for _ in range(captures):
        with fenced("capture"):
            session.load_synthetic(7)
    return {k: statistics.median(v) for k, v in stages.items()}


def edit_latency(session, toks, att, n: int = 12) -> list:
    lat = []
    for _ in range(n):
        sync()
        t0 = time.perf_counter()
        session.edit(toks, att)
        sync()
        lat.append((time.perf_counter() - t0) * 1e3)
    return lat


def phase_slice() -> tuple:
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
    zero_counters()
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
    launches = launch_totals(launch_forms())
    emit({"phase": "slice", "step": "main_path", "edits": len(PROMPTS),
          "sweeps": 1, "stored_taps": n_taps, "launches": launches,
          "per_capture": per_capture, "per_edit": per_edit,
          "map_shape": list(amap.shape)})

    # --- latency at batch 1, then the stage split ---
    toks, att = tokenize([PROMPTS[0][0]]), tokenize([PROMPTS[0][1]])
    lat = edit_latency(session, toks, att)
    rec = {"phase": "slice", "step": "latency", "batch": 1, "edits": len(lat),
           "p50_edit_ms": statistics.median(lat), "edit_ms": lat,
           "p50_stage_ms": fenced_stages(session, toks, att),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           # inside that peak: K1's and K4's prepared weights, kept per layer
           "prepared_cache_mib": sum(
               m.prepared_bytes() for m in session.generator.modules()
               if isinstance(m, ModulatedConv2d)) / 2 ** 20}
    emit(rec)
    return launches, session, per_edit, rec["p50_edit_ms"]


# ---------------------------------------------------------------------------
# phase 6: where the time of an edit goes
# ---------------------------------------------------------------------------

# kernel-name substrings -> category, first match wins
CATEGORIES = (
    ("K1 modconv3x3", ("modconv3x3",)),
    ("K2 conv3x3", ("conv3x3_k2",)),  # K2's tag, in both cores' kernel names
    ("K3 modconv1x1", ("modconv1x1",)),
    ("K5 upfirdn2d", ("upfirdn2d",)),
    ("K4 upconv", ("upconv_k4",)),
    ("cuDNN depthwise conv (blurs)", ("conv2d_grouped",)),
    ("cuDNN depthwise input gradients (blur gradients)", ("dgrad2d_c1_k1",)),
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
    summarised by ``profile_summary``."""
    from torch.profiler import ProfilerActivity, profile, record_function  # noqa: PLC0415

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run(record_function)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return profile_summary(prof, wall_us, spans, reps, count_ops)


def profile_summary(prof, wall_us: float, spans: tuple, reps: int,
                    count_ops: tuple = ()) -> dict:
    """Per call of ``reps`` profiled calls that took ``wall_us``: wall and
    device-busy ms, the idle share, kernel launches, device busy inside
    each ``record_function`` span named in ``spans``, device time by kernel
    category and by kernel, and how often each host op or autograd node
    named in ``count_ops`` ran."""
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


def phase_whole() -> tuple:
    """Returns the (CPU, card) sessions at 256²."""
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
    return cpu, gpu


# ---------------------------------------------------------------------------
# phase 7c: the W+ edit (EditSession(work_in_stylespace=False))
# ---------------------------------------------------------------------------

def wplus_mapper(size: int, seed: int = 2) -> FullSpaceMapperFEATClusterLin:
    """The production W+ mapper at attention and cluster layer 13, seeded
    random weights drawn on the CPU, centres carrying position only."""
    rng = torch.Generator().manual_seed(seed)
    mapper = FullSpaceMapperFEATClusterLin(
        layers=2 * int(math.log2(size)) - 2, attention_layer=ATTENTION_LAYER,
        cluster_layer=ATTENTION_LAYER, generator_size=size, rng=rng)
    pos = torch.rand(mapper.clusters, 2, generator=rng) * 2 - 1
    width = mapper.initial_state.shape[1] - 64
    with torch.no_grad():
        mapper.initial_state.zero_()
        mapper.initial_state[:, width:width + 32] = pos[:, :1]
        mapper.initial_state[:, width + 32:] = pos[:, 1:]
    return mapper.eval()


def wplus_session(session, mapper) -> EditSession:
    """A W+ session on ``session``'s generator and text tower."""
    return EditSession(generator=session.generator,
                       mapper=mapper.to(session.device),
                       clip_encode_text=session.clip_encode_text,
                       attention_layer=session.attention_layer,
                       work_in_stylespace=False)


def phase_wplus_edit(session, s_per_edit: tuple, whole: tuple, card: str) -> tuple:
    """The W+ edit at 1024², batch 1: the main path with the counters at 0
    (one capture, three edits, one 2-prompt sweep: K1 as the S-space edit,
    K3 less the S-space mapper's attention convs, no K1 preparation), the
    p50 of 12 edits and the fenced stage split; then card against CPU at
    256² from phase 7's sessions. Returns ({kernel: launches}, p50 ms)."""
    wsess = wplus_session(session, wplus_mapper(SIZE))
    mapper_convs = len(session.mapper.layer_num) + 2
    per_capture = (s_per_edit[0], s_per_edit[0])
    per_edit = (s_per_edit[0], s_per_edit[1] - mapper_convs)

    def expect(before, want, what):
        got = tuple(a - b for a, b in zip(counts(), before))
        check(got == (want[0], 0, want[1]),
              f"{what}: launches (K1, K2, K3) +{got}, expected +({want[0]}, 0, {want[1]})")

    zero_counters()
    # --- the main path ---
    before = counts()
    img = wsess.load_synthetic(7)
    sync()
    check(tuple(img.shape) == (1, SIZE, SIZE, 3) and bool(torch.isfinite(img).all()),
          "W+ captured image")
    check(tuple(wsess.latent.shape) == (1, session.generator.n_latent, 512),
          "the W+ session keeps the W+")
    expect(before, per_capture, "W+ load_synthetic")
    for prompt, att, _, thr in PROMPTS:
        before, prepares = counts(), k1.prepares
        img, amap = wsess.edit(tokenize([prompt]), tokenize([att]),
                               attention_threshold=thr)
        sync()
        check_edit(img, amap, 1)
        check(amap.shape[1] == tap_resolution(ATTENTION_LAYER),
              f"W+ map at the cluster tap's size, {tuple(amap.shape)}")
        expect(before, per_edit, f"W+ edit {prompt!r}")
        check(k1.prepares == prepares, f"W+ edit {prompt!r} prepared K1 weights")
    before = counts()
    img, amap = wsess.edit(tokenize([p[0] for p in PROMPTS[:2]]),
                           tokenize([p[1] for p in PROMPTS[:2]]))
    sync()
    check_edit(img, amap, 2)
    expect(before, per_edit, "W+ 2-prompt sweep")
    launches = launch_totals(launch_forms())
    emit({"phase": "wplus_edit", "step": "main_path", "card": card,
          "mapper": "FullSpaceMapperFEATClusterLin", "edits": len(PROMPTS),
          "sweeps": 1, "launches": launches, "per_capture": per_capture,
          "per_edit": per_edit, "s_space_per_edit": list(s_per_edit),
          "map_shape": list(amap.shape)})

    # --- latency at batch 1, the stage split ---
    toks, att = tokenize([PROMPTS[0][0]]), tokenize([PROMPTS[0][1]])
    lat = edit_latency(wsess, toks, att)
    p50 = statistics.median(lat)
    emit({"phase": "wplus_edit", "step": "latency", "card": card, "batch": 1,
          "edits": len(lat), "p50_edit_ms": p50, "edit_ms": lat,
          "p50_stage_ms": fenced_stages(wsess, toks, att)})
    if DEV == "cuda":
        rec = device_profile(lambda span: staged_edit(wsess, toks, att, span),
                             STAGES, 5)
        emit({"phase": "wplus_edit", "step": "profile", "card": card, "edits": 5,
              **{k: v for k, v in rec.items() if k != "top_kernels"},
              "top_kernels": rec["top_kernels"][:10]})

    # --- card against CPU at 256², phase 7's sessions and W+ ---
    cpu, gpu = (wplus_session(sess, wplus_mapper(256)) for sess in whole)
    wplus = cpu.sample_wplus(7)
    n = counts()
    cpu.load_latent(wplus)
    gpu.load_latent(wplus.to(gpu.device))
    img_c, map_c = cpu.edit(toks, att)
    img_g, map_g = gpu.edit(toks, att)
    sync()
    per_pass = 1 + len(gpu.generator.to_rgbs)
    got = tuple(a - b for a, b in zip(counts(), n))
    check(got == (2 * per_pass, 0, 2 * per_pass),
          f"the card's 256² W+ session ran on the kernels: {got}")
    img_err, img_rel = rel_err(img_g.cpu(), img_c)
    map_err = float((map_g.cpu() - map_c).abs().max())
    emit({"phase": "wplus_edit", "step": "whole", "size": 256,
          "image_max_abs_err": img_err, "image_rel_err": img_rel,
          "map_max_abs_err": map_err, "map_mean": float(map_c.mean()),
          "image_rel_tol": WHOLE_IMAGE_REL_TOL, "map_abs_tol": WHOLE_MAP_ABS_TOL})
    check(img_rel <= WHOLE_IMAGE_REL_TOL, f"256² W+ image card vs CPU: rel {img_rel}")
    check(map_err <= WHOLE_MAP_ABS_TOL, f"256² W+ map card vs CPU: {map_err}")
    return launches, p50


# ---------------------------------------------------------------------------
# phase 7d: the web demo (demo/server.py) over HTTP on localhost
# ---------------------------------------------------------------------------

SERVER_REQUESTS = 8


def _http(url: str, body=None) -> tuple:
    """(status, parsed body) of a GET (``body`` None) or a JSON POST."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            raw, code, ctype = r.read(), r.status, r.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        raw, code, ctype = e.read(), e.code, e.headers["Content-Type"]
    return code, (json.loads(raw) if ctype == "application/json" else raw)


def phase_server(session, card: str, p50s: dict) -> dict:
    """``demo/server.py``'s ``ThreadingHTTPServer`` on 127.0.0.1 (an
    ephemeral port, in a thread) over a fresh S-space session on phase 5's
    1024² models: GET ``/`` and ``/celebs``, the 400s (``/invert`` without
    e4e, an unknown gallery face, ``source=session`` before any face), then
    8 seeded edit requests with the counters at 0 (a capture and an edit
    each) over HTTP when Pillow can encode the JPEGs, else through
    ``edit_request``. Returns {kernel: launches}."""
    srv = EditSession(generator=session.generator, mapper=session.mapper,
                      clip_encode_text=session.clip_encode_text,
                      attention_layer=session.attention_layer)
    gallery = CelebGallery(srv)
    lock = threading.Lock()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), demo_server.make_handler(
        srv, lock, gallery, None))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    route = "http" if importlib.util.find_spec("PIL") else "edit_request"
    try:
        code, page = _http(url + "/")
        check(code == 200 and b"/edit" in page, f"GET /: {code}")
        code, body = _http(url + "/celebs")
        check(code == 200 and body["celebs"] == gallery.names(), f"GET /celebs: {code}")
        errors = {}
        for name, path, req in (
                ("invert_without_e4e", "/invert", {"image": ""}),
                ("unknown_celeb", "/edit", {"celeb": "Nobody", "prompt": "x"}),
                ("session_before_face", "/edit", {"source": "session", "prompt": "x"})):
            code, body = _http(url + path, req)
            check(code == 400 and "error" in body, f"POST {path} {name}: {code} {body}")
            errors[name] = code
        per_pass = 1 + len(session.generator.to_rgbs)
        per_request = (2 * per_pass, 0,
                       2 * per_pass + len(session.mapper.layer_num) + 2)
        zero_counters()
        # --- the main path: 8 edit requests, each a seeded face and a prompt ---
        ms, server_ms = [], []
        for i in range(SERVER_REQUESTS):
            prompt, region = PROMPTS[i % len(PROMPTS)][0], "hair"
            req = {"seed": i, "prompt": prompt, "region": region,
                   "strength": 0.1, "coverage": 0.5}
            before = counts()
            t0 = time.perf_counter()
            if route == "http":
                code, body = _http(url + "/edit", req)
                check(code == 200 and all(body[k] for k in ("original", "edited",
                                                            "attention")),
                      f"POST /edit {i}: {code}")
                server_ms.append(body["ms"])
            else:
                with lock:
                    original, edited, amap, t_ms = demo_server.edit_request(
                        srv, req, gallery)
                check_edit(edited, amap, 1)
                check(tuple(original.shape) == (1, SIZE, SIZE, 3), "request original")
                server_ms.append(t_ms)
            ms.append((time.perf_counter() - t0) * 1e3)
            got = tuple(a - b for a, b in zip(counts(), before))
            check(got == per_request, f"request {i}: launches {got}, "
                                      f"expected {per_request}")
        launches = launch_totals(launch_forms())
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    emit({"phase": "server", "card": card, "route": route, "size": SIZE,
          "requests": SERVER_REQUESTS, "status_400": errors, "launches": launches,
          "per_request": per_request, "request_ms": ms,
          "p50_request_ms": statistics.median(ms),
          "p50_handler_ms": statistics.median(server_ms),
          "p50_edit_ms_phase5": p50s["s_space"], "p50_edit_ms_wplus": p50s["wplus"],
          "note": "a request loads a seeded face (capture) and edits it; "
                  "request_ms is the client's wall time, handler_ms the "
                  "server's (before the JPEG encoding)"})
    return launches


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


def photo_inputs(session, work: str) -> tuple:
    """(the e4e checkpoint of ``e4e_checkpoint(session.generator, SIZE, 2)``,
    its path under ``work``, the seconds to make and save it, 8 of the
    session's seeded 1024² faces face-pooled to the encoder's 256²: they
    stand in for photos)."""
    gen = session.generator
    t0 = time.perf_counter()
    ckpt = e4e_checkpoint(gen, SIZE, seed=2)
    path = os.path.join(work, "e4e.pt")
    torch.save(ckpt, path)
    save_s = time.perf_counter() - t0
    with torch.no_grad():
        faces = gen([session.sample_wplus(11, batch=8)], input_is_latent=True,
                    randomize_noise=False).image
    return ckpt, path, save_s, adaptive_avg_pool(faces, 256).clamp(-1.0, 1.0)


def phase_invert(session, card: str, work: str) -> tuple:
    """Returns ({kernel: launches} of the main path, the card's PSp, its
    checkpoint, the batch-1 input, the 8 256² faces); the checkpoint stays
    in ``work`` for phase 15b."""
    gen = session.generator
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ckpt, path, save_s, x8 = photo_inputs(session, work)
    t0 = time.perf_counter()
    psp = load_psp(app_argparser().parse_args([
        "--e4e_ckpt", path, "--stylegan_size", str(SIZE), "--device", "cuda"]))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in psp.encoder.parameters())
    x1 = x8[:1].contiguous()

    def counts3():
        return k1.launches, k2.launches, k3.launches

    def expect(before, d1, d3, what):
        got = tuple(a - b for a, b in zip(counts3(), before))
        check(got == (d1, 0, d3), f"{what}: launches (K1, K2, K3) +{got}, "
                                  f"expected +({d1}, 0, {d3})")

    per_pass = 1 + len(gen.to_rgbs)
    mapper_convs = len(session.mapper.layer_num) + 2
    toks, att = tokenize([PROMPTS[0][0]]), tokenize([PROMPTS[0][1]])
    zero_counters()
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
    launches = launch_totals(launch_forms())
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
    return launches, psp, ckpt, x1, x8


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
        self.bf16 = []             # (K1, K2, K3) of the bf16 forms, per record
        self.losses = []           # per iteration {name: float}
        self.start = None

    @contextlib.contextmanager
    def __call__(self, program, trainer):
        if self.start is None:
            self.start = {m: [p.detach().clone() for p in getattr(trainer, m).parameters()]
                          for m in ("g", "d")}
        torch.cuda.synchronize()
        before, before_bf16, t0 = counts(), counts_bf16(), time.perf_counter()
        yield
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = counts()
        self.records.append((trainer.global_step, program, ms,
                             tuple(a - b for a, b in zip(after, before))))
        self.bf16.append(tuple(a - b for a, b in zip(counts_bf16(), before_bf16)))
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
    passes}, the trainer, the peak memory in GiB) of the training run."""
    probe = TrainProbe()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    # --- the main path: 5 iterations through the CLI ---
    with tempfile.TemporaryDirectory() as results:
        trainer = train_stylegan.main([*TRAIN_ARGS, "--results_dir", results],
                                      span=probe)
    launches = launch_totals(launch_forms())
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
    return launches, dict(zip(launches, backward)), trainer, peak / 2 ** 30


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
    # every FIR blur and its gradients run on K5: no cuDNN depthwise conv is left
    cats = {c["name"] for c in rec["categories"]}
    check(not cats & {"cuDNN depthwise conv (blurs)",
                      "cuDNN depthwise input gradients (blur gradients)"},
          f"train_profile: cuDNN depthwise kernels in a GAN iteration: {sorted(cats)}")


# ---------------------------------------------------------------------------
# phase 10: one training iteration, card against CPU at 64²
# ---------------------------------------------------------------------------

def phase_train_whole() -> None:
    emit(train_whole())


def train_whole(bf16: bool = False, size: int = 64, channel_multiplier: int = 2) -> dict:
    """One training iteration at ``size``, batch 4, card against CPU, each
    program from the same state; with ``bf16`` the generator and the
    discriminator in bf16 (``--bf16 --d_bf16``) at the bf16 bars, and the
    fake image of the iteration's draws beside them. Returns the record."""
    batch = 4
    cfg = GANTrainConfig(size=size, batch_size=batch, channel_multiplier=channel_multiplier,
                         bf16=bf16, d_bf16=bf16)
    cpu, gpu = GANTrainer(cfg, device="cpu"), GANTrainer(cfg, device=DEV)
    loss_tol, model_tol = ((BF16_LOSS_REL_TOL, BF16_MODEL_GRAD_TOL) if bf16
                           else (TRAIN_LOSS_REL_TOL, TRAIN_MODEL_GRAD_TOL))
    real = torch.from_numpy(np.random.default_rng(0).uniform(
        -1.0, 1.0, (batch, size, size, 3)).astype(np.float32))
    draws = cpu.draw(batch)
    path_draws = cpu.draw(cpu.path_batch())
    pl_noise = torch.randn(cpu.path_batch(), size, size, 3, generator=cpu.rng)

    def to_gpu(d: GANDraws) -> GANDraws:
        return GANDraws(d.z1.to(DEV), d.z2.to(DEV), d.inject.to(DEV),
                        [n.to(DEV) for n in d.noise])

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
           "channel_multiplier": channel_multiplier, "bf16": bf16,
           "loss_rel_tol": loss_tol, "model_grad_tol": model_tol,
           **({} if bf16 else {"param_grad_tol": TRAIN_PARAM_GRAD_TOL})}
    for program, model, run in programs:
        # each program from the same state on both sides
        for m in ("g", "d"):
            getattr(gpu, m).load_state_dict(getattr(cpu, m).state_dict())
        gpu.pl_mean = cpu.pl_mean.to(DEV)
        loss_c, loss_g = float(run(cpu, "cpu")), float(run(gpu, DEV))
        loss_rel = abs(loss_g - loss_c) / max(abs(loss_c), 1e-30)
        diff2 = ref2 = 0.0
        worst, worst_name = 0.0, None
        for (name, pc), pg in zip(getattr(cpu, model).named_parameters(),
                                  getattr(gpu, model).parameters()):
            if pc.grad is None and pg.grad is None:  # not in this loss's graph
                continue
            check(pc.grad is not None and pg.grad is not None,
                  f"{size}² {program} {name}: a gradient on one side only")
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
        check(loss_rel <= loss_tol, f"{size}² {program} loss: rel {loss_rel}")
        check(model_rel <= model_tol, f"{size}² {program} grads: rel {model_rel}")
        if not bf16:  # bf16 roundings make single tensors noisier; the model's bar holds
            check(worst <= TRAIN_PARAM_GRAD_TOL, f"{size}² {program} {worst_name}: rel {worst}")
    want = (0, 0, 0)
    for fwd, bwd in train_launches(int(math.log2(size)) - 2).values():
        want = total(want, total(fwd, bwd))
    got = tuple(a - b for a, b in zip(counts(), n))
    rec["launches"] = got
    check(got == want, f"{size}² card programs launched {got}, expected {want}")
    if bf16:
        gpu.g.load_state_dict(cpu.g.state_dict())
        with torch.no_grad():
            img_c = cpu.synthesize(draws)[0]
            img_g = gpu.synthesize(to_gpu(draws))[0].cpu()
        rec["image_dtype"] = str(img_g.dtype)
        rec["image_rel"] = rel_err(img_g, img_c)[1]
        rec["image_rel_tol"] = BF16_IMAGE_REL_TOL
        check(img_g.dtype == torch.float32, "a bf16 generator returns an fp32 image")
        check(rec["image_rel"] <= BF16_IMAGE_REL_TOL,
              f"{size}² bf16 image: rel {rec['image_rel']}")
    return rec


# ---------------------------------------------------------------------------
# phase 11: k-means regions at full width (cli/run_clustering.py)
# ---------------------------------------------------------------------------

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
    zero_counters()
    # --- the main path: the CLI, with --step 4 (its one cut) ---
    with tempfile.TemporaryDirectory() as results:
        path = run_clustering.main([*cluster_args(), "--results_dir", results],
                                   span=fenced_span(records))
        centers = load_cluster_centers(path)
        kept = shutil.copy(path, keep_dir)
    launches = launch_totals(launch_forms())
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


def phase_attention(card: str, cluster_path: str, keep_dir: str) -> tuple:
    """Returns ({kernel: launches}, {kernel: launches in backward passes},
    the trainer, its final checkpoint copied into ``keep_dir``)."""
    probe = AttentionProbe()
    if DEV == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    zero_counters()
    with tempfile.TemporaryDirectory() as results:
        args = ["--stylegan_size", str(SIZE), "--work_in_stylespace",
                "--use_cluster", "--cluster_path",
                cluster_path, "--batch_size", str(ATTENTION_BATCH), "--step",
                str(ATTENTION_STEPS), "--save_intermediate_image_every", "0",
                "--device", DEV, "--results_dir", results]
        out_dir = run_attention.main(args, span=probe)
        launches = launch_totals(launch_forms())
        peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
        trainer = probe.trainer
        (log_dir,) = glob.glob(os.path.join(results, "logs", "*"))
        losses = [r["value"] for r in read_scalars(log_dir) if r["tag"] == "loss/loss"]
        ckpt_path = os.path.join(out_dir, "final_mapper.pt")
        check(os.path.isfile(ckpt_path), "no final checkpoint")
        kept = shutil.copy(ckpt_path, keep_dir)
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
    return (launches, dict(zip(launches, (n * n_steps for n in backward))), trainer,
            kept)


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


def attention_parts(size: int, device: str, seed: int = 0,
                    wplus: bool = False, dtype=torch.float32) -> tuple:
    """(generator, mapper, CLIP loss, perceptual loss) at ``size`` with
    seeded random weights, full-width CLIP ViT-B/32 and VGG16; the S-space
    production mapper, or with ``wplus`` the W+ one. The mapper's centres
    carry no feature part (only position), so every pixel's region is set
    by geometry alone and the card and the CPU cannot split a near-tie two
    ways."""
    rng = torch.Generator().manual_seed(seed)
    gen = Generator(size, rng=rng, dtype=dtype)
    with torch.no_grad():  # non-zero noise gains, so the noise path counts
        for name, p in gen.named_parameters():
            if name.endswith("noise.weight"):
                p.copy_(0.1 * torch.randn(1, generator=rng))
    cls = FullSpaceMapperFEATClusterLin if wplus else FullSpaceMapperFEATClusterLinStyle
    mapper = cls(layers=gen.n_latent, attention_layer=TRAIN_ATTENTION_LAYER,
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


def attention_whole(wplus: bool = False, bf16: bool = False) -> dict:
    """One training step at 64² on the card and on the CPU from the same
    weights and draws, every mapper gradient unmasked
    (``freeze_attention_until`` 0), in S-space or (``wplus``) in W+: each
    loss term within ``TRAIN_LOSS_REL_TOL``, the mapper's gradient within
    ``TRAIN_MODEL_GRAD_TOL`` (whole model) and ``TRAIN_PARAM_GRAD_TOL`` (per
    tensor); with ``bf16`` a bf16 generator, at the bf16 bars. Returns the
    record."""
    size, batch, step_idx = 64, 4, 60
    dtype = torch.bfloat16 if bf16 else torch.float32
    loss_tol, model_tol = ((BF16_LOSS_REL_TOL, BF16_MODEL_GRAD_TOL) if bf16
                           else (TRAIN_LOSS_REL_TOL, TRAIN_MODEL_GRAD_TOL))
    cfg = AttentionTrainConfig(stylegan_size=size, attention_layer=TRAIN_ATTENTION_LAYER,
                               cluster_layer=CLUSTER_LAYER, batch_size=batch,
                               step=300, work_in_stylespace=not wplus,
                               freeze_attention_until=0.0)
    cpu_parts = attention_parts(size, "cpu", wplus=wplus, dtype=dtype)
    gpu_parts = attention_parts(size, DEV, wplus=wplus, dtype=dtype)
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
    rec = {"size": size, "batch": batch, "step_idx": step_idx,
           "mapper": type(gpu_parts[1]).__name__,
           "losses_cpu": loss_c, "losses_card": loss_g, "loss_rel": loss_rel,
           "model_grad_rel": model_rel, "worst_param_grad_rel": worst,
           "worst_param": worst_name, "card_launches": launches, "bf16": bf16,
           "loss_rel_tol": loss_tol, "model_grad_tol": model_tol,
           **({} if bf16 else {"param_grad_tol": TRAIN_PARAM_GRAD_TOL})}
    what = ("W+ attention" if wplus else "attention") + (" bf16" if bf16 else "")
    bad = {k: v for k, v in loss_rel.items() if not v <= loss_tol}
    check(not bad, f"64² {what} step losses: {bad}")
    check(model_rel <= model_tol, f"64² {what} mapper grads: rel {model_rel}")
    if not bf16:
        check(worst <= TRAIN_PARAM_GRAD_TOL, f"64² {what} mapper {worst_name}: rel {worst}")
    return rec


def phase_attention_whole() -> None:
    emit({"phase": "attention_whole", **attention_whole()})


# ---------------------------------------------------------------------------
# phase 14a: trained mappers loaded through --mapper (demo/app.py)
# ---------------------------------------------------------------------------

def reference_mapper_files(tmp: str) -> tuple:
    """A seeded S-space mapper (attention and cluster layer 13, centres
    carrying position) written as a DDP reference ``.pt`` with dead
    ``mapper_textca_{c}`` entries, and as the same file without
    ``initial_state``. Returns (the mapper, {name: path})."""
    rng = torch.Generator().manual_seed(3)
    mapper = FullSpaceMapperFEATClusterLinStyle(
        layers=2 * int(math.log2(SIZE)) - 2, attention_layer=ATTENTION_LAYER,
        cluster_layer=ATTENTION_LAYER, generator_size=SIZE, rng=rng)
    pos = torch.rand(mapper.clusters, 2, generator=rng) * 2 - 1
    with torch.no_grad():
        mapper.initial_state.zero_()
        mapper.initial_state[:, 512:544] = pos[:, :1]
        mapper.initial_state[:, 544:] = pos[:, 1:]
    ref = {f"module.{k}": v for k, v in mapper.state_dict().items()}
    for c in range(mapper.mapper_layer):
        ref[f"module.mapper_textca_{c}.fc.weight"] = torch.randn(256, 512, generator=rng)
        ref[f"module.mapper_textca_{c}.fc.bias"] = torch.zeros(256)
    paths = {"reference_ddp": os.path.join(tmp, "mapper_ddp.pt"),
             "no_initial_state": os.path.join(tmp, "mapper_no_centres.pt")}
    torch.save(ref, paths["reference_ddp"])
    torch.save({k: v for k, v in ref.items() if not k.endswith("initial_state")},
               paths["no_initial_state"])
    return mapper.eval(), paths


def phase_mapper_load(card: str, final_path: str) -> dict:
    """A reference ``.pt`` (DDP keys and CA_NET entries), the same without
    ``initial_state`` and phase 12's ``final_mapper.pt``, each through
    ``demo/app.py::load_session`` with ``--mapper`` at 1024²: an edit equals,
    bitwise, the edit of a session that holds the same mapper in memory
    (its weights loaded by plain ``load_state_dict``) on the same generator,
    and differs from the random mapper's edit; the file without centres
    loads and its edit refuses, as the JAX mapper without its clusters
    collection does. Counters at 0 before. Returns {kernel: launches}."""
    toks, att = tokenize([PROMPTS[0][0]]), tokenize([PROMPTS[0][1]])
    records = {}
    # cuDNN's transposed conv (its backward-data) may take an algorithm
    # that sums with atomics: two runs of one edit then differ in the last
    # bits. Deterministic algorithms make the bitwise comparison possible.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    zero_counters()
    with tempfile.TemporaryDirectory() as tmp:
        source, paths = reference_mapper_files(tmp)
        final = torch.load(final_path, map_location="cpu", weights_only=True)["mapper"]
        trained = FullSpaceMapperFEATClusterLinStyle(
            layers=source.layers, attention_layer=TRAIN_ATTENTION_LAYER,
            cluster_layer=CLUSTER_LAYER, generator_size=SIZE,
            clusters=final["initial_state"].shape[0],
            cluster_dim=final["initial_state"].shape[1])
        trained.load_state_dict(final)
        files = [("reference_ddp", paths["reference_ddp"], ATTENTION_LAYER, source),
                 ("no_initial_state", paths["no_initial_state"], ATTENTION_LAYER, source),
                 ("final_mapper", final_path, TRAIN_ATTENTION_LAYER, trained.eval())]
        for name, path, layer, held_mapper in files:
            args = app_argparser().parse_args([
                "--stylegan_size", str(SIZE), "--attention_layer", str(layer),
                "--cluster_layer", str(CLUSTER_LAYER), "--mapper", path,
                "--ckpt", "/nonexistent", "--device", DEV])
            t0 = time.perf_counter()
            loaded = load_session(args)
            sync()
            rec = {"attention_layer": layer, "load_s": time.perf_counter() - t0,
                   "file_mib": os.path.getsize(path) / 2 ** 20}

            def edit(sess):
                sess.load_synthetic(7)
                out = sess.edit(toks, att)
                sync()
                return out

            if name == "no_initial_state":
                check(loaded.mapper.initial_state is None, "no centres after the load")
                try:
                    edit(loaded)
                    refused = None
                except RuntimeError as e:
                    refused = str(e)
                check(refused is not None and "no k-means centres" in refused,
                      f"an edit without centres ran or failed otherwise: {refused}")
                rec["edit_refused"] = refused
            else:
                img, amap = edit(loaded)
                check_edit(img, amap, 1)
                again, _ = edit(loaded)
                rec["repeat_bitwise_equal"] = bool(torch.equal(img, again))
                held = EditSession(generator=loaded.generator,
                                   mapper=held_mapper.to(DEV),
                                   clip_encode_text=loaded.clip_encode_text,
                                   attention_layer=layer)
                img_h, map_h = edit(held)
                random_mapper = build_models(SIZE, layer, CLUSTER_LAYER)[1]
                rand = EditSession(generator=loaded.generator,
                                   mapper=random_mapper.to(DEV).eval(),
                                   clip_encode_text=loaded.clip_encode_text,
                                   attention_layer=layer)
                img_r, _ = edit(rand)
                rec["bitwise_equal_to_held"] = bool(torch.equal(img, img_h)
                                                    and torch.equal(amap, map_h))
                rec["image_max_abs_vs_held"] = float((img - img_h).abs().max())
                rec["map_max_abs_vs_held"] = float((amap - map_h).abs().max())
                rec["image_max_abs_vs_random"] = float((img - img_r).abs().max())
                del held, rand, random_mapper
            records[name] = rec
            emit({"phase": "mapper_load", "file": name, **rec})
            if name != "no_initial_state":
                check(rec["bitwise_equal_to_held"],
                      f"{name}: the loaded mapper's edit is not the held one's")
                check(rec["image_max_abs_vs_random"] > 0,
                      f"{name}: the loaded mapper's edit equals the random one's")
            del loaded
            if DEV == "cuda":
                torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = deterministic
    launches = launch_totals(launch_forms())
    emit({"phase": "mapper_load", "card": card, "size": SIZE, "files": records,
          "launches": launches, "cudnn_deterministic": True})
    return launches


# ---------------------------------------------------------------------------
# phase 14b: the W+ mapper family trained through cli/run_attention.py
# ---------------------------------------------------------------------------

WPLUS_STEPS = 4
BRANCH_SIZE, BRANCH_BATCH, BRANCH_STEPS = 256, 2, 2


def run_attention_probed(args: list, steps: int) -> tuple:
    """``run_attention.main(args)`` with an ``AttentionProbe`` (phase 12's
    checks), its launches per stage held to ``attention_launches`` with no
    K3 in the mapper stage (these mappers' convs are plain), and finite
    losses. Returns (probe, losses, {kernel: launches})."""
    probe = AttentionProbe()
    zero_counters()
    with tempfile.TemporaryDirectory() as results:
        run_attention.main([*args, "--save_intermediate_image_every", "0",
                            "--device", DEV, "--results_dir", results], span=probe)
        (log_dir,) = glob.glob(os.path.join(results, "logs", "*"))
        losses = [r["value"] for r in read_scalars(log_dir) if r["tag"] == "loss/loss"]
    launches = launch_totals(launch_forms())
    check(len(losses) == steps and all(map(math.isfinite, losses)), f"losses {losses}")
    expect = attention_launches(probe.trainer.generator.log_size - 2, 0)
    for step, stage, _, got, prep in probe.records:
        check(got == expect[stage], f"step {step} {stage}: launches {got}, "
                                    f"expected {expect[stage]}")
        check(prep == 0, f"step {step} {stage}: {prep} K1 weight preparations")
    return probe, losses, launches


def phase_wplus_train(card: str, cluster_path: str) -> dict:
    """``cli/run_attention.py --use_cluster`` without
    ``--work_in_stylespace`` (the W+ production mapper) on phase 11's pickle
    at 1024², batch 8, 4 steps (step 0 at lr 0): ms per step over steps
    1-3 and its stages, samples/s, peak memory (≤ 80 GB), launches per step
    by stage. Then ``FullSpaceMapperFEATLin`` and
    ``FullSpaceMapperFEATLinStyle`` for 2 steps each at 256², batch 2, and
    one W+ step card against CPU at 64² (phase 14's bars). Returns
    {kernel: launches} of the 1024² run."""
    if DEV == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    probe, losses, launches = run_attention_probed(
        ["--stylegan_size", str(SIZE), "--use_cluster", "--cluster_path", cluster_path,
         "--batch_size", str(ATTENTION_BATCH), "--step", str(WPLUS_STEPS)], WPLUS_STEPS)
    peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    trainer = probe.trainer
    check(isinstance(trainer.mapper, FullSpaceMapperFEATClusterLin)
          and not trainer.cfg.work_in_stylespace, "the W+ cluster mapper trained")
    check(peak <= 80e9, f"peak {peak / 2 ** 30:.2f} GiB")
    unchanged = [n for n, p in trainer.mapper.named_parameters()
                 if is_attention_param(n) and not torch.equal(p, probe.start[n])]
    check(not unchanged, f"frozen attention parameters moved: {unchanged[:5]}")
    stage_ms, step_ms = defaultdict(list), defaultdict(float)
    for step, stage, ms, _, _ in probe.records:
        if step >= 1:
            stage_ms[stage].append(ms)
            step_ms[step] += ms
    per_step = [step_ms[s] for s in sorted(step_ms)]
    expect = attention_launches(trainer.generator.log_size - 2, 0)
    emit({"phase": "wplus_train", "step": "main_path", "card": card, "size": SIZE,
          "batch": ATTENTION_BATCH, "steps": WPLUS_STEPS,
          "mapper": type(trainer.mapper).__name__,
          "attention_layer": trainer.cfg.attention_layer,
          "cluster_layer": trainer.cfg.cluster_layer, "losses": losses,
          "launches": launches,
          "launches_per_step": {k: v for k, v in expect.items() if any(v)},
          "step_ms": per_step, "mean_step_ms": statistics.mean(per_step),
          "stage_ms_mean": {k: statistics.mean(v) for k, v in stage_ms.items()},
          "samples_per_s": ATTENTION_BATCH * len(per_step) / (sum(per_step) / 1e3),
          "peak_mem_gib": peak / 2 ** 30,
          "note": "steps 1-3 (step 0 builds cuDNN plans and caches), each stage "
                  "fenced by torch.cuda.synchronize"})
    del probe, trainer
    branches = {}
    for flags, cls in (((), FullSpaceMapperFEATLin),
                       (("--work_in_stylespace",), FullSpaceMapperFEATLinStyle)):
        t0 = time.perf_counter()
        probe, losses, got = run_attention_probed(
            ["--stylegan_size", str(BRANCH_SIZE), *flags, "--batch_size",
             str(BRANCH_BATCH), "--step", str(BRANCH_STEPS)], BRANCH_STEPS)
        check(type(probe.trainer.mapper) is cls, f"{cls.__name__} trained")
        branches[cls.__name__] = {"flags": list(flags), "losses": losses,
                                  "launches": got,
                                  "wall_s": time.perf_counter() - t0}
    whole = attention_whole(wplus=True)
    emit({"phase": "wplus_train", "step": "branches", "card": card,
          "size": BRANCH_SIZE, "batch": BRANCH_BATCH, "steps": BRANCH_STEPS,
          "branches": branches, "whole_64": whole})
    return launches


# ---------------------------------------------------------------------------
# phases 15a-15d: evaluation (cli/evaluate.py) and FID during training
# ---------------------------------------------------------------------------

EVAL_ITERS, EVAL_BATCH, EVAL_PROFILED = 8, 2, 2
EVAL_STAGES = ("text", "faces", "edit", "clip_image", "arcface", "inception")
IOU_PAIRS = 8
# The extractors card against CPU, max |Δ| / max |CPU|: fp32 both sides
# (cuDNN without TF32), ~90 convs (InceptionV3) or the 50-layer IR-SE
# trunk (ArcFace) summed in another order.
EVAL_REL_TOL = 1e-4
# The edit sweep at 64², card against CPU from the same W+ and token ids:
# the ID cosine within 1e-4 absolute; the InceptionV3 feature pools within
# 1e-3 of their largest magnitude (two syntheses, each at phase 7's 1e-3
# image bar, then a 299² resize and the extractor); the CLIP improvement (a
# count of sign tests) equal.
EVAL_ID_ABS_TOL, EVAL_POOL_REL_TOL = 1e-4, 1e-3
FID_ARGS = ["--fid_every", "2", "--fid_n", "16", "--fid_batch", "8"]


def evaluation_weights(work: str) -> dict:
    """The seeded InceptionV3 (torchvision layout) and ArcFace IR-SE50
    (reference layout) state dicts of ``tests/torch_parity.py``, saved
    under ``work`` once; {name: path}."""
    files = {"inception": os.path.join(work, "inception.pt"),
             "arcface": os.path.join(work, "arcface.pt")}
    for name, make in (("inception", inception_state), ("arcface", arcface_state)):
        if not os.path.exists(files[name]):
            torch.save(make(seed=0), files[name])
    return files


class StageProbe:
    """The ``span`` of ``cli/evaluate.main``: each stage fenced by
    ``torch.cuda.synchronize``, timed, and the launch counters read around
    it; ``first`` names the stage that opens an iteration (an image in iou
    mode). From iteration ``profile_from`` on, the stages run unfenced
    inside ``record_function`` under ``torch.profiler`` (started at that
    iteration's first stage; the wall clock stops, after a synchronize, at
    the end of stage ``last`` of iteration ``iterations - 1``)."""

    def __init__(self, first: str, iterations: int, profile_from=None, last=None):
        self.first, self.iterations = first, iterations
        self.profile_from, self.last = profile_from, last
        self.iteration = -1
        self.records = []          # (iteration, stage, ms, (K1, K2, K3))
        self.prof = None
        self.wall_us = None

    @contextlib.contextmanager
    def __call__(self, stage):
        from torch.profiler import ProfilerActivity, profile, record_function  # noqa: PLC0415

        if stage == self.first:
            self.iteration += 1
            if self.iteration == self.profile_from:
                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.__enter__()
                self.t0 = time.perf_counter()
        if self.prof is not None:
            with record_function(stage):
                yield
            if stage == self.last and self.iteration == self.iterations - 1:
                torch.cuda.synchronize()
                self.wall_us = (time.perf_counter() - self.t0) * 1e6
            return
        torch.cuda.synchronize()
        before, t0 = counts(), time.perf_counter()
        yield
        torch.cuda.synchronize()
        self.records.append((self.iteration, stage, (time.perf_counter() - t0) * 1e3,
                             tuple(a - b for a, b in zip(counts(), before))))

    def profile(self, spans: tuple) -> dict:
        self.prof.__exit__(None, None, None)
        check(self.wall_us is not None, "the profiled iterations ended")
        return profile_summary(self.prof, self.wall_us, spans,
                               self.iterations - self.profile_from)

    def medians(self, skip: int = 1) -> dict:
        """p50 ms of each stage over iterations ``skip`` on (iteration 0
        builds cuDNN plans), summed per iteration first."""
        per = defaultdict(lambda: defaultdict(float))
        for it, stage, ms, _ in self.records:
            if it >= skip:
                per[stage][it] += ms
        return {k: statistics.median(v.values()) for k, v in per.items()}


def captured(fn):
    """``fn()``'s result and what it printed (echoed here too)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    print(buf.getvalue(), end="", flush=True)
    return out, buf.getvalue()


def eval_counts(size: int) -> tuple:
    """(K1 and K3 launches of one synthesis pass, the S-space mapper's K3
    attention convs) at ``size``: conv1 and one 3x3 conv per octave, one
    ToRGB each; the tapped layers' convs plus the first and the last."""
    per_pass = int(math.log2(size)) - 1
    return per_pass, len(attention_tables(size)["layer_num"]) + 2


def phase_evaluate_edits(card: str, work: str) -> dict:
    """15a: ``cli/evaluate.py edits`` through ``main`` at 1024² (attention
    and cluster layer 13, ViT-B/32 with seeded random weights), batch 2, 8
    iterations, with the seeded InceptionV3 and ArcFace from files; the
    launch counters set to 0 just before. Returns {kernel: launches}."""
    files = evaluation_weights(work)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    probe = StageProbe("text", EVAL_ITERS, EVAL_ITERS - EVAL_PROFILED, "inception")
    zero_counters()
    t0 = time.perf_counter()
    result = evaluate.main([
        "edits", "--stylegan_size", str(SIZE), "--attention_layer", str(ATTENTION_LAYER),
        "--cluster_layer", str(ATTENTION_LAYER), "--iterations", str(EVAL_ITERS),
        "--batch", str(EVAL_BATCH), "--inception_ckpt", files["inception"],
        "--ir_se50_weights", files["arcface"], "--device", DEV,
        "--description_dir", os.path.join(work, "no-captions")], span=probe)
    wall_s = time.perf_counter() - t0
    launches = launch_totals(launch_forms())
    prof = probe.profile(EVAL_STAGES)
    n = EVAL_ITERS * EVAL_BATCH
    check(set(result) == {"clip_improvement", "fid_features", "n", "id_cosine"},
          f"result keys {sorted(result)}")
    check(result["n"] == n, f"n {result['n']}, expected {n}")
    check(0.0 <= result["clip_improvement"] <= 1.0, f"clip_improvement {result}")
    check(-1.0 <= result["id_cosine"] <= 1.0, f"id_cosine {result}")
    check(math.isfinite(result["fid_features"]) and result["fid_features"] >= 0,
          f"fid_features {result}")
    per_pass, mapper_convs = eval_counts(SIZE)
    expect = {"faces": (per_pass, 0, per_pass),
              "edit": (per_pass, 0, per_pass + mapper_convs)}
    for it, stage, _, got in probe.records:
        check(got == expect.get(stage, (0, 0, 0)),
              f"iteration {it} {stage}: launches (K1, K2, K3) {got}")
    per_iter = total(expect["faces"], expect["edit"])
    check(counts() == tuple(EVAL_ITERS * x for x in per_iter),
          f"launches (K1, K2, K3) {counts()}, expected {EVAL_ITERS} x {per_iter}")
    stage_ms = probe.medians()
    emit({"phase": "evaluate_edits", "card": card, "size": SIZE,
          "attention_layer": ATTENTION_LAYER, "iterations": EVAL_ITERS,
          "batch": EVAL_BATCH, "result": result, "launches": launches,
          "launches_per_iteration": dict(zip(("modconv3x3", "conv3x3", "modconv1x1"),
                                             per_iter)),
          "p50_stage_ms": stage_ms, "p50_iteration_ms": sum(stage_ms.values()),
          "stage_ms": [r[:3] for r in probe.records], "main_wall_s": wall_s,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "note": "stages fenced by torch.cuda.synchronize over iterations 1-5 "
                  "(iteration 0 builds cuDNN plans); iterations 6-7 unfenced "
                  "under torch.profiler (the evaluate_profile line); main_wall_s "
                  "includes loading the models and the host's FID"})
    emit({"phase": "evaluate_profile", "card": card, "iterations": EVAL_PROFILED,
          "wall_ms_per_iteration": prof["wall_ms"],
          "device_busy_ms_per_iteration": prof["device_busy_ms"],
          "device_idle_share": prof["device_idle_share"],
          "kernel_launches_per_iteration": prof["kernel_launches"],
          "stage_device_busy_ms_per_iteration": prof["span_device_busy_ms"],
          "categories": prof["categories"], "top_kernels": prof["top_kernels"]})
    return launches


def write_celeba_pairs(root: str, faces: torch.Tensor, seed: int = 0) -> tuple:
    """CelebAMask-HQ-style pairs under ``root``: ``img/{i}.jpg`` from the
    256² faces (JPEG) and ``label/{i}.png``, seeded 0-13 class maps at
    CelebAMask-HQ's 512² in 32-pixel cells. Returns (img_path, label_path)."""
    from PIL import Image  # noqa: PLC0415

    img_dir, lbl_dir = os.path.join(root, "img"), os.path.join(root, "label")
    os.makedirs(img_dir)
    os.makedirs(lbl_dir)
    u8 = ((faces.float().cpu().numpy() + 1.0) * 127.5).round().clip(0, 255).astype(np.uint8)
    rng = np.random.default_rng(seed)
    for i, face in enumerate(u8):
        Image.fromarray(face).save(os.path.join(img_dir, f"{i}.jpg"))
        cells = rng.integers(0, 14, (16, 16)).astype(np.uint8)
        Image.fromarray(cells.repeat(32, 0).repeat(32, 1), mode="L").save(
            os.path.join(lbl_dir, f"{i}.png"))
    return img_dir, lbl_dir


def phase_evaluate_iou(card: str, work: str, faces: torch.Tensor) -> dict:
    """15b: ``cli/evaluate.py iou`` through ``main`` at 1024² on 8
    synthetic pairs (phase 7a's seeded faces pooled to 256², as JPEGs;
    seeded 0-13 label PNGs) with phase 7a's e4e checkpoint; the launch
    counters set to 0 just before. Returns {kernel: launches}."""
    img_dir, lbl_dir = write_celeba_pairs(os.path.join(work, "celeba"), faces)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    probe = StageProbe("invert", IOU_PAIRS)
    zero_counters()
    t0 = time.perf_counter()
    macro, printed = captured(lambda: evaluate.main([
        "iou", "--stylegan_size", str(SIZE), "--attention_layer", str(ATTENTION_LAYER),
        "--cluster_layer", str(ATTENTION_LAYER), "--e4e_ckpt", os.path.join(work, "e4e.pt"),
        "--img_path", img_dir, "--label_path", lbl_dir, "--device", DEV], span=probe))
    wall_s = time.perf_counter() - t0
    launches = launch_totals(launch_forms())
    out = json.loads(printed.strip().splitlines()[-1])
    per_class = out["per_class_iou"]
    check(len(per_class) == 8 and all(0.0 <= v <= 1.0 for v in per_class),
          f"per-class IoU {per_class}")
    check(0.0 <= macro <= 1.0 and out["macro_iou"] == macro, f"macro IoU {macro}")
    per_pass, mapper_convs = eval_counts(SIZE)
    expect = {"capture": (per_pass, 0, per_pass), "mapper": (0, 0, mapper_convs)}
    mapper_calls = defaultdict(int)
    for it, stage, _, got in probe.records:
        check(got == expect.get(stage, (0, 0, 0)),
              f"image {it} {stage}: launches (K1, K2, K3) {got}")
        mapper_calls[it] += stage == "mapper"
    check(probe.iteration == IOU_PAIRS - 1
          and set(mapper_calls.values()) == {len(IOU_PROMPTS)},
          f"{probe.iteration + 1} images, mapper calls {dict(mapper_calls)}")
    per_image = total(expect["capture"],
                      tuple(len(IOU_PROMPTS) * x for x in expect["mapper"]))
    check(counts() == tuple(IOU_PAIRS * x for x in per_image),
          f"launches (K1, K2, K3) {counts()}, expected {IOU_PAIRS} x {per_image}")
    stage_ms = probe.medians()
    emit({"phase": "evaluate_iou", "card": card, "size": SIZE, "pairs": IOU_PAIRS,
          "attention_layer": ATTENTION_LAYER, "per_class_iou": per_class,
          "macro_iou": macro, "launches": launches,
          "launches_per_image": dict(zip(("modconv3x3", "conv3x3", "modconv1x1"),
                                         per_image)),
          "p50_stage_ms_per_image": stage_ms, "p50_image_ms": sum(stage_ms.values()),
          "stage_ms": [r[:3] for r in probe.records], "main_wall_s": wall_s,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "note": "per image: invert (e4e at 256², batch 1), capture (the 1024² "
                  "synthesis with taps), mapper (8 region prompts, summed); "
                  "fenced by torch.cuda.synchronize, p50 over images 1-7; random "
                  "weights and labels, so the IoU values carry no meaning"})
    return launches


def phase_evaluate_whole(card: str, work: str) -> None:
    """15c: card against CPU on the same seeded weights: InceptionV3 at
    batch 2, 299² (features and logits), ArcFace at batch 2, 112²
    (``EVAL_REL_TOL``); the edit sweep's ``EditEvaluator`` at 64² (attention
    and cluster layer 7), the same W+ and token ids on both sides, through
    the CLI's own loaders (``EVAL_*_TOL``)."""
    files = evaluation_weights(work)
    g = torch.Generator().manual_seed(21)
    rec = {"phase": "evaluate_whole", "card": card}
    inc_sd = torch.load(files["inception"], weights_only=True)
    arc_sd = torch.load(files["arcface"], weights_only=True)
    for name, build, shape in (
            ("inception", lambda: InceptionV3.from_state_dict(inc_sd), (2, 299, 299, 3)),
            ("arcface", lambda: Backbone.from_state_dict(arc_sd, drop_ratio=0.6),
             (2, 112, 112, 3))):
        x = torch.rand(shape, generator=g) * 2 - 1
        cpu, gpu = build().eval(), build().to(DEV).eval()
        with torch.no_grad():
            want, got = cpu(x), gpu(x.to(DEV))
        outs = (("features", "logits") if name == "inception" else ("embedding",))
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for key, w, o in zip(outs, want, got):
            rec[f"{name}_{key}_rel_err"] = rel_err(o.cpu(), w)[1]
        del cpu, gpu
    rec["extractor_rel_tol"] = EVAL_REL_TOL

    size, layer = 64, 7
    evals = []
    n = counts()
    for dev in ("cpu", DEV):
        args = evaluate.build_argparser().parse_args([
            "edits", "--stylegan_size", str(size), "--attention_layer", str(layer),
            "--cluster_layer", str(layer), "--iterations", "2", "--batch", "2",
            "--device", dev, "--description_dir", os.path.join(work, "no-captions")])
        session, closs = evaluate.load_models(args)
        if dev == "cpu":
            bank = [session.sample_wplus(100 + i, batch=2) for i in range(2)]
        ev = EditEvaluator(
            edit_fn=evaluate.make_edit_fn(session, wplus_for=lambda i: bank[i].to(dev)),
            encode_image=closs.encode_image, encode_text=closs.encode_text,
            id_extract=evaluate.load_id_extract(files["arcface"], dev),
            fid_extract=evaluate.load_fid_extract(files["inception"], dev))
        result = ev.run(range(2), evaluate.sweep_prompts(args, random.Random(0), dev))
        evals.append((result, ev.feats_gen, ev.feats_orig))
    sync()
    launched = tuple(a - b for a, b in zip(counts(), n))
    (r_c, gen_c, orig_c), (r_g, gen_g, orig_g) = evals
    pool_rel = max(rel_err(torch.from_numpy(gen_g), torch.from_numpy(gen_c))[1],
                   rel_err(torch.from_numpy(orig_g), torch.from_numpy(orig_c))[1])
    rec.update({"sweep_size": size, "sweep_attention_layer": layer,
                "result_cpu": r_c, "result_card": r_g,
                "id_cosine_abs_err": abs(r_g["id_cosine"] - r_c["id_cosine"]),
                "pool_rel_err": pool_rel, "card_launches": launched,
                "id_abs_tol": EVAL_ID_ABS_TOL, "pool_rel_tol": EVAL_POOL_REL_TOL})
    emit(rec)
    for key, v in rec.items():
        if key.endswith("_rel_err") and key != "pool_rel_err":
            check(v <= EVAL_REL_TOL, f"{key} {v}")
    check(launched[0] > 0 and launched[2] > 0, "the card's sweep ran on K1 and K3")
    check(r_g["clip_improvement"] == r_c["clip_improvement"] and r_g["n"] == r_c["n"],
          f"clip_improvement card {r_g} vs CPU {r_c}")
    check(rec["id_cosine_abs_err"] <= EVAL_ID_ABS_TOL,
          f"id_cosine card vs CPU {rec['id_cosine_abs_err']}")
    check(pool_rel <= EVAL_POOL_REL_TOL, f"feature pools card vs CPU {pool_rel}")


def phase_train_fid(card: str, work: str) -> dict:
    """15d: ``cli/train_stylegan.py`` at 1024², batch 8, 2 iterations with
    ``--fid_every 2 --fid_n 16 --fid_batch 8`` and the seeded InceptionV3;
    the launch counters set to 0 just before: the training programs as
    phase 8 counts them, the real pool's features no kernel, the FID pass
    two syntheses of the EMA generator. Returns {kernel: launches}."""
    files = evaluation_weights(work)
    probe = TrainProbe()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    args = [*TRAIN_ARGS[:TRAIN_ARGS.index("--iter") + 1], "2",
            *TRAIN_ARGS[TRAIN_ARGS.index("--iter") + 2:]]
    with tempfile.TemporaryDirectory() as results:
        trainer, printed = captured(lambda: train_stylegan.main(
            [*args, *FID_ARGS, "--inception_ckpt", files["inception"],
             "--device", DEV, "--results_dir", results], span=probe))
        fids = [r for r in read_scalars(os.path.join(results, "logs"))
                if r["tag"] == "eval/fid"]
    launches = launch_totals(launch_forms())
    per_pass, _ = eval_counts(SIZE)
    expect = train_launches(trainer.g.log_size - 2)
    expect.update({"fid_reals": ((0, 0, 0), (0, 0, 0)),
                   "fid": ((2 * per_pass, 0, 2 * per_pass), (0, 0, 0))})
    for step, program, _, got in probe.records:
        fwd, bwd = expect.get(program, ((0, 0, 0), (0, 0, 0)))
        check(got == total(fwd, bwd), f"iteration {step} {program}: launches "
                                      f"(K1, K2, K3) {got}, expected {fwd} + {bwd}")
    lines = [ln for ln in printed.splitlines() if "fid=" in ln]
    check(len(lines) == 1 and math.isfinite(float(lines[0].split("fid=")[1])),
          f"printed FID lines {lines}")
    check([r["step"] for r in fids] == [2] and math.isfinite(fids[0]["value"]),
          f"logged eval/fid {fids}")
    ms = {p: [t for _, q, t, _ in probe.records if q == p] for p in ("fid_reals", "fid")}
    emit({"phase": "train_fid", "card": card, "size": SIZE,
          "batch": trainer.cfg.batch_size, "iterations": trainer.global_step,
          "fid_args": FID_ARGS, "fid": fids[0]["value"], "launches": launches,
          "fid_pass_ms": ms["fid"], "fid_reals_ms": ms["fid_reals"],
          "ms_per_program": {p: [t for _, q, t, _ in probe.records if q == p]
                             for p in (*PROGRAMS, "ema")},
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "note": "fid_pass_ms: the EMA generator's samples (fid_n in batches "
                  "of fid_batch), InceptionV3 at 299², and the host's Fréchet "
                  "distance (2048-d); fid_reals_ms: the real pool's features, "
                  "once before step 0"})
    return launches


# ---------------------------------------------------------------------------
# phases 16a-16d: the StyleCLIP latent mappers (cli/mapper_train.py,
# cli/mapper_inference.py)
# ---------------------------------------------------------------------------

STYLECLIP_STEPS, STYLESPACE_STEPS = 6, 2     # max_steps: steps 0-6 and 0-2
STYLECLIP_BATCH, STYLECLIP_TEST = 2, 8
STYLECLIP_STAGES = ("decode", "mapper", "edit", "id", "clip", "backward", "optim")
INFERENCE_LATENTS, INFERENCE_BATCH = 8, 2
# the Ranger update card against CPU from the same parameters and gradients,
# max |Δ| / max |CPU|: a few fp32 elementwise ops per step, 7 steps
RANGER_REL_TOL = 1e-5


def styleclip_args() -> list:
    """The trainer's flags at ``SIZE``: the defaults but for the 5000 and
    1000 latents, cut to 16 and 8 for the run's time; every step's losses
    logged."""
    return ["--stylegan_size", str(SIZE), "--description", "a person with purple hair",
            "--batch_size", str(STYLECLIP_BATCH), "--test_batch_size", "1",
            "--train_dataset_size", "16", "--test_dataset_size", str(STYLECLIP_TEST),
            "--board_interval", "1"]


def styleclip_launches(n_oct: int, val_batches: int) -> dict:
    """{stage: (K1, K2, K3) launches} of one StyleCLIP coach step at a size
    with ``n_oct`` octaves above 4² (L = n_oct + 1 layers per kernel: the
    generator's conv1 and one 3x3 conv per octave for K1, its ToRGBs for
    K3): decode and edit one synthesis each; backward K1's input gradient
    at every 3x3 conv but conv1 (its input is the frozen constant), K3's
    backward plain; the mapper, ArcFace, CLIP and the optimizer none (cuDNN
    and cuBLAS); a validation two syntheses per test batch; the latent
    sampling none (the mapping network only)."""
    lay = n_oct + 1
    table = {stage: (0, 0, 0) for stage in STYLECLIP_STAGES + ("sample",)}
    table.update({"decode": (lay, 0, lay), "edit": (lay, 0, lay),
                  "backward": (n_oct, 0, 0),
                  "validate": (2 * lay * val_batches, 0, 2 * lay * val_batches)})
    return table


class CoachProbe:
    """The ``span`` of ``cli/mapper_train.main``: fences each stage with
    ``torch.cuda.synchronize``, times it and reads the launch and K1
    preparation counters around it; checks after each backward that no
    generator, CLIP or ArcFace parameter has a gradient and every mapper
    parameter has one."""

    def __init__(self):
        self.records = []          # (step, stage, ms, (K1, K2, K3), prepares)
        self.coach = None

    @contextlib.contextmanager
    def __call__(self, stage, coach):
        self.coach = coach
        sync()
        before, prep, t0 = counts(), k1.prepares, time.perf_counter()
        yield
        sync()
        self.records.append((coach.global_step, stage, (time.perf_counter() - t0) * 1e3,
                             tuple(a - b for a, b in zip(counts(), before)),
                             k1.prepares - prep))
        if stage == "backward":
            frozen = [p for m in (coach.generator, coach.clip_loss.model,
                                  coach.id_loss.facenet)
                      for p in m.parameters() if p.grad is not None]
            check(not frozen, f"step {coach.global_step}: {len(frozen)} frozen "
                              "parameters have a gradient")
            missing = [n for n, p in coach.mapper.named_parameters() if p.grad is None]
            check(not missing, f"step {coach.global_step}: no gradient for {missing[:5]}")


def run_styleclip(card: str, work: str, name: str, flags: list, max_steps: int) -> tuple:
    """``cli/mapper_train.main`` at full width with ``flags``, seeded random
    ViT-B/32 and the seeded ArcFace IR-SE50 file, with a ``CoachProbe``:
    finite losses at every step, launches per stage against
    ``styleclip_launches``, K1's weights prepared at the first synthesis
    only.
    Emits the phase's line; returns ({kernel: launches}, {kernel: launches
    in backward passes}, the coach, its exp_dir)."""
    files = evaluation_weights(work)
    probe = CoachProbe()
    exp_dir = os.path.join(work, name)
    if DEV == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    zero_counters()
    coach = mapper_train.main([*styleclip_args(), *flags, "--max_steps", str(max_steps),
                               "--ir_se50_weights", files["arcface"], "--device", DEV,
                               "--exp_dir", exp_dir], span=probe)
    launches = launch_totals(launch_forms())
    peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    check(coach.global_step == max_steps and coach.cfg.id_lambda > 0
          and coach.cfg.clip_lambda > 0, "the coach ran every step with both losses")
    rows = [r for r in read_scalars(coach.log_dir) if r["tag"] == "train/loss"]
    check(len(rows) == max_steps + 1 and all(math.isfinite(r["value"]) for r in rows),
          f"logged train losses {rows}")
    n_oct = coach.generator.log_size - 2
    val_ms, stage_ms, step_ms = [], defaultdict(list), defaultdict(float)
    n_val = STYLECLIP_TEST // coach.cfg.test_batch_size
    backward = (0, 0, 0)
    for step, stage, ms, got, prep in probe.records:
        batches = min(5, n_val) if step == 0 else n_val
        want = styleclip_launches(n_oct, batches)[stage]
        check(got == want, f"{name} step {step} {stage}: launches {got}, expected {want}")
        # the generator's first synthesis prepares K1's weights, once
        first = step == 0 and stage == "decode"
        check(prep == (n_oct + 1 if first else 0),
              f"{name} step {step} {stage}: {prep} K1 weight preparations")
        if stage == "validate":
            val_ms.append(ms)
        elif stage == "backward":
            backward = total(backward, got)
        if stage in STYLECLIP_STAGES and step >= 1:
            stage_ms[stage].append(ms)
            step_ms[step] += ms
    steps = [s for s, stage, *_ in probe.records if stage == "optim"]
    check(steps == list(range(max_steps + 1)), f"{name}: steps {steps}")
    per_step = [step_ms[s] for s in sorted(step_ms)]
    expect = styleclip_launches(n_oct, 0)
    fwd = total(expect["decode"], expect["edit"])
    ckpts = sorted(os.listdir(os.path.join(exp_dir, "checkpoints")))
    want_ckpts = sorted(["best_model.pt", "iteration_0.pt", f"iteration_{max_steps}.pt",
                         "timestamp.txt"])
    check(ckpts == want_ckpts, f"{name}: checkpoints {ckpts}")
    val_loss = coach.best_val_loss
    check(val_loss is not None and math.isfinite(val_loss), f"{name}: validation {val_loss}")
    check(peak <= 80e9, f"{name}: peak {peak / 2 ** 30:.2f} GiB")
    emit({"phase": name, "card": card, "size": SIZE, "batch": STYLECLIP_BATCH,
          "steps": max_steps + 1, "mapper": type(coach.mapper).__name__,
          "work_in_stylespace": coach.cfg.work_in_stylespace,
          "train_losses": [r["value"] for r in rows], "best_val_loss": val_loss,
          "launches": launches,
          "launches_per_step_forward": dict(zip(("K1", "K2", "K3"), fwd)),
          "launches_per_step_backward": dict(zip(("K1", "K2", "K3"), expect["backward"])),
          "step_ms": per_step, "p50_step_ms": statistics.median(per_step),
          "stage_ms_p50": {k: statistics.median(v) for k, v in stage_ms.items()},
          "samples_per_s": STYLECLIP_BATCH * len(per_step) / (sum(per_step) / 1e3),
          "sample_latents_ms": [ms for _, st, ms, _, _ in probe.records if st == "sample"],
          "validate_ms": val_ms, "peak_mem_gib": peak / 2 ** 30, "checkpoints": ckpts,
          "note": f"steps 1-{max_steps} (step 0 builds cuDNN plans), each stage "
                  "fenced by torch.cuda.synchronize; a step's ms is the sum of its "
                  "stages; validation at step 0 (the 5-batch sanity pass) and at "
                  "the last step"})
    return launches, dict(zip(launches, backward)), coach, exp_dir


def phase_styleclip_train(card: str, work: str) -> tuple:
    """16a: ``LevelsMapper`` in W+, batch 2, 7 steps (0-6)."""
    return run_styleclip(card, work, "styleclip_train", [], STYLECLIP_STEPS)


def phase_styleclip_stylespace(card: str, work: str) -> dict:
    """16b: ``--work_in_stylespace --mapper_type WithoutToRGBStyleSpaceMapper``,
    3 steps (0-2): ``Generator.stylespace`` and the S-space decode."""
    launches, _, coach, _ = run_styleclip(
        card, work, "styleclip_stylespace",
        ["--work_in_stylespace", "--mapper_type", "WithoutToRGBStyleSpaceMapper"],
        STYLESPACE_STEPS)
    check(coach.cfg.work_in_stylespace and type(coach.mapper).__name__
          == "WithoutToRGBStyleSpaceMapper", "the S-space mapper trained")
    return launches


def phase_styleclip_inference(card: str, work: str, coach, exp_dir: str) -> dict:
    """16c: ``cli/mapper_inference.main`` on 16a's ``best_model.pt``, 8 of
    its test latents, test batch 2, ``--couple_outputs``: ms per batch from
    ``stats.txt``, launches (two syntheses per batch) held exactly, the saved
    latents against ``w + 0.1·mapper(w)`` from the checkpoint's weights."""
    ckpt = os.path.join(exp_dir, "checkpoints", "best_model.pt")
    lat_path = os.path.join(work, "styleclip_latents.pt")
    w = coach.test_latents[:INFERENCE_LATENTS].cpu()
    torch.save(w, lat_path)
    out_dir = os.path.join(work, "styleclip_inference")
    zero_counters()
    results = mapper_inference.main(["--exp_dir", out_dir, "--checkpoint_path", ckpt,
                                     "--latents_test_path", lat_path, "--couple_outputs",
                                     "--test_batch_size", str(INFERENCE_BATCH),
                                     "--device", DEV])
    launches = launch_totals(launch_forms())
    n_batches = INFERENCE_LATENTS // INFERENCE_BATCH
    per_pass = coach.generator.log_size - 1
    # K5 in each synthesis: an up-conv's blur and a ToRGB skip's Upsample an
    # octave; K4: the up-conv itself, once an octave
    want = {"modconv3x3": 2 * per_pass * n_batches, "conv3x3": 0,
            "modconv1x1": 2 * per_pass * n_batches,
            "upfirdn2d": 2 * 2 * (per_pass - 1) * n_batches,
            "upconv": 2 * (per_pass - 1) * n_batches}
    check(launches == want, f"inference launches {launches}, expected {want}")
    saved = torch.cat([torch.from_numpy(np.load(os.path.join(results, f"latents_{i:05d}.npy")))
                       for i in range(0, INFERENCE_LATENTS, INFERENCE_BATCH)])
    sd = torch.load(ckpt, map_location="cpu", weights_only=True)
    mapper = build_mapper(sd["opts"]["mapper_type"], **sd["opts"]).to(DEV).eval()
    mapper.load_state_dict(get_keys(sd, "mapper"))
    with torch.no_grad():
        want_w = torch.cat([(x + 0.1 * mapper(x)).cpu() for x in
                            w.to(DEV).split(INFERENCE_BATCH)])
    err = rel_err(saved, want_w)[1]
    check(err <= 1e-6, f"saved latents vs w + 0.1·mapper(w): rel {err}")
    check(len(glob.glob(os.path.join(results, "*.jpg"))) in (0, INFERENCE_LATENTS),
          "one image per latent (none without Pillow)")
    with open(os.path.join(results, "stats.txt")) as f:
        stats = f.read()
    mean_s, std_s = (float(v) for v in stats.split()[1].split("+-"))
    emit({"phase": "styleclip_inference", "card": card, "size": SIZE,
          "latents": INFERENCE_LATENTS, "batch": INFERENCE_BATCH, "couple_outputs": True,
          "launches": launches,
          "launches_per_batch": {k: v // n_batches for k, v in launches.items()},
          "ms_per_batch": mean_s * 1e3, "ms_per_batch_std": std_s * 1e3,
          "latents_rel_err": err,
          "images": len(glob.glob(os.path.join(results, "*.jpg"))),
          "note": "ms_per_batch: stats.txt's mean over batches 2-4 (an edit and "
                  "the original, each a synthesis at batch 2, torch.cuda.synchronize "
                  "before each reading), without the JPEG writes"})
    return launches


def styleclip_parts(size: int, mapper_type: str, dtype=torch.float32) -> tuple:
    """(generator with non-zero noise gains, mapper, CLIP ViT-B/32, ArcFace)
    at ``size`` on the CPU, seeded; the generator synthesises in ``dtype``."""
    rng = torch.Generator().manual_seed(31)
    gen = Generator(size, rng=rng, dtype=dtype)
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if name.endswith("noise.weight"):
                p.copy_(0.1 * torch.randn(1, generator=rng))
    mapper = build_mapper(mapper_type, n_styles=stylespace_count(size), rng=rng)
    with torch.no_grad():  # biases at 0.3 once lr_mul 0.01 scales them
        for name, p in mapper.named_parameters():
            if name.endswith("bias"):
                p.copy_(30 * torch.randn(p.shape, generator=rng))
    clip = CLIP(rng=torch.Generator().manual_seed(32))
    facenet = Backbone.from_state_dict(arcface_state(seed=0), drop_ratio=0.6)
    return gen.eval(), mapper, clip.eval(), facenet.eval()


def styleclip_whole(mapper_type: str, work: str, bf16: bool = False) -> dict:
    """One coach step at 64², batch 2, from the same weights and W+ on the
    CPU and on the card: the loss terms (``TRAIN_LOSS_REL_TOL``), the
    mapper's gradient (``TRAIN_*_GRAD_TOL``); then 7 Ranger steps on each
    device from the pre-step parameters with the CPU's gradient
    (``RANGER_REL_TOL``). With ``bf16`` a bf16 generator, at the bf16 bars
    and without the Ranger part."""
    size = 64
    stylespace = "StyleSpace" in mapper_type
    loss_tol, model_tol = ((BF16_LOSS_REL_TOL, BF16_MODEL_GRAD_TOL) if bf16
                           else (TRAIN_LOSS_REL_TOL, TRAIN_MODEL_GRAD_TOL))
    parts = styleclip_parts(size, mapper_type,
                            torch.bfloat16 if bf16 else torch.float32)
    start = {n: p.detach().clone() for n, p in parts[1].named_parameters()}
    g = torch.Generator().manual_seed(33)
    w = torch.randn(STYLECLIP_BATCH, 2 * int(math.log2(size)) - 2, 512, generator=g) * 0.5
    tokens = torch.from_numpy(np.asarray(tokenize(["a person with purple hair"]))).long()
    result = {}
    n = counts()
    for dev in ("cpu", DEV):
        gen, mapper, clip, facenet = (copy.deepcopy(m).to(dev) for m in parts)
        cfg = CoachConfig(exp_dir=os.path.join(work, f"whole_{mapper_type}_{dev}"
                                                      + ("_bf16" if bf16 else "")),
                          mapper_type=mapper_type, work_in_stylespace=stylespace,
                          batch_size=STYLECLIP_BATCH, test_batch_size=STYLECLIP_BATCH,
                          train_dataset_size=STYLECLIP_BATCH,
                          test_dataset_size=STYLECLIP_BATCH, stylegan_size=size)
        coach = Coach(cfg, generator=gen, mapper=mapper, clip_loss=CLIPLoss(clip, size),
                      id_loss=IDLoss(facenet), latent_avg=torch.zeros(1, 512, device=dev),
                      text_tokens=tokens.to(dev), train_latents=w, test_latents=w)
        coach.metrics.close()
        aux, _ = coach.step(next(coach._batches(coach.train_latents, STYLECLIP_BATCH,
                                                False)))
        result[dev] = ({k: float(v) for k, v in aux.items()},
                       {name: p.grad.double().cpu() for name, p in mapper.named_parameters()})
    launched = tuple(a - b for a, b in zip(counts(), n))
    (loss_c, grad_c), (loss_g, grad_g) = result["cpu"], result[DEV]
    loss_rel = {k: abs(loss_g[k] - loss_c[k]) / max(abs(loss_c[k]), 1e-30) for k in loss_c}
    diff2 = ref2 = worst = 0.0
    worst_name = None
    for name, gc in grad_c.items():
        d2, r2 = float((grad_g[name] - gc).square().sum()), float(gc.square().sum())
        diff2, ref2 = diff2 + d2, ref2 + r2
        e = math.sqrt(d2 / max(r2, 1e-60)) if d2 > 0 else 0.0
        if e > worst:
            worst, worst_name = e, name
    model_rel = math.sqrt(diff2 / ref2)
    if bf16:
        rec = {"size": size, "batch": STYLECLIP_BATCH, "mapper": mapper_type, "bf16": True,
               "losses_cpu": loss_c, "losses_card": loss_g, "loss_rel": loss_rel,
               "model_grad_rel": model_rel, "worst_param_grad_rel": worst,
               "worst_param": worst_name, "card_launches": launched,
               "loss_rel_tol": loss_tol, "model_grad_tol": model_tol}
        bad = {k: v for k, v in loss_rel.items() if not v <= loss_tol}
        check(not bad, f"64² bf16 {mapper_type} coach step losses: {bad}")
        check(model_rel <= model_tol, f"64² bf16 {mapper_type} mapper grads: rel {model_rel}")
        return rec
    # the optimizer alone: 7 Ranger steps (across the rectifier's switch and
    # the Lookahead sync at 6) on each device with the CPU's gradient
    params = {}
    for dev in ("cpu", DEV):
        ps = [torch.nn.Parameter(start[n].clone().to(dev)) for n in grad_c]
        opt = Ranger(ps, lr=0.5)
        for _ in range(7):
            for p, gc in zip(ps, grad_c.values()):
                p.grad = gc.float().to(dev)
            opt.step()
        params[dev] = torch.cat([p.detach().cpu().flatten() for p in ps])
    ranger_rel = rel_err(params[DEV], params["cpu"])[1]
    rec = {"size": size, "batch": STYLECLIP_BATCH, "mapper": mapper_type,
           "losses_cpu": loss_c, "losses_card": loss_g, "loss_rel": loss_rel,
           "model_grad_rel": model_rel, "worst_param_grad_rel": worst,
           "worst_param": worst_name, "ranger_param_rel": ranger_rel,
           "card_launches": launched, "loss_rel_tol": TRAIN_LOSS_REL_TOL,
           "param_grad_tol": TRAIN_PARAM_GRAD_TOL, "model_grad_tol": TRAIN_MODEL_GRAD_TOL,
           "ranger_rel_tol": RANGER_REL_TOL}
    bad = {k: v for k, v in loss_rel.items() if not v <= TRAIN_LOSS_REL_TOL}
    check(not bad, f"64² {mapper_type} coach step losses: {bad}")
    check(model_rel <= TRAIN_MODEL_GRAD_TOL, f"64² {mapper_type} mapper grads: rel {model_rel}")
    check(worst <= TRAIN_PARAM_GRAD_TOL, f"64² {mapper_type} {worst_name}: rel {worst}")
    check(ranger_rel <= RANGER_REL_TOL, f"Ranger card vs CPU: rel {ranger_rel}")
    if DEV == "cuda":
        check(launched[0] > 0 and launched[2] > 0, "the card's step ran on K1 and K3")
    return rec


def phase_styleclip_whole(card: str, work: str) -> None:
    """16d: card against CPU at 64² for ``LevelsMapper`` (W+) and
    ``FullStyleSpaceMapper`` (S-space), under ``cudnn.deterministic``:
    without it the card's W+ gradient moves by ~3e-4 run to run (cuDNN's
    atomic sums, then leaky-ReLU pre-activations near 0 at 4²-8² taking
    the other slope), and its distance to the CPU's with it."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = [styleclip_whole(m, work) for m in ("LevelsMapper", "FullStyleSpaceMapper")]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    emit({"phase": "styleclip_whole", "card": card, "cudnn_deterministic": True,
          "runs": runs})


# ---------------------------------------------------------------------------
# phases 17a-17d: the trainers in bf16, and the memory levers
# ---------------------------------------------------------------------------

BF16_TRAIN_FLAGS = ["--bf16", "--d_bf16", "--workers", "2", "--hflip",
                    "--sample_every", "5", "--n_sample", "4"]
LEVER_BATCH = 16
LEVER_ARGS = ["--synthetic", "16", "--size", str(SIZE), "--channel_multiplier", "2",
              "--batch", str(LEVER_BATCH), "--iter", "2", "--seed", "0",
              "--save_every", "0", "--bf16", "--remat", "--d_bf16", "--d_remat",
              "--d_microbatch", "4", "--g_microbatch", "8"]
def bf16_only(forms: dict) -> bool:
    """Every K1-K3 launch of a ``launch_forms()`` record a bf16 one, and no
    K4 launch: K4 has no bf16 form, so a bf16 up-conv takes the plain path
    (K5 also runs fp32 in a bf16 run: the ToRGB skip's input is the fp32
    ToRGB output)."""
    return (all(forms[k]["fp32"] == 0 for k in KERNEL_NAMES)
            and forms["upconv"]["fp32"] == 0)


def check_all_bf16(what: str) -> dict:
    """The launch forms, checked by ``bf16_only``."""
    forms = launch_forms()
    check(bf16_only(forms), f"{what}: fp32 kernel forms launched in a bf16 run: {forms}")
    return forms


def bf16_profile(trainer) -> dict:
    """One more iteration of a bf16 trainer, at a step that runs every
    program, under ``torch.profiler`` with shapes: the summary of phase 9,
    device ms and launches of K1, K2 and K3 by form (kernel names carry
    their element type), and every forward cuDNN convolution
    (``aten::cudnn_convolution``) whose weight is 3x3 on a power-of-two
    input at more than one sample: a K1 or K2 call of the trainer (batch
    8, path batch 4), of which there must be none (the discriminator's
    downsampling 3x3 convs run on odd sizes after their blur, the up-conv
    is a transposed convolution). The same shapes at one sample are
    counted apart: the path penalty's second derivative through K1's
    per-sample weight gradient (plain, one sample per call) runs them."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    g = torch.Generator(DEV).manual_seed(3)
    real = torch.rand(trainer.cfg.batch_size, SIZE, SIZE, 3, generator=g,
                      device=DEV) * 2 - 1
    trainer.global_step = 16 * trainer.cfg.g_reg_every * trainer.cfg.d_reg_every
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        trainer.step(real)
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    summary = profile_summary(prof, wall_us, (), 1)
    forms = defaultdict(lambda: [0.0, 0])
    cudnn_ops = defaultdict(int)
    on_kernel_shapes, per_sample = [], 0
    for e in prof.events():
        low = e.name.lower()
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kind = ("K1" if "modconv3x3" in low else "K2" if "conv3x3_k2" in low
                    else "K3" if "modconv1x1" in low else None)
            if kind:
                form = "bf16" if "bfloat16" in low or "bf16" in low else "fp32"
                forms[f"{kind} {form}"][0] += (e.time_range.end - e.time_range.start) / 1e3
                forms[f"{kind} {form}"][1] += 1
        elif low.startswith("aten::cudnn_convolution"):
            cudnn_ops[e.name] += 1
            shapes = e.input_shapes
            if (e.name == "aten::cudnn_convolution" and len(shapes) >= 2
                    and len(shapes[0]) == 4 and len(shapes[1]) == 4
                    and list(shapes[1][2:]) == [3, 3]
                    and shapes[0][2] >= 4 and shapes[0][2] & (shapes[0][2] - 1) == 0):
                if shapes[0][0] == 1:
                    per_sample += 1
                else:
                    on_kernel_shapes.append([list(shapes[0]), list(shapes[1])])
    return {**summary, "kernel_forms": {k: {"ms": v[0], "launches": v[1]}
                                        for k, v in sorted(forms.items())},
            "cudnn_forward_ops": dict(cudnn_ops),
            "cudnn_convs_on_k1_k2_shapes": on_kernel_shapes,
            "cudnn_per_sample_wgrad_double_backward_convs": per_sample}


def g_ema_file(work: str) -> tuple:
    """A reference-layout ``.pt`` holding a seeded 1024² generator under
    ``g_ema`` (the ``--ckpt`` warm start); (path, its state dict)."""
    sd = Generator(SIZE, channel_multiplier=2,
                   rng=torch.Generator().manual_seed(7)).state_dict()
    path = os.path.join(work, "g_ema.pt")
    torch.save({"g_ema": sd}, path)
    return path, sd


def train_records(probe, expect: dict) -> tuple:
    """(ms per program, iteration ms, launches per program by step: (K1,
    K2, K3) of the bf16 and of the fp32 forms) of a ``TrainProbe``, each
    program's launches against ``expect`` where it has the program."""
    ms, iteration_ms, got = defaultdict(list), defaultdict(float), {}
    for (step, program, t, launched), bf16 in zip(probe.records, probe.bf16):
        ms[program].append(t)
        iteration_ms[step] += t
        got[f"{step} {program}"] = {"bf16": bf16,
                                    "fp32": tuple(a - b for a, b in zip(launched, bf16))}
        if program in expect:
            check(launched == expect[program], f"iteration {step} {program}: launches "
                                               f"{launched}, expected {expect[program]}")
    return dict(ms), [iteration_ms[s] for s in sorted(iteration_ms)], got


def phase_train_bf16(card: str, work: str, fp32_peak_gib: float) -> tuple:
    """17a: ``cli/train_stylegan.main`` at 1024², batch 8, 5 iterations with
    ``--bf16 --d_bf16 --workers 2 --hflip --sample_every 5 --n_sample 4``,
    warm-started with ``--ckpt`` from a ``g_ema`` file written here: G
    starts from the file's weights, every K1, K2 and K3 launch is a bf16
    form, each program's launches are phase 8's, every parameter moves,
    the EMA sample grid is written (with Pillow); images/s, ms per program,
    peak memory beside phase 8's fp32 run (``fp32_peak_gib``); then one
    profiled iteration (``bf16_profile``). Returns ({kernel: launches}, the trainer)."""
    path, sd = g_ema_file(work)
    probe = TrainProbe()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    with tempfile.TemporaryDirectory() as results:
        trainer = train_stylegan.main([*TRAIN_ARGS, *BF16_TRAIN_FLAGS, "--ckpt", path,
                                       "--results_dir", results], span=probe)
        grids = sorted(os.path.basename(f)
                       for f in glob.glob(os.path.join(results, "sample_*.jpg")))
    peak = torch.cuda.max_memory_allocated()
    forms = check_all_bf16("17a")
    launches = {k: v["bf16"] for k, v in forms.items()}
    check(all(launches[k] for k in (*KERNEL_NAMES, "upfirdn2d")), f"17a launches {launches}")
    check(trainer.g.dtype == torch.bfloat16 and trainer.d.dtype == torch.bfloat16,
          "17a: a bf16 generator and discriminator")
    started = [n for (n, _), p0 in zip(trainer.g.named_parameters(), probe.start["g"])
               if not torch.equal(p0.cpu(), sd[n])]
    check(not started, f"--ckpt did not warm-start G: {started[:5]}")
    for m in ("g", "d"):
        still = [n for (n, p), p0 in zip(getattr(trainer, m).named_parameters(),
                                         probe.start[m]) if torch.equal(p, p0)]
        check(not still, f"17a: {m} parameters that did not move: {still[:5]}")
    pil = importlib.util.find_spec("PIL") is not None
    check(grids == ["sample_0000005.jpg"] if pil else grids == [],
          f"17a sample grids {grids} (Pillow: {pil})")
    expect = {p: total(*v) for p, v in train_launches(trainer.g.log_size - 2).items()}
    ms, iteration_ms, by_program = train_records(probe, expect)
    batch = trainer.cfg.batch_size
    emit({"phase": "train_bf16", "card": card, "size": SIZE, "batch": batch,
          "flags": BF16_TRAIN_FLAGS + ["--ckpt"], "iterations": len(iteration_ms),
          "launches_by_form": forms,
          "launches_per_program": expect, "launches_by_step_program": by_program,
          "ms_per_program": ms,
          "iteration_ms": iteration_ms,
          "images_per_s": batch * len(iteration_ms) / (sum(iteration_ms) / 1e3),
          "losses": probe.losses, "peak_mem_gib": peak / 2 ** 30,
          "fp32_peak_mem_gib": fp32_peak_gib, "sample_grids": grids,
          "pillow": pil,
          "note": "each program fenced by torch.cuda.synchronize; iteration 0 runs "
                  "R1 and path length and builds cuDNN plans; fp32_peak_mem_gib is "
                  "phase 8's run (the same flags without the bf16 ones)"})
    zero_counters()
    rec = bf16_profile(trainer)
    emit({"phase": "train_bf16_profile", "card": card, "size": SIZE, "batch": batch,
          **rec})
    check(not rec["cudnn_convs_on_k1_k2_shapes"],
          f"cuDNN ran K1/K2 shapes: {rec['cudnn_convs_on_k1_k2_shapes'][:3]}")
    check_all_bf16("17a profile")
    return launches, trainer


def phase_train_levers(card: str) -> dict:
    """17b: two iterations at 1024², batch 16, with ``--bf16 --remat
    --d_bf16 --d_remat --d_microbatch 4 --g_microbatch 8``: peak memory, ms
    per program, launches per program against the same programs without
    remat (``train_launches`` per chunk: 4 D chunks, 2 G chunks, the path
    batch 8), whose difference is what the recomputing forwards add; every
    launch a bf16 form. Returns {kernel: launches}."""
    probe = TrainProbe()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    with tempfile.TemporaryDirectory() as results:
        trainer = train_stylegan.main([*LEVER_ARGS, "--results_dir", results], span=probe)
    peak = torch.cuda.max_memory_allocated()
    forms = check_all_bf16("17b")
    n_oct = trainer.g.log_size - 2
    base = train_launches(n_oct)
    nd = LEVER_BATCH // trainer.cfg.d_microbatch
    ng = LEVER_BATCH // trainer.cfg.g_microbatch
    lay = n_oct + 1
    without_remat = {  # the fake batch once, then each chunk's programs
        "d": total((lay, 0, lay), tuple(nd * v for v in (0, 4 * lay, 0))),
        "r1": tuple(nd * v for v in total(*base["r1"])),
        "g": tuple(ng * v for v in total(*base["g"])),
        "path": total(*base["path"])}
    ms, iteration_ms, got = train_records(probe, {"path": without_remat["path"]})
    extra = {k: tuple(a - b for a, b in zip(v["bf16"], without_remat[k.split()[1]]))
             for k, v in got.items() if k.split()[1] in without_remat}
    g_extra = [v for k, v in extra.items() if k.endswith(" g")]
    d_extra = [v for k, v in extra.items() if k.endswith(" d")]
    check(all(e[0] > 0 and e[2] > 0 for e in g_extra), f"--remat recomputed no G: {g_extra}")
    check(all(e[1] > 0 for e in d_extra), f"--d_remat recomputed no D block: {d_extra}")
    emit({"phase": "train_levers", "card": card, "size": SIZE, "batch": LEVER_BATCH,
          "flags": LEVER_ARGS[LEVER_ARGS.index("--bf16"):], "d_chunks": nd,
          "g_chunks": ng,
          "launches_by_form": forms, "launches_by_step_program": got,
          "launches_without_remat": without_remat, "remat_extra_launches": extra,
          "ms_per_program": ms, "iteration_ms": iteration_ms,
          "images_per_s": LEVER_BATCH * len(iteration_ms) / (sum(iteration_ms) / 1e3),
          "losses": probe.losses, "peak_mem_gib": peak / 2 ** 30,
          "note": "iteration 0 runs every program (R1 and path length) and builds "
                  "cuDNN plans; each program fenced by torch.cuda.synchronize"})
    del trainer
    return {k: v["bf16"] for k, v in forms.items()}


def phase_attention_bf16(card: str, cluster_path: str) -> dict:
    """17c (region attention): ``cli/run_attention.main`` with ``--bf16
    --remat`` at 1024², batch 8, 4 steps, through the production S-space
    branch on phase 11's pickle, with phase 12's probe: every K1 launch a
    bf16 form, and every K3 launch but those of a StyledConv whose input is
    fp32 (the mapper's ``attention_first``, over the generator's fp32
    constant input, as in the JAX mapper; counted by a forward hook); the
    edit synthesis' launches phase 12's; ms per step over steps 1-3 with
    the fenced stage split (the recomputed synthesis runs inside
    ``backward``), peak memory. Returns {kernel: launches}."""
    probe = AttentionProbe()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    steps = 4
    fp32_convs = [0]

    def count_fp32(module, args, out):
        if isinstance(module, StyledConv) and args[0].dtype == torch.float32:
            fp32_convs[0] += 1

    hook = torch.nn.modules.module.register_module_forward_hook(count_fp32)
    try:
        with tempfile.TemporaryDirectory() as results:
            run_attention.main(["--stylegan_size", str(SIZE), "--work_in_stylespace",
                                "--use_cluster", "--cluster_path", cluster_path,
                                "--batch_size", str(ATTENTION_BATCH), "--step", str(steps),
                                "--save_intermediate_image_every", "0", "--bf16", "--remat",
                                "--device", DEV, "--results_dir", results], span=probe)
    finally:
        hook.remove()
    peak = torch.cuda.max_memory_allocated()
    forms = launch_forms()
    check(forms["modconv3x3"]["fp32"] == forms["conv3x3"]["fp32"] == 0
          and forms["upconv"]["fp32"] == 0
          and forms["modconv1x1"]["fp32"] == fp32_convs[0],
          f"17c attention: launches by form {forms}, fp32-input StyledConv calls "
          f"{fp32_convs[0]}")
    trainer = probe.trainer
    check(trainer.cfg.remat and trainer.generator.dtype == torch.bfloat16,
          "17c: a bf16 generator and remat")
    expect = attention_launches(trainer.generator.log_size - 2,
                                len(trainer.mapper.layer_num) + 2)
    stage_ms, step_ms, per_stage = defaultdict(list), defaultdict(float), {}
    for step, stage, ms, got, _ in probe.records:
        if stage in ("synthesis", "mapper", "edit"):
            check(got == expect[stage], f"17c step {step} {stage}: launches {got}, "
                                        f"expected {expect[stage]}")
        per_stage[stage] = got
        if step >= 1:
            stage_ms[stage].append(ms)
            step_ms[step] += ms
    per_step = [step_ms[s] for s in sorted(step_ms)]
    emit({"phase": "attention_bf16", "card": card, "size": SIZE, "batch": ATTENTION_BATCH,
          "steps": steps, "flags": ["--bf16", "--remat"], "launches_by_form": forms,
          "fp32_input_styledconv_calls": fp32_convs[0],
          "launches_per_stage": per_stage, "step_ms": per_step,
          "mean_step_ms": statistics.mean(per_step),
          "stage_ms_mean": {k: statistics.mean(v) for k, v in stage_ms.items()},
          "samples_per_s": ATTENTION_BATCH * len(per_step) / (sum(per_step) / 1e3),
          "peak_mem_gib": peak / 2 ** 30,
          "note": "steps 1-3, each stage fenced by torch.cuda.synchronize; with "
                  "--remat the edit synthesis runs again inside backward"})
    return {k: v["bf16"] for k, v in forms.items()}


def phase_styleclip_bf16(card: str, work: str) -> dict:
    """17c (StyleCLIP): ``cli/mapper_train.main --bf16`` at 1024², batch 2, 4
    steps (0-3), through ``run_styleclip`` (phase 16a's checks and
    numbers); every launch a bf16 form. Returns {kernel: launches}."""
    zero_counters()
    _, _, coach, _ = run_styleclip(card, work, "styleclip_bf16", ["--bf16"], 3)
    check(coach.generator.dtype == torch.bfloat16, "17c: a bf16 coach generator")
    forms = check_all_bf16("17c styleclip")
    emit({"phase": "styleclip_bf16_forms", "launches_by_form": forms})
    return {k: v["bf16"] for k, v in forms.items()}


def phase_bf16_whole(card: str, work: str) -> None:
    """17d: card against CPU in bf16, each under ``cudnn.deterministic``:
    one GAN iteration at 64² (``train_whole(bf16=True)``: every program from
    the same state, and the image) and one at 256² with channel multiplier 1
    (whose K1 and K2 convs at 128² and 256² have 128 and 64 input channels,
    where the bf16 core runs one accumulator over K), one region-attention
    step and one StyleCLIP coach step (``LevelsMapper``) at 64², at the bf16
    bars; the card's runs on the bf16 forms."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    n = counts_bf16()
    try:
        runs = {"gan": train_whole(bf16=True),
                "gan_narrow": train_whole(bf16=True, size=256, channel_multiplier=1),
                "attention": attention_whole(bf16=True),
                "styleclip": styleclip_whole("LevelsMapper", work, bf16=True)}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    launched = tuple(a - b for a, b in zip(counts_bf16(), n))
    emit({"phase": "bf16_whole", "card": card, "cudnn_deterministic": True,
          "card_bf16_launches": launched, "runs": runs})
    check(launched[0] > 0 and launched[1] > 0 and launched[2] > 0,
          f"17d: bf16 launches {launched}")


# ---------------------------------------------------------------------------
# phase 18: data parallelism (parallel/) at world size 1 over NCCL
# ---------------------------------------------------------------------------

DP_ITERS = 3
DP_TRAIN_ARGS = ["--synthetic", "16", "--size", str(SIZE), "--channel_multiplier", "2",
                 "--batch", "8", "--iter", str(DP_ITERS), "--seed", "0",
                 "--save_every", "0", "--sample_every", "0", "--d_reg_every", "2",
                 "--g_reg_every", "2"]
DP_LOSS_REL_TOL = 1e-6  # where a deterministic run is not bitwise
# The fp32 GAN pair runs on cuDNN's default algorithms (see phase_dp), whose
# atomic sums make two runs of one program differ in the last bits; Adam
# with b1 = 0 then moves a weight whose gradient is such a difference away
# from 0 by up to ~lr, and the next iterations' losses move with it (0.7 %
# of the path penalty by iteration 2 between two runs without a group). So
# a second run without the group measures the card's own spread, which must
# be there (else the group, not the card, moved the numbers); the group's
# run is held to iteration 0's d_loss (forward only, from the same state)
# at DP_LOSS_REL_TOL, every metric within DP_SPREAD times that spread, and
# the weights at 5·lr (the JAX suite's bar for its sharded step,
# tests/test_gan_training.py:322-333).
DP_SPREAD, DP_WEIGHT_ATOL = 10.0, 5 * 0.002


class DpProbe:
    """The ``span`` of any of the five CLIs: each stage fenced by
    ``torch.cuda.synchronize`` and timed; the stage ``last`` closes an
    iteration (its ms: the stages' since the last close), and where the
    span's owner keeps a ``metrics`` dict (the GAN trainer) its values are
    kept per iteration. Stages in ``skip`` are not timed."""

    def __init__(self, last: str, skip: tuple = ()):
        self.last, self.skip = last, skip
        self.iter_ms, self.metrics, self._acc = [], [], 0.0

    def __call__(self, stage, *owner):
        return self._span(stage, owner[0] if owner else None)

    @contextlib.contextmanager
    def _span(self, stage, owner):
        sync()
        t0 = time.perf_counter()
        yield
        sync()
        if stage in self.skip:
            return
        self._acc += (time.perf_counter() - t0) * 1e3
        if stage == self.last:
            self.iter_ms.append(self._acc)
            self._acc = 0.0
            if isinstance(getattr(owner, "metrics", None), dict):
                self.metrics.append({k: float(v) for k, v in owner.metrics.items()})


def dp_call(fn) -> tuple:
    """``fn()`` under ``torch.profiler`` (device activity only) with the
    launch counters set to 0 just before and read just after. Returns (its value, {wall_ms, device
    events, NCCL kernels and their device ms by name}, launch forms)."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    zero_counters()
    sync()
    activity = ProfilerActivity.CUDA if DEV == "cuda" else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    forms = launch_forms()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    nccl = defaultdict(lambda: [0.0, 0])
    for e in events:
        if "nccl" in e.name.lower():
            nccl[e.name[:80]][0] += (e.time_range.end - e.time_range.start) / 1e3
            nccl[e.name[:80]][1] += 1
    return out, {"wall_ms": wall_ms, "device_events": len(events),
                 "nccl_launches": sum(n for _, n in nccl.values()),
                 "nccl_device_ms": sum(ms for ms, _ in nccl.values()),
                 "nccl_by_kernel": {k: {"ms": v[0], "launches": v[1]}
                                    for k, v in nccl.items()}}, forms


def dp_pair(name: str, run, last: str, iterations: int, skip: tuple = ()) -> dict:
    """``run(flag, probe)`` without the group (flag False: ``--dp 0``) and
    at world size 1 (True), each under ``dp_call``. Returns the record:
    both runs' values, probes and profiles, and what the group adds."""
    rec = {}
    for flag in (False, True):
        probe = DpProbe(last, skip)
        value, prof, forms = dp_call(lambda: run(flag, probe))  # noqa: B023
        rec[flag] = {"value": value, "probe": probe, "prof": prof, "forms": forms}
    base, grp = rec[False], rec[True]
    rec["failed"] = []
    dp_check(rec, grp["forms"] == base["forms"], f"{name}: kernel launches in the group "
                                         f"{grp['forms']}, without {base['forms']}")
    dp_check(rec, sum(f["fp32"] + f["bf16"] for f in grp["forms"].values()) > 0,
          f"{name}: no kernel launched")
    dp_check(rec, base["prof"]["nccl_launches"] == 0, f"{name}: NCCL kernels without a group")

    def per_iter(p):
        steady = p.iter_ms[1:] or p.iter_ms  # iteration 0 builds cuDNN plans
        return statistics.mean(steady) / (iterations if last == "collect" else 1)

    rec["summary"] = {
        "path": name, "iterations": iterations,
        "ms_per_iteration": {"dp0": per_iter(base["probe"]), "dp1": per_iter(grp["probe"])},
        "iteration_ms": {"dp0": base["probe"].iter_ms, "dp1": grp["probe"].iter_ms},
        "wall_ms": {"dp0": base["prof"]["wall_ms"], "dp1": grp["prof"]["wall_ms"]},
        "nccl_device_ms_per_iteration": grp["prof"]["nccl_device_ms"] / iterations,
        "nccl_launches_per_iteration": grp["prof"]["nccl_launches"] / iterations,
        "nccl_by_kernel": grp["prof"]["nccl_by_kernel"],
        "device_events_added_per_iteration":
            (grp["prof"]["device_events"] - base["prof"]["device_events"]) / iterations,
        "kernel_launches": grp["forms"]}
    return rec


def dp_check(rec: dict, cond: bool, what: str) -> None:
    """A check of phase 18, failed after the path's line is printed."""
    if not cond:
        rec["failed"].append(what)


def same_state(a: dict, b: dict) -> tuple:
    """(bitwise, max |Δ|) over the tensors of two state dicts."""
    bitwise, worst = True, 0.0
    for k, v in a.items():
        if torch.is_tensor(v) and v.is_floating_point():
            bitwise &= torch.equal(v, b[k])
            worst = max(worst, float((v.float() - b[k].float()).abs().max()))
    return bitwise, worst


def rel_diff(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def dp_train(work: str, bf16: bool) -> dict:
    """Item 1: ``cli/train_stylegan.py`` at 1024², batch 8, 3 iterations (R1
    and path length at 0 and 2), ``--dp 1`` against ``--dp 0``: the
    printed lines (their images/s aside), every iteration's metrics and the
    final checkpoint's G, D, G_ema and ``pl_mean``."""
    flags = ["--bf16", "--d_bf16"] if bf16 else []
    import io  # noqa: PLC0415

    def run(flag, probe):
        out = os.path.join(work, f"dp_train_{int(bf16)}_{int(flag)}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            trainer = train_stylegan.main([*DP_TRAIN_ARGS, *flags, "--results_dir", out,
                                           "--device", DEV,
                                           *(["--dp", "1"] if flag else [])], span=probe)
        lines = [line.split(" (")[0] for line in buf.getvalue().splitlines()
                 if re.match(r"\[\d+\] ", line)]  # the step lines
        check(os.path.isfile(os.path.join(out, f"ckpt_{DP_ITERS:07d}.pt")),
              "train: no final checkpoint")
        shutil.rmtree(out)
        # the final checkpoint's G, D, G_ema and pl_mean, from the trainer
        state = {m: {k: v.detach().cpu().clone() for k, v in
                     getattr(trainer, m).state_dict().items()} for m in ("g", "d", "g_ema")}
        return lines, {**state, "pl_mean": trainer.pl_mean.cpu()}

    rec = dp_pair("train_bf16" if bf16 else "train", run, "ema", DP_ITERS)
    (lines0, ck0), (lines1, ck1) = rec[False]["value"], rec[True]["value"]
    m0, m1 = rec[False]["probe"].metrics, rec[True]["probe"].metrics
    dp_check(rec, len(m0) == len(m1) == DP_ITERS and len(lines0) == len(lines1) > 0,
          f"train: metrics {m0} / {m1}, printed {lines0} / {lines1}")
    bitwise = m0 == m1 and lines0 == lines1
    worst_metric = max(rel_diff(a[k], b[k]) for a, b in zip(m1, m0) for k in b)
    parts = {}
    for part in ("g", "d", "g_ema"):
        parts[part] = same_state(ck1[part], ck0[part])
        bitwise &= parts[part][0]
    bitwise &= torch.equal(ck1["pl_mean"], ck0["pl_mean"])
    control = None
    if not bitwise:  # a second run without the group: the card's own spread
        probe = DpProbe("ema")
        _, ckc = run(False, probe)
        control = {"metrics_max_rel": max(rel_diff(a[k], b[k]) for a, b in
                                          zip(probe.metrics, m0) for k in b),
                   "weights_max_abs": {p: same_state(ckc[p], ck0[p])[1]
                                       for p in ("g", "d", "g_ema")}}
        dp_check(rec, probe.metrics != m0 or any(control["weights_max_abs"].values()),
                 "train: two runs without the group agree bitwise, the group's does not")
        dp_check(rec, rel_diff(m1[0]["d_loss"], m0[0]["d_loss"]) <= DP_LOSS_REL_TOL,
                 f"train: iteration 0 d_loss {m1[0]} / {m0[0]}")
        dp_check(rec, worst_metric <= DP_SPREAD * control["metrics_max_rel"] + DP_LOSS_REL_TOL,
                 f"train: metrics rel {worst_metric}, two runs without the group "
                 f"{control['metrics_max_rel']}")
        dp_check(rec, all(w <= DP_WEIGHT_ATOL for _, w in parts.values()),
                 f"train: weights {parts}")
    rec["summary"].update({"bf16": bf16, "bitwise": bool(bitwise), "control": control,
                           "metrics_max_rel": worst_metric,
                           "weights_max_abs": {k: v[1] for k, v in parts.items()},
                           "printed": lines1, "losses": m1})
    return rec


def dp_attention(work: str, cluster_path: str) -> dict:
    """Item 2: ``cli/run_attention.py`` (the production S-space mapper) at
    1024², batch 8, 2 steps: every logged loss term, ``--dp 1`` against
    ``--dp 0``."""
    def run(flag, probe):
        out = os.path.join(work, f"dp_attention_{int(flag)}")
        run_attention.main(["--stylegan_size", str(SIZE), "--work_in_stylespace",
                            "--use_cluster", "--cluster_path", cluster_path,
                            "--cluster_layer", str(CLUSTER_LAYER), "--batch_size", "8",
                            "--step", "2",
                            "--save_intermediate_image_every", "0", "--device", DEV,
                            "--results_dir", out, *(["--dp", "1"] if flag else [])],
                           span=probe)
        (log_dir,) = glob.glob(os.path.join(out, "logs", "*"))
        rows = [(r["tag"], r["step"], r["value"]) for r in read_scalars(log_dir)]
        shutil.rmtree(out)
        return rows

    rec = dp_pair("attention", run, "adam", 2)
    a, b = rec[True]["value"], rec[False]["value"]
    dp_check(rec, len(a) == len(b) > 0 and [r[:2] for r in a] == [r[:2] for r in b],
          "attention: logged terms differ")
    worst = max(rel_diff(x[2], y[2]) for x, y in zip(a, b))
    dp_check(rec, a == b or worst <= DP_LOSS_REL_TOL, f"attention: losses rel {worst}")
    rec["summary"].update({"bitwise": a == b, "losses_max_rel": worst,
                           "losses": {f"{t}@{s}": v for t, s, v in a}})
    return rec


def dp_cluster(work: str) -> tuple:
    """Item 3a: ``cli/run_clustering.py`` at 1024² (layer 13, batch 2, 1
    step): the centres, ``--dp 1`` against ``--dp 0``. Returns (the record,
    the ``--dp 0`` pickle's path)."""
    def run(flag, probe):
        out = os.path.join(work, f"dp_cluster_{int(flag)}")
        path = run_clustering.main(["--stylegan_size", str(SIZE), "--attention_layer",
                                    str(CLUSTER_LAYER), "--batch_size", "2", "--step", "1",
                                    "--device", DEV, "--results_dir", out,
                                    *(["--dp", "1"] if flag else [])], span=probe)
        return path, load_cluster_centers(path)

    rec = dp_pair("cluster", run, "collect", 1)
    c1, c0 = rec[True]["value"][1], rec[False]["value"][1]
    dp_check(rec, c1.shape == c0.shape and bool(np.isfinite(c1).all()), f"centres {c1.shape}")
    bitwise = bool(np.array_equal(c1, c0))
    worst = float(np.abs(c1 - c0).max() / max(np.abs(c0).max(), 1e-30))
    dp_check(rec, bitwise or worst <= DP_LOSS_REL_TOL, f"cluster: centres rel {worst}")
    rec["summary"].update({"bitwise": bitwise, "centres_max_rel": worst,
                           "centres_shape": list(c1.shape)})
    return rec, rec[False]["value"][0]


def dp_evaluate(work: str) -> dict:
    """Item 3b: ``cli/evaluate.py edits`` at 1024² (layer 13), batch 2, 2
    iterations (FID on CLIP image features): the JSON result, ``--dp 1``
    against ``--dp 0``."""
    def run(flag, probe):
        return evaluate.main(["edits", "--stylegan_size", str(SIZE), "--attention_layer",
                              str(ATTENTION_LAYER), "--cluster_layer", str(ATTENTION_LAYER),
                              "--iterations", "2", "--batch", "2", "--device", DEV,
                              "--description_dir", os.path.join(work, "no-captions"),
                              *(["--dp", "1"] if flag else [])], span=probe)

    rec = dp_pair("evaluate", run, "inception", 2)
    r1, r0 = rec[True]["value"], rec[False]["value"]
    dp_check(rec, set(r1) == set(r0) == {"clip_improvement", "fid_features", "n"}
          and r1["n"] == r0["n"] == 4, f"evaluate: {r1} / {r0}")
    worst = max(rel_diff(float(r1[k]), float(r0[k])) for k in r0)
    dp_check(rec, r1 == r0 or worst <= DP_LOSS_REL_TOL, f"evaluate: {r1} / {r0}")
    rec["summary"].update({"bitwise": r1 == r0, "result_max_rel": worst, "result": r1})
    return rec


def dp_styleclip(work: str) -> dict:
    """Item 4: ``cli/mapper_train.py`` (``LevelsMapper``) at 1024², batch 2,
    2 coach steps (CLIP and latent L2; no ArcFace file), ``--use_mesh``
    against the same without: every logged loss and the final mapper."""
    def run(flag, probe):
        exp = os.path.join(work, f"dp_styleclip_{int(flag)}")
        mapper_train.main([
            "--stylegan_size", str(SIZE), "--description", "a person with purple hair",
            "--batch_size", "2", "--test_batch_size", "1", "--train_dataset_size", "4",
            "--test_dataset_size", "1", "--board_interval", "1", "--max_steps", "1",
            "--device", DEV, "--exp_dir", exp, *(["--use_mesh"] if flag else [])],
            span=probe)
        rows = [(r["tag"], r["step"], r["value"]) for r in read_scalars(
            os.path.join(exp, "logs")) if not r["tag"].endswith("step_time")]
        state = torch.load(os.path.join(exp, "checkpoints", "iteration_1.pt"),
                           map_location="cpu", weights_only=True)["state_dict"]
        shutil.rmtree(exp)
        return rows, state

    rec = dp_pair("styleclip", run, "optim", 2, skip=("sample", "validate"))
    (a, sa), (b, sb) = rec[True]["value"], rec[False]["value"]
    dp_check(rec, len(a) == len(b) > 0 and [r[:2] for r in a] == [r[:2] for r in b],
          "styleclip: logged terms differ")
    worst = max(rel_diff(x[2], y[2]) for x, y in zip(a, b))
    mapper_bitwise, mapper_abs = same_state(sa, sb)
    dp_check(rec, (a == b and mapper_bitwise) or worst <= DP_LOSS_REL_TOL,
          f"styleclip: losses rel {worst}, mapper max |Δ| {mapper_abs}")
    rec["summary"].update({"bitwise": a == b and mapper_bitwise, "losses_max_rel": worst,
                           "mapper_max_abs": mapper_abs})
    return rec


def dp_multi_card(work: str) -> dict:
    """Item 6, only with more than one card: ``cli/train_stylegan.py --dp
    count`` (spawned ranks, one per card) against ``--dp 0``: the final
    G, D and G_ema at 5·lr and ``pl_mean`` at 1e-6 (the CPU test's bars)."""
    n = torch.cuda.device_count()
    ckpts = {}
    for dp in (0, n):
        out = os.path.join(work, f"dp_multi_{dp}")
        train_stylegan.main([*DP_TRAIN_ARGS, "--results_dir", out, "--dp", str(dp)])
        ckpts[dp] = torch.load(os.path.join(out, f"ckpt_{DP_ITERS:07d}.pt"),
                               map_location="cpu", weights_only=True)
        shutil.rmtree(out)
    worst = {p: same_state(ckpts[n][p], ckpts[0][p])[1] for p in ("g", "d", "g_ema")}
    pl = rel_diff(float(ckpts[n]["pl_mean"]), float(ckpts[0]["pl_mean"]))
    check(all(w <= 5 * 0.002 for w in worst.values()) and pl <= 1e-6,
          f"--dp {n}: weights {worst}, pl_mean rel {pl}")
    return {"world": n, "weights_max_abs": worst, "pl_mean_rel": pl}


def phase_dp(card: str, work: str) -> dict:
    """18: each of the five CLIs at world size 1 over NCCL (``--dp 1``;
    ``--use_mesh`` for ``mapper_train``, which spans the one card) against
    the same run without a group, under ``cudnn.deterministic`` but the fp32
    GAN pair (``DP_SPREAD``); on a machine with more cards, the GAN trainer
    at world size ``count`` too.
    Returns {path: launch forms} of the runs in the group."""
    deterministic = torch.backends.cudnn.deterministic
    try:
        # under cudnn.deterministic cuDNN gives the 1024² fp32 trainer's
        # strided 3x3 input gradients and transposed convs dgrad2d_alg1_1,
        # with which (and with its autotuner) the pair outlasts the run's
        # time limit: the fp32 pair runs on the default algorithms
        torch.backends.cudnn.deterministic = False
        recs = {"train": dp_train(work, False)}
        torch.backends.cudnn.deterministic = True
        recs["train_bf16"] = dp_train(work, True)
        recs["cluster"], cluster_path = dp_cluster(work)
        recs["attention"] = dp_attention(work, cluster_path)
        recs["evaluate"] = dp_evaluate(work)
        if torch.cuda.device_count() == 1:  # --use_mesh spans every card
            recs["styleclip"] = dp_styleclip(work)
        multi = dp_multi_card(work) if torch.cuda.device_count() > 1 else None
    finally:
        torch.backends.cudnn.deterministic = deterministic
    forms = recs["train_bf16"][True]["forms"]
    dp_check(recs["train_bf16"], bf16_only(forms),
             f"train_bf16: fp32 kernel forms launched: {forms}")
    for rec in recs.values():
        emit({"phase": "dp", "card": card, "world": 1, "backend": "nccl",
              **rec["summary"], "failed": rec["failed"]})
    for rec in recs.values():
        check(not rec["failed"], f"dp {rec['summary']['path']}: {rec['failed']}")
    emit({"phase": "dp_summary", "card": card, "world": 1,
          "paths": {k: {"bitwise": r["summary"]["bitwise"],
                        "ms_per_iteration": r["summary"]["ms_per_iteration"],
                        "nccl_device_ms_per_iteration":
                            r["summary"]["nccl_device_ms_per_iteration"],
                        "device_events_added_per_iteration":
                            r["summary"]["device_events_added_per_iteration"]}
                    for k, r in recs.items()},
          "multi_card": multi or "not run: one card"})
    return {k: r[True]["forms"] for k, r in recs.items()}


# --------------------------------------------------------------- phases 19-20
class CountingSpan:
    """``cli/validate.py``'s span: each validator's wall ms (a ``StageTimer``
    stage) and the counted kernels' launches by form."""

    def __init__(self, timer, prefix: str = ""):
        self.timer, self.prefix, self.launches = timer, prefix, {}

    @contextlib.contextmanager
    def __call__(self, name):
        before = launch_forms()
        with self.timer.stage(f"validate_{self.prefix}{name}"):
            yield
        after = launch_forms()
        self.launches[self.prefix + name] = {
            k: {f: after[k][f] - before[k][f] for f in ("fp32", "bf16")} for k in after}


def save_gan_checkpoint(trainer, work: str) -> str:
    """Phase 8's trainer, written by the GAN CLI's own writer
    (``train/checkpoints.py::save_checkpoint``), for phase 19's export."""
    path = os.path.join(work, "gan_ckpt.pt")
    save_checkpoint(path, trainer, trainer.global_step,
                    {"size": SIZE, "channel_multiplier": 2})
    return path


def live_epilogue(g: Generator, seed: int) -> Generator:
    """``g`` with seeded non-zero noise gains and biases: a fresh generator
    has them at 0, which would hide a fault in the noise's row slicing or
    in a kernel's epilogue."""
    rng = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in g.named_parameters():
            if name.endswith(("noise.weight", "activate.bias")) or (
                    "to_rgb" in name and name.endswith(".bias")):
                p.copy_(0.3 * torch.randn(p.shape, generator=rng))
    return g


def validate_files(work: str) -> dict:
    """Random reference-layout files at full size for ``cli/validate.py``,
    written with the port's own modules: a seeded 1024² ``g_ema`` with
    non-zero noise gains and biases (``live_epilogue``), phase 7a's e4e
    checkpoint, the seeded ArcFace IR-SE50 of phase 15a, a seeded VGG16, a
    seeded CLIP ViT-B/32 and both cluster mappers at 1024², layer 13, with
    random centres. {flag: path}."""
    files = {"g_ema": os.path.join(work, "validate_g_ema.pt"),
             "e4e": os.path.join(work, "e4e.pt"),
             "ir_se50": evaluation_weights(work)["arcface"],
             "vgg": os.path.join(work, "vgg16.pth"), "clip": os.path.join(work, "clip.pt"),
             "mapper": os.path.join(work, "mapper_style.pt"),
             "mapper_wplus": os.path.join(work, "mapper_wplus.pt")}
    check(os.path.exists(files["e4e"]), "phase 7a's e4e checkpoint is gone")
    g = live_epilogue(Generator(SIZE, rng=torch.Generator().manual_seed(7)), 4)
    torch.save({"g_ema": g.state_dict()}, files["g_ema"])
    del g
    torch.save(Vgg16(rng=torch.Generator().manual_seed(5)).state_dict(), files["vgg"])
    torch.save(CLIP(rng=torch.Generator().manual_seed(6)).state_dict(), files["clip"])
    n_latent = int(math.log2(SIZE)) * 2 - 2
    for key, cls in (("mapper", FullSpaceMapperFEATClusterLinStyle),
                     ("mapper_wplus", FullSpaceMapperFEATClusterLin)):
        m = cls(layers=n_latent, attention_layer=ATTENTION_LAYER,
                cluster_layer=ATTENTION_LAYER, generator_size=SIZE,
                rng=torch.Generator().manual_seed(7))
        with torch.no_grad():
            m.initial_state.copy_(torch.randn(m.initial_state.shape,
                                              generator=torch.Generator().manual_seed(8)))
        torch.save(m.state_dict(), files[key])
    return files


def quiet(fn, *args, **kw):
    """``fn``'s value, its standard output kept from the run's."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def device_flag() -> list:
    return ["--device", "cpu"] if DEV == "cpu" else []


def phase_validate_export(card: str, work: str, gan_ckpt: str) -> dict:
    """19: ``cli/validate.main`` on random full-size files (every model, the
    S-space mapper; then the W+ mapper) on the card, with the counters at 0
    before: ``ok``, every gate with the CPU-plain oracle (the card's
    machine has no reference repo), K1 and K3 launches per validator
    (g_ema: 9 fp32 and 9 bf16 each; the mapper's capture: K1 9); then
    ``cli/export_weights.main --with_latent_avg 4096`` on phase 8's
    checkpoint: the export loads strictly into the port's Generator (g,
    g_ema) and Discriminator, and its ``g_ema`` synthesises bitwise what the
    checkpoint's does. Stages timed with ``utils/profiling.StageTimer``.
    Returns {path: launch forms}."""
    timer = StageTimer()
    with timer.stage("write_files"):
        files = validate_files(work)
    sizes_mb = {k: os.path.getsize(p) / 2 ** 20 for k, p in files.items()}
    flags = ["--stylegan_size", str(SIZE), "--attention_layer", str(ATTENTION_LAYER),
             *device_flag()]
    zero_counters()
    span = CountingSpan(timer)
    out = os.path.join(work, "validate.json")
    rc = quiet(validate.main, [*flags, "--out", out, *[
        a for name in ("g_ema", "e4e", "ir_se50", "vgg", "clip", "mapper")
        for a in (f"--{name}", files[name])]], span=span)
    with open(out) as f:
        report = json.load(f)
    wplus_span = CountingSpan(timer, "wplus_")
    rc_w = quiet(validate.main, [*flags, "--out", out, "--mapper", files["mapper_wplus"],
                                 "--mapper_kind", "wplus"], span=wplus_span)
    with open(out) as f:
        report["mapper_wplus"] = json.load(f)["mapper"]
    launches = {**span.launches, **wplus_span.launches}
    validate_forms = {k: {f: sum(v[k][f] for v in launches.values()) for f in ("fp32", "bf16")}
                      for k in COUNTERS}
    gates = {k: v.get("checks", v) for k, v in report.items() if k != "_summary"}
    emit({"phase": "validate", "card": card, "size": SIZE, "rc": [rc, rc_w],
          "summary": report["_summary"], "gates": gates,
          "statuses": {k: v["status"] for k, v in report.items() if k != "_summary"},
          "launches_per_validator": launches, "file_mb": sizes_mb,
          "stage_ms": {k: v for k, v in timer.ms().items() if k.startswith("validate")}})
    check(rc == 0 and rc_w == 0 and report["_summary"]["ok"]
          and report["_summary"]["pass"] == 6, f"validate: {report['_summary']}, "
                                                f"{ {k: v.get('error') for k, v in report.items()} }")
    check(report["mapper_wplus"]["status"] == "pass", f"W+ mapper: {report['mapper_wplus']}")
    k1k3 = ("modconv3x3", "modconv1x1")
    if DEV != "cpu":
        check(all(gates[k]["oracle"] in ("cpu-plain", "reference") for k in
                  ("g_ema", "e4e", "ir_se50", "clip", "mapper", "mapper_wplus")),
              f"validate oracles: { {k: g.get('oracle') for k, g in gates.items()} }")
        want = {"fp32": 9, "bf16": 9}
        check(all(launches["g_ema"][k] == want for k in k1k3),
              f"validate g_ema launches {launches['g_ema']}, expected {want} of K1 and K3")
        check(launches["mapper"]["modconv3x3"]["fp32"] == 9
              and launches["mapper"]["modconv1x1"]["fp32"] > 9,
              f"validate mapper launches {launches['mapper']}")

    # --- export_weights on phase 8's checkpoint ---
    zero_counters()
    exported = os.path.join(work, "exported.pt")
    with timer.stage("export"):
        quiet(export_weights.main, ["--ckpt", gan_ckpt, "--out", exported,
                                    "--with_latent_avg", "4096", *device_flag()])
    export_forms = launch_forms()
    with timer.stage("export_load"):
        exp = torch.load(exported, map_location="cpu", weights_only=True)
        ck = torch.load(gan_ckpt, map_location="cpu", weights_only=True)
        check(set(exp) == {"g", "g_ema", "d", "latent_avg"}, f"export keys {sorted(exp)}")
        gens = {}
        for name, sd in (("export", exp["g_ema"]), ("checkpoint", ck["g_ema"])):
            gens[name] = Generator(SIZE)
            gens[name].load_state_dict(sd)  # strict
        Generator(SIZE).load_state_dict(exp["g"])
        Discriminator(SIZE).load_state_dict(exp["d"])
    check(exp["latent_avg"].shape == (512,) and bool(torch.isfinite(exp["latent_avg"]).all()),
          f"latent_avg {tuple(exp['latent_avg'].shape)}")
    same = {name: all(torch.equal(exp[name][k], ck[name][k]) for k in ck[name])
            and set(exp[name]) == set(ck[name]) for name in ("g", "g_ema", "d")}
    z = torch.randn(2, 512, generator=torch.Generator().manual_seed(9)).to(DEV)
    images = {}
    deterministic = torch.backends.cudnn.deterministic
    # cuDNN's default transposed convs and blurs sum with atomics: two runs
    # of one synthesis differ in the last bits unless deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with timer.stage("export_resynth"):
            for name, g in gens.items():
                g = g.to(DEV).eval()
                with torch.no_grad():
                    images[name] = g([z], randomize_noise=False).image
    finally:
        torch.backends.cudnn.deterministic = deterministic
    bitwise = torch.equal(images["export"], images["checkpoint"])
    emit({"phase": "export_weights", "card": card, "size": SIZE, "latent_avg_n": 4096,
          "export_mb": os.path.getsize(exported) / 2 ** 20, "tensors_bitwise": same,
          "bitwise_g_ema_synthesis": bitwise, "launches": export_forms,
          "stage_ms": {k: v for k, v in timer.ms().items() if k.startswith("export")},
          "report": timer.report().splitlines()})
    check(all(same.values()), f"the export's tensors differ from the checkpoint's: {same}")
    check(bitwise, "the export's g_ema does not synthesise the checkpoint's image")
    del gens, images, exp, ck
    return {"validate": validate_forms, "export_weights": export_forms}


SP_NS = (2, 4)
SPLIT_REL_TOL = 1e-5  # a banded or sliced synthesis against the whole one


def split_generator(seed: int = 11) -> Generator:
    """A seeded 1024² generator with non-zero noise gains and biases."""
    g = live_epilogue(Generator(SIZE, rng=torch.Generator().manual_seed(seed)), seed + 1)
    return g.to(DEV).eval().requires_grad_(False)


def split_launches(g: Generator, n_sp: int = 0) -> dict:
    """(K1, K3) launches of one synthesis as the architecture gives them:
    one per layer, one per band in a banded octave (``n_sp`` bands), one per
    part in a TP-split layer."""
    def calls(m):
        return m.tp.n if m.tp is not None else 1

    k1_n = calls(g.conv1.conv)
    k3_n = calls(g.to_rgb1.conv)
    for oct_idx, to_rgb in enumerate(g.to_rgbs):
        bands = n_sp if n_sp and banded(InProcess(n_sp), 2 ** (oct_idx + 3)) else 1
        k1_n += bands * calls(g.convs[2 * oct_idx + 1].conv)
        k3_n += bands * calls(to_rgb.conv)
    return {"modconv3x3": k1_n, "modconv1x1": k3_n}


def compare_split(got, want) -> dict:
    """Bitwise, else max |Δ| over image and taps against 1e-5 of max |whole|."""
    pairs = [(got.image, want.image)] + [
        (a, b) for a, b in zip(got.feature_map, want.feature_map) if b is not None]
    bitwise = all(torch.equal(a, b) for a, b in pairs)
    rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)
              for a, b in pairs)
    return {"bitwise": bitwise, "max_rel_err": rel}


def _sp_nccl_worker(path: str) -> None:
    """A rank of phase 20's NCCL form: the banded synthesis over the group,
    one band per card; rank 0 saves the image."""
    saved = torch.load(path, map_location="cpu", weights_only=False)
    g = Generator(SIZE)
    g.load_state_dict(saved["g"])
    g = g.cuda().eval().requires_grad_(False)
    g.spatial = SpatialGroup()
    move = lambda t: None if t is None else t.cuda()  # noqa: E731
    with torch.no_grad():
        out = g([saved["w"].cuda()], input_is_latent=True, randomize_noise=False,
                return_features=True, tap_subsample=saved["sub"],
                tap_indices=saved["keep"], attention_layer=ATTENTION_LAYER,
                attention_map=saved["amap"].cuda(),
                feature_map=[move(f) for f in saved["feats"]])
    if dist.is_main():
        torch.save(out.image.cpu(), path + ".out")


def split_ops_probe(g: Generator, n: int = 2) -> dict:
    """Why a banded or sliced synthesis is not bitwise: each op of every
    banded octave alone, band 0 of ``n`` (its rows plus one halo row)
    against the same rows of the whole op, and K1 on a Cout/n slice against
    the whole call's channels, bitwise or not; K1's split-K counts for the
    whole, the band and the slice shapes."""
    out = {}
    rng = torch.Generator().manual_seed(13)

    def rand(*shape):
        return torch.randn(*shape, generator=rng).to(DEV)

    for oct_idx, to_rgb in enumerate(g.to_rgbs):
        res = 2 ** (oct_idx + 3)
        if not banded(InProcess(n), res):
            continue
        up, conv = g.convs[2 * oct_idx].conv, g.convs[2 * oct_idx + 1].conv
        rows = res // n
        rec = {}
        with torch.no_grad():
            x, s = rand(1, res // 2, res // 2, up.in_channel), rand(1, up.in_channel)
            whole, _ = up(x, s, True)
            band, _ = up(x[:, :rows // 2 + 1], s, True)
            rec["upconv"] = torch.equal(band[:, :rows], whole[:, :rows])
            skip = rand(1, res // 2, res // 2, 3)
            whole = to_rgb.upsample(skip)
            rec["skip_upsample"] = torch.equal(
                to_rgb.upsample(skip[:, :rows // 2 + 1])[:, :rows], whole[:, :rows])
            y, s = rand(1, res, res, conv.in_channel), rand(1, conv.in_channel)
            whole, _ = conv(y, s, True)
            rec["k1"] = torch.equal(conv(y[:, :rows + 1], s, True)[0][:, :rows],
                                    whole[:, :rows])
            wk, w2, _ = conv.prepared_weight(torch.float32)
            demod = torch.rsqrt(s.square() @ w2.t() + 1e-8)
            c = conv.out_channel // n
            full = k1.modconv3x3(y, conv.scale * s, wk, demod)
            part = k1.modconv3x3(y, conv.scale * s, wk[..., :c].contiguous(),
                                 demod[:, :c].contiguous())
            rec["k1_cout_slice"] = torch.equal(part, full[..., :c])
            rgb, _ = to_rgb.conv(y, s, True)
            rec["k3"] = torch.equal(to_rgb.conv(y[:, :rows], s, True)[0], rgb[:, :rows])
        if DEV != "cpu":
            idx = torch.cuda.current_device()
            cin, cout = conv.in_channel, conv.out_channel
            rec["k1_splits_whole_band_slice"] = [
                common.split_count("modconv3x3", 1, res, res, cin, cout, idx),
                common.split_count("modconv3x3", 1, rows + 1, res, cin, cout, idx),
                common.split_count("modconv3x3", 1, res, res, cin, c, idx)]
        out[res] = rec
    return out


def phase_sp_tp(card: str, work: str) -> dict:
    """20: the 1024² synthesis at batch 1 with the capture taps and the
    layer-13 blend (``EditSession``'s tap controls), banded over n = 2 and
    4 in-process (``parallel/sp.py::InProcess``) and TP-split over n = 2
    and 4 (``parallel/tp.py``, ``min_channels`` 64), each with the counters
    at 0: held against the whole synthesis under ``cudnn.deterministic``
    (bitwise, else max |Δ| within 1e-5 of max |whole|; ``split_ops_probe``
    says which op is not bitwise), K1 and K3 launches exactly those the architecture
    gives, ms against the whole synthesis's; TP with SP raises; one
    ``EditSession`` capture and edit through a banded generator against the
    whole one, its launches exactly two banded syntheses' and the mapper's
    K3 calls (the whole edit's less its two syntheses'); with more than one card, the banded synthesis over an NCCL
    group, one band per card. Returns {path: launch forms}."""
    g = split_generator()
    sub, keep = tap_controls(SIZE, ATTENTION_LAYER, ATTENTION_LAYER)
    rng = torch.Generator().manual_seed(12)
    with torch.no_grad():
        wa, wb = (g.style_mlp(torch.randn(1, 512, generator=rng).to(DEV))[:, None]
                  .expand(-1, g.n_latent, -1).contiguous() for _ in range(2))
        feats = g([wa], input_is_latent=True, randomize_noise=False,
                  return_features=True, tap_subsample=sub, tap_indices=keep).feature_map
    amap = torch.rand(1, 64, 64, 1, generator=rng).to(DEV)

    def synth(gen):
        with torch.no_grad():
            return gen([wb], input_is_latent=True, randomize_noise=False,
                       return_features=True, tap_subsample=sub, tap_indices=keep,
                       attention_layer=ATTENTION_LAYER, attention_map=amap,
                       feature_map=feats)

    deterministic = torch.backends.cudnn.deterministic

    def timed(fn):
        """ms of ``fn`` on cuDNN's default algorithms, as the edit runs."""
        torch.backends.cudnn.deterministic = deterministic
        try:
            return time_ms(fn)
        finally:
            torch.backends.cudnn.deterministic = True

    whole = synth(g)
    torch.backends.cudnn.deterministic = True  # no atomics in cuDNN's sums
    whole_det = synth(g)
    repeat = compare_split(synth(g), whole_det)
    recs = {"whole": {"ms": timed(lambda: synth(g)), "launches": split_launches(g),
                      "repeat_deterministic": repeat,
                      "default_vs_deterministic": compare_split(whole, whole_det)}}
    whole = whole_det
    forms = {}
    for n in SP_NS:
        g.spatial = InProcess(n)
        zero_counters()
        got = synth(g)
        forms[f"sp_{n}"] = launch_forms()
        want = split_launches(g, n)
        recs[f"sp_{n}"] = {**compare_split(got, whole), "launches": want,
                           "ms": timed(lambda: synth(g))}
        g.spatial = None
    for n in SP_NS:
        gt = shard_generator_params(InProcess(n), split_generator(), min_channels=64)
        zero_counters()
        got = synth(gt)
        forms[f"tp_{n}"] = launch_forms()
        want = split_launches(gt)
        recs[f"tp_{n}"] = {**compare_split(got, whole), "launches": want,
                           "split_layers": gt.tp_layers, "ms": timed(lambda: synth(gt))}
        if n == SP_NS[0]:
            gt.spatial = InProcess(2)
            try:
                synth(gt)
                raised = False
            except ValueError:
                raised = True
        del gt
    probe = split_ops_probe(g)
    # one EditSession capture and edit through a banded generator
    session = build_session(SIZE, device=DEV)
    toks = np.asarray(tokenize(["grey hair", "blonde hair"]))
    zero_counters()
    session.load_synthetic(3)
    img_whole, map_whole = session.edit(toks[:1], toks[1:])
    whole_edit = launch_totals(launch_forms())
    session.generator.spatial = InProcess(2)
    zero_counters()
    session.load_synthetic(3)
    img_sp, map_sp = session.edit(toks[:1], toks[1:])
    forms["sp_edit"] = launch_forms()
    # a capture and an edit: two syntheses, each banded, and the mapper's
    # K3 calls (the whole edit's less its two syntheses')
    per_synth = split_launches(session.generator)
    banded_synth = split_launches(session.generator, 2)
    mapper_k3 = whole_edit["modconv1x1"] - 2 * per_synth["modconv1x1"]
    edit_want = {"modconv3x3": 2 * banded_synth["modconv3x3"],
                 "modconv1x1": 2 * banded_synth["modconv1x1"] + mapper_k3}
    edit_rel = float((img_sp - img_whole).abs().max()) / float(img_whole.abs().max())
    edit_rec = {"bitwise": torch.equal(img_sp, img_whole) and torch.equal(map_sp, map_whole),
                "image_max_rel_err": edit_rel,
                "map_max_abs_err": float((map_sp - map_whole).abs().max()),
                "launches_whole": whole_edit, "launches_want": edit_want,
                "launches": {k: launch_totals(forms["sp_edit"])[k] for k in edit_want},
                "mapper_k3": mapper_k3}
    del session
    torch.backends.cudnn.deterministic = deterministic
    multi = "not run: one card"
    if DEV != "cpu" and torch.cuda.device_count() > 1:
        path = os.path.join(work, "sp_nccl.pt")
        torch.save({"g": {k: v.cpu() for k, v in g.state_dict().items()}, "w": wb.cpu(),
                    "amap": amap.cpu(), "sub": sub, "keep": keep,
                    "feats": [None if f is None else f.cpu() for f in feats]}, path)
        n = 2
        dist.launch(_sp_nccl_worker, n, "cuda", path)
        img = torch.load(path + ".out", weights_only=True)
        multi = {"world": n, "bitwise": torch.equal(img, whole.image.cpu()),
                 "max_rel_err": float((img - whole.image.cpu()).abs().max())
                 / float(whole.image.abs().max())}
    emit({"phase": "sp_tp", "card": card, "size": SIZE, "batch": 1,
          "attention_layer": ATTENTION_LAYER, "paths": recs, "launch_forms": forms,
          "tp_with_sp_raised": raised, "sp_edit": edit_rec, "multi_card": multi,
          "ops_bitwise_band0_of_2": probe})
    for name, rec in recs.items():
        if name == "whole":
            continue
        got = {k: v for k, v in launch_totals(forms[name]).items() if k in rec["launches"]}
        if DEV != "cpu":
            check(got == rec["launches"], f"{name}: launches {got}, expected {rec['launches']}")
        check(rec["bitwise"] or rec["max_rel_err"] <= SPLIT_REL_TOL,
              f"{name}: max rel err {rec['max_rel_err']}")
    check(raised, "TP with SP did not raise")
    if DEV != "cpu":
        check(whole_edit["modconv3x3"] == 2 * per_synth["modconv3x3"] and mapper_k3 > 0,
              f"whole edit launches {whole_edit}, expected K1 {2 * per_synth['modconv3x3']} "
              f"and the mapper's K3 on top of {2 * per_synth['modconv1x1']}")
        check(edit_rec["launches"] == edit_want,
              f"sp_edit: launches {edit_rec['launches']}, expected {edit_want}")
    check(edit_rec["bitwise"] or (edit_rel <= SPLIT_REL_TOL
                                  and edit_rec["map_max_abs_err"] <= WHOLE_MAP_ABS_TOL),
          f"sp_edit: {edit_rec}")
    if isinstance(multi, dict):
        check(multi["bitwise"] or multi["max_rel_err"] <= SPLIT_REL_TOL, f"NCCL SP: {multi}")
    return forms


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
        with tempfile.TemporaryDirectory() as work:
            totals = phase_kernels()
            totals_bf16 = phase_kernels_bf16()
            totals_k5 = phase_kernels_k5()
            totals_k4 = phase_kernels_k4()
            train_fwd_err, backward_err = phase_backward()
            backward_bf16_err = phase_backward_bf16()
            edit_launches, session, s_per_edit, s_p50 = phase_slice()
            phase_profile(session, card)
            whole = phase_whole()
            wplus_launches, wplus_p50 = phase_wplus_edit(session, s_per_edit, whole, card)
            del whole
            server_launches = phase_server(session, card,
                                           {"s_space": s_p50, "wplus": wplus_p50})
            invert_launches, psp, ckpt, x1, faces = phase_invert(session, card, work)
            del session
            phase_invert_whole(psp, ckpt, x1)
            del psp, ckpt
            train_launches_run, backward_launches, trainer, fp32_peak = phase_train(card)
            phase_train_profile(trainer, card)
            gan_ckpt = save_gan_checkpoint(trainer, work)
            del trainer
            phase_train_whole()
            bf16_launches = {}
            bf16_launches["train_bf16"], trainer = phase_train_bf16(card, work, fp32_peak)
            del trainer
            bf16_launches["train_levers"] = phase_train_levers(card)
            with tempfile.TemporaryDirectory() as keep:
                cluster_launches, cluster_path = phase_cluster(card, keep)
                attention_run, attention_backward, trainer, final_path = phase_attention(
                    card, cluster_path, keep)
                phase_attention_profile(trainer, card)
                del trainer
                torch.cuda.empty_cache()
                phase_attention_whole()
                load_launches = phase_mapper_load(card, final_path)
                wplus_train_launches = phase_wplus_train(card, cluster_path)
                bf16_launches["attention_bf16"] = phase_attention_bf16(card, cluster_path)
            eval_launches = {"evaluate_edits": phase_evaluate_edits(card, work),
                             "evaluate_iou": phase_evaluate_iou(card, work, faces)}
            phase_evaluate_whole(card, work)
            eval_launches["train_fid"] = phase_train_fid(card, work)
            styleclip_run, styleclip_backward, coach, exp_dir = phase_styleclip_train(
                card, work)
            styleclip = {"styleclip_train": styleclip_run,
                         "styleclip_stylespace": phase_styleclip_stylespace(card, work)}
            styleclip["styleclip_inference"] = phase_styleclip_inference(
                card, work, coach, exp_dir)
            del coach
            phase_styleclip_whole(card, work)
            bf16_launches["styleclip_bf16"] = phase_styleclip_bf16(card, work)
            phase_bf16_whole(card, work)
            dp_launches = phase_dp(card, work)
            dp_bf16 = dp_launches.pop("train_bf16")
            bf16_launches["dp_train_bf16"] = {name: dp_bf16[name]["bf16"]
                                              for name in COUNTERS}
            split_launches_run = phase_validate_export(card, work, gan_ckpt)
            os.remove(gan_ckpt)
            torch.cuda.empty_cache()
            split_launches_run.update(phase_sp_tp(card, work))
            bf16_launches["validate"] = {name: split_launches_run["validate"][name]["bf16"]
                                         for name in COUNTERS}
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
    def fp32_paths(name: str) -> dict:
        """``name``'s launches in each fp32 main path's run."""
        return {"edit": edit_launches[name],
                "wplus_edit": wplus_launches[name], "server": server_launches[name],
                "invert": invert_launches[name],
                "train": train_launches_run[name], "cluster": cluster_launches[name],
                "attention": attention_run[name], "mapper_load": load_launches[name],
                "wplus_train": wplus_train_launches[name],
                **{path: got[name] for path, got in eval_launches.items()},
                **{path: got[name] for path, got in styleclip.items()},
                **{f"dp_{path}": got[name]["fp32"] for path, got in dp_launches.items()},
                **{path: got[name]["fp32"] for path, got in split_launches_run.items()}}

    kernels = []
    for name, (src, replaces) in sources.items():
        tot = totals[name]
        by_path = fp32_paths(name)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "train_backward_launches": backward_launches[name],
            "attention_backward_launches": attention_backward[name],
            "styleclip_backward_launches": styleclip_backward[name],
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
                    "launches: the edit path's run (phase 5), the W+ edit's "
                    "(phase 7c), the web demo's requests (phase 7d), the "
                    "real-photo path's (phase 7a), the training run's (phase "
                    "8), of which train_backward_launches inside backward "
                    "passes, the k-means CLI's (phase 11), the attention "
                    "trainer's CLI run (phase 12), of which "
                    "attention_backward_launches inside backward passes, "
                    "the --mapper loads' edits (phase 14a), the W+ "
                    "trainer's 1024² CLI run (phase 14b), cli/evaluate.py's "
                    "edits and iou runs (phases 15a, 15b), the trainer's "
                    "run with --fid_every (phase 15d), the StyleCLIP coach's "
                    "W+ and S-space CLI runs (phases 16a styleclip_train, of "
                    "which styleclip_backward_launches inside backward "
                    "passes, and 16b styleclip_stylespace) and "
                    "cli/mapper_inference.py's run (phase 16c "
                    "styleclip_inference), phase 18's runs of the five CLIs in "
                    "a data-parallel group of one (dp_*), cli/validate.py's and "
                    "cli/export_weights.py's runs (phase 19: validate, "
                    "export_weights) and phase 20's banded (sp_2, sp_4), "
                    "TP-split (tp_2, tp_4) and banded EditSession (sp_edit) runs"})
    for name, (src, replaces) in sources.items():
        tot = totals_bf16[BF16_NAMES[name]]
        by_path = {path: got[name] for path, got in bf16_launches.items()}
        kernels.append({
            "name": BF16_NAMES[name], "route": "cuda",
            "source": (src if name == "modconv1x1"
                       else "where2edit_tpu_torch/csrc/conv3x3_bf16.cuh"),
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": tot["max_abs_err"],
            "max_rel_err": tot["max_rel_err"],
            **({"backward_max_rel_l2": backward_bf16_err[BF16_NAMES[name]]}
               if BF16_NAMES[name] in backward_bf16_err else {}),
            "ms": tot["ms"], "device_ms": tot["device_ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if tot["bytes_s"] >= tot["ops_s"] else "operations",
            "library_ms": tot["library_ms"],
            "library_device_ms": tot["library_device_ms"],
            "core": ("tensor cores (wgmma), bf16 products, fp32 sums: the persistent, "
                     "warp-specialised TMA + wgmma core csrc/conv3x3_bf16.cuh"
                     if name != "modconv1x1"
                     else "the persistent, warp-specialised TMA streaming kernel of "
                     "csrc/modconv1x1.cu: bf16 outputs on the tensor cores (wgmma, the fp32 "
                     "style-weight fold in bf16 parts), the ToRGBs' fp32 outputs on the FMA "
                     "units in the FMA kernel's order, fp32 sums"),
            "note": "the bf16 form (phase 3b): ms, device_ms, plain_ms, bound_ms, "
                    "library_ms: sums over "
                    + ("the 1024² trainer's 9 shapes at batch 8" if name == "modconv3x3"
                       else "the 1024² discriminator's shapes at batch 8"
                       if name == "conv3x3" else
                       "the bf16 trainers' shapes: the 9 ToRGBs at batch 8 and 2 "
                       "with fp32 out, the attention trainer's 18 mapper convs at "
                       "batch 8 with bf16 out")
                    + "; bound_ms at 2 bytes per bf16 value and the bf16 tensor cores' "
                    "989 TFLOP/s"
                    + "; library_ms: cuDNN F.conv2d (K3: the einsum) in bf16 plus the "
                    "epilogue; launches: the bf16 trainer runs (phases 17a train_bf16, "
                    "17b train_levers, 17c attention_bf16 and styleclip_bf16), the "
                    "bf16 GAN run in a data-parallel group of one (phase 18, "
                    "dp_train_bf16) and cli/validate.py's bf16 synthesis of g_ema "
                    "(phase 19, validate)"})
    for name in ("upfirdn2d", "upfirdn2d_bf16"):
        tot = totals_k5[name]
        by_path = (fp32_paths("upfirdn2d") if name == "upfirdn2d"
                   else {path: got["upfirdn2d"] for path, got in bf16_launches.items()})
        kernels.append({
            "name": name, "route": "cuda", "source": "where2edit_tpu_torch/csrc/upfirdn2d.cu",
            "replaces": "none: where2edit_tpu/ops/upfirdn2d.py is left to XLA (the port ran "
                        "a stuffed and padded copy through cuDNN's depthwise conv)",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": tot["max_abs_err"], "max_rel_err": tot["max_rel_err"],
            "ms": tot["ms"], "device_ms": tot["device_ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if tot["bytes_s"] >= tot["ops_s"] else "operations",
            "library_ms": tot["library_ms"], "library_device_ms": tot["library_device_ms"],
            "core": "fp32 FMA units, 16-byte channel vectors a thread (one value a thread "
                    "where C is not a multiple of the vector), rows slid through registers",
            "note": "phase 3c: ms, device_ms, plain_ms, bound_ms, library_ms: sums over every "
                    "upfirdn2d call site of the 1024² generator and discriminator at batch 8 "
                    + ("(bar the fp32 ToRGB skip) in bf16" if name == "upfirdn2d_bf16"
                       else "in fp32")
                    + ", one call each; library_ms: cuDNN's depthwise conv on the stuffed, "
                    "padded input, never called by the port; launches: "
                    + ("the fp32 main paths' runs, as K1's" if name == "upfirdn2d"
                       else "the bf16 runs, as K1-bf16's")
                    + ", each with the counters set to 0 just before it"})
    by_path = fp32_paths("upconv")
    kernels.append({
        "name": "upconv", "route": "cuda", "source": "where2edit_tpu_torch/csrc/upconv.cu",
        "replaces": "none: where2edit_tpu/nn/layers.py::_conv_transpose2x is left to XLA (the "
                    "port ran the modulation, cuDNN's fp32 conv_transpose2d and the demod pass)",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": totals_k4["max_abs_err"], "max_rel_err": totals_k4["max_rel_err"],
        **{k: totals_k4[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_share",
                                     "library_ms", "library_device_ms")},
        "bound_by": "bytes" if totals_k4["bytes_s"] >= totals_k4["ops_s"] else "operations",
        "core": "tensor cores (wgmma), 3xTF32, the four sub-pixel phases of the transposed "
                "conv as implicit GEMMs in one launch, one output tile a block, the heaviest "
                "phase's tiles first (csrc/upconv.cu on csrc/conv3x3_tc.cuh)",
        "note": "phase 3d: ms, device_ms, plain_ms, bound_ms, library_ms: sums over the 1024² "
                "generator's eight up-convs at batch 8, one call each; library_ms: cuDNN's "
                "conv_transpose2d on the modulated input and the demod multiply, never called "
                "by the port; launches: the fp32 main paths' runs, as K1's, each with the "
                "counters set to 0 just before it"})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

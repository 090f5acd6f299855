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
   register / shared-memory report.
3. kernels — every shape the 1024² edit path gives K1 (``modconv3x3``) and
   K3 (``modconv1x1``) at batch 1: the kernel against its plain PyTorch
   version on the same inputs (fp32, max |Δ| / max |plain| <= 1e-4), the
   kernel's, the plain version's and a library call's time (CUDA events
   around eager calls back to back), the kernel's device time alone (calls
   replayed from a CUDA graph), and the bound: max(bytes / 3.35 TB/s,
   FLOP / 67 TFLOP/s fp32).
4. slice   — the edit path at full width (1024², 18 W+ rows, 26 taps,
   seeded random weights): one seeded face, three edits and one 2-prompt
   sweep through ``EditSession``, with the launch counters set to 0 just
   before and read just after (K1 +9 and K3 +9 per capture, K1 +9 and
   K3 +28 per edit); then the p50 edit latency and its stage split.
5. profile — phase 4's session runs 5 more edits under ``torch.profiler``:
   wall and device-busy ms per edit (the profiler's own cost is inside that
   wall time), the device's idle share, kernel launches per edit, device
   busy time inside each stage, device time by kernel category and by
   kernel.
6. whole   — the same seeded session at 256² on the card (kernels) and on
   the CPU (plain versions), from the same W+ and prompts.
7. the ``kernels`` summary line, then the last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import torch
import torch.nn.functional as F

from where2edit_tpu_torch.demo.app import build_session
from where2edit_tpu_torch.editing.attention_mappers import (
    attention_tables,
    tap_resolution,
)
from where2edit_tpu_torch.kernels import common
from where2edit_tpu_torch.kernels import modconv1x1 as k3
from where2edit_tpu_torch.kernels import modconv3x3 as k1
from where2edit_tpu_torch.models.clip_tokenizer import tokenize
from where2edit_tpu_torch.models.stylegan2 import channel_table

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, fp32 outside tensor cores
SIZE, ATTENTION_LAYER = 1024, 13
KERNEL_REL_TOL = 1e-4
# Whole-path tolerance, card against CPU at 256²: both run fp32 (TF32 off),
# but every conv sums in another order, through 12 synthesis layers twice
# (capture, then edit). 1e-3 of the image's largest magnitude is well under
# one 8-bit level (2/255 of the [-1, 1] range); the attention map is a
# sigmoid pooled over clusters, 1e-4 absolute.
WHOLE_IMAGE_REL_TOL = 1e-3
WHOLE_MAP_ABS_TOL = 1e-4

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


def bound(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
                            if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "arch": "sm_90a", "seconds": seconds,
          "wall_s": wall, "ptxas": report})


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions at the main path's shapes
# ---------------------------------------------------------------------------

def k1_shapes():
    ch = channel_table(2)
    return [(r, ch[r], ch[r]) for r in (4, 8, 16, 32, 64, 128, 256, 512, 1024)]


def k3_shapes():
    """(name, res, Cin, Cout, demod_act_noise, residual): the 9 ToRGBs, then
    the mapper's attention_first, 17 tap convs and attention_last."""
    ch = channel_table(2)
    blend = tap_resolution(ATTENTION_LAYER)
    shapes = [(f"to_rgb_{r}", r, ch[r], 3, False, r > 4)
              for r in (4, 8, 16, 32, 64, 128, 256, 512, 1024)]
    tab = attention_tables(SIZE)
    shapes.append(("attention_first", 4, ch[4], 32, True, False))
    for c in tab["layer_num"]:
        r = min(tap_resolution(c + 1), blend)
        shapes.append((f"attention_{c}", r, tab["tap_channels"][c], 32, True, False))
    shapes.append(("attention_last", blend, 32 * tab["n_latent"], 1, True, False))
    return shapes


def phase_kernels() -> dict:
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    totals = {k: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "bound_ms": 0.0,
                  "bytes_s": 0.0, "ops_s": 0.0, "max_abs_err": 0.0,
                  "max_rel_err": 0.0} for k in ("modconv3x3", "modconv1x1")}

    def add(name, rec):
        tot = totals[name]
        for key in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms"):
            tot[key] += rec[key]
        tot["bytes_s" if rec["bound_by"] == "bytes" else "ops_s"] += rec["bound_ms"]
        tot["max_abs_err"] = max(tot["max_abs_err"], rec["max_abs_err"])
        tot["max_rel_err"] = max(tot["max_rel_err"], rec["max_rel_err"])
        emit({"phase": "kernels", "kernel": name, **rec})

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
        torch.cuda.synchronize()
        abs_err, rel = rel_err(got, want)
        check(rel <= KERNEL_REL_TOL, f"modconv3x3 {res}² {cin}->{cout}: rel {rel}")
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
               "plain_ms": time_ms(lambda: k1.modconv3x3_plain(*args)),
               "library_ms": time_ms(library)}
        nbytes = 4 * (x.numel() + style.numel() + w.numel() + demod.numel()
                      + noise.numel() + 1 + bias.numel() + got.numel())
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 2 * res * res * cin * cout * 9)
        add("modconv3x3", rec)
        del x, w, got, want, w_lib

    for name, res, cin, cout, styled, has_res in k3_shapes():
        p = res * res
        x, s, w = randn(1, p, cin), randn(1, cin), randn(cin, cout)
        scale = 1.0 / math.sqrt(cin)
        style = (scale * s).contiguous()
        demod = (torch.rsqrt(s.square() @ (scale * w).square() + 1e-8)
                 if styled else None)
        noise, nw = (randn(1, p), randn(1)) if styled else (None, None)
        bias = randn(cout)
        residual = randn(1, p, cout) if has_res else None
        args = (x, style, w, demod, noise, nw, bias, styled, residual)
        got = k3.modconv1x1(*args)
        want = k3.modconv1x1_plain(*args)
        torch.cuda.synchronize()
        abs_err, rel = rel_err(got, want)
        check(rel <= KERNEL_REL_TOL, f"modconv1x1 {name}: rel {rel}")
        w_lib = style[0][:, None] * w * (demod[0][None, :] if styled else 1.0)

        def library():
            y = torch.einsum("pi,io->po", x[0], w_lib)
            if styled:
                y.add_(nw * noise[0][:, None]).add_(bias)
                return F.leaky_relu_(y, 0.2).mul_(math.sqrt(2.0))
            y.add_(bias)
            return y if residual is None else y.add_(residual[0])

        rec = {"shape": f"{name} {res}x{res} {cin}->{cout}",
               "max_abs_err": abs_err, "max_rel_err": rel,
               "ms": time_ms(lambda: k3.modconv1x1(*args)),
               "device_ms": graph_ms(lambda: k3.modconv1x1(*args)),
               "plain_ms": time_ms(lambda: k3.modconv1x1_plain(*args)),
               "library_ms": time_ms(library)}
        nbytes = 4 * sum(t.numel() for t in (x, style, w, demod, noise, nw, bias,
                                             residual, got) if t is not None)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 2 * p * cin * cout)
        add("modconv1x1", rec)
    return totals


# ---------------------------------------------------------------------------
# phase 4: the 1024² edit path through the kernels
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
        before = counts()
        img, amap = session.edit(tokenize([prompt]), tokenize([att]),
                                 strength_alpha=strength, attention_threshold=thr)
        torch.cuda.synchronize()
        check_edit(img, amap, 1)
        expect(before, *per_edit, f"edit {prompt!r}")
    before = counts()
    img, amap = session.edit(tokenize([p[0] for p in PROMPTS[:2]]),
                             tokenize([p[1] for p in PROMPTS[:2]]))
    torch.cuda.synchronize()
    check_edit(img, amap, 2)
    expect(before, *per_edit, "2-prompt sweep")
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
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(rec)
    return launches, session


# ---------------------------------------------------------------------------
# phase 5: where the time of an edit goes
# ---------------------------------------------------------------------------

# kernel-name substrings -> category, first match wins
CATEGORIES = (
    ("K1 modconv3x3", ("modconv3x3",)),
    ("K3 modconv1x1", ("modconv1x1",)),
    ("cuDNN depthwise conv (blurs)", ("conv2d_grouped",)),
    ("cuDNN transposed conv (up-conv)", ("dgrad",)),
    ("cuDNN other", ("cudnn",)),
    ("GEMM / GEMV", ("gemm", "gemv")),
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


def phase_profile(session, card: str, edits: int = 5) -> None:
    from torch.profiler import ProfilerActivity, profile, record_function  # noqa: PLC0415

    toks, att = tokenize([PROMPTS[0][0]]), tokenize([PROMPTS[0][1]])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(edits):
            staged_edit(session, toks, att, record_function)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [e for e in cuda if e.name in STAGES]
    kernels = [e for e in cuda if e.name not in STAGES
               and not getattr(e, "is_user_annotation", False)]
    intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy_us = _union_us(intervals)
    stage_busy = dict.fromkeys(STAGES, 0.0)
    for span in spans:
        lo, hi = span.time_range.start, span.time_range.end
        stage_busy[span.name] += _union_us(
            (max(s, lo), min(e, hi)) for s, e in intervals if s < hi and e > lo)
    by_name, by_cat = defaultdict(lambda: [0.0, 0]), defaultdict(lambda: [0.0, 0])
    for e in kernels:
        low = e.name.lower()
        cat = next((c for c, keys in CATEGORIES if any(k in low for k in keys)), "other")
        for rec in (by_name[e.name], by_cat[cat]):
            rec[0] += e.time_range.end - e.time_range.start
            rec[1] += 1

    def per_edit(table, n=None):
        rows = sorted(table.items(), key=lambda kv: -kv[1][0])[:n]
        return [{"name": k[:90], "ms": v[0] / 1e3 / edits, "launches": v[1] / edits}
                for k, v in rows]

    emit({"phase": "profile", "card": card, "size": SIZE, "batch": 1, "edits": edits,
          "wall_ms_per_edit": wall_us / 1e3 / edits,
          "device_busy_ms_per_edit": busy_us / 1e3 / edits,
          "device_idle_share": 1.0 - busy_us / wall_us,
          "kernel_launches_per_edit": len(kernels) / edits,
          "stage_device_busy_ms_per_edit": {k: v / 1e3 / edits
                                            for k, v in stage_busy.items()},
          "categories": per_edit(by_cat), "top_kernels": per_edit(by_name, 25)})


# ---------------------------------------------------------------------------
# phase 6: whole path, card against CPU at 256²
# ---------------------------------------------------------------------------

def phase_whole() -> None:
    size = 256
    cpu = build_session(size, ATTENTION_LAYER, ATTENTION_LAYER, seed=0, device="cpu")
    gpu = build_session(size, ATTENTION_LAYER, ATTENTION_LAYER, seed=0, device="cuda")
    # the same non-zero noise gains on both, so the fused noise path counts
    for sess in (cpu, gpu):
        g = torch.Generator().manual_seed(1)
        for name, p in sess.generator.named_parameters():
            if name.endswith("noise.weight"):
                p.data.copy_(0.1 * torch.randn(1, generator=g))
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
        launches, session = phase_slice()
        phase_profile(session, card)
        del session
        phase_whole()
    finally:
        if _out_file is not None:
            _out_file.close()
    sources = {"modconv3x3": ("where2edit_tpu_torch/csrc/modconv3x3.cu",
                              "tools/conv3x3_bench.py:185"),
               "modconv1x1": ("where2edit_tpu_torch/csrc/modconv1x1.cu",
                              "tools/pallas_bench.py:56")}
    kernels = []
    for name, (src, replaces) in sources.items():
        tot = totals[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": tot["max_abs_err"],
            "max_rel_err": tot["max_rel_err"], "ms": tot["ms"],
            "device_ms": tot["device_ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if tot["bytes_s"] >= tot["ops_s"] else "operations",
            "library_ms": tot["library_ms"],
            "note": "ms, device_ms, plain_ms, bound_ms, library_ms: sums over "
                    "the edit path's shapes at batch 1, one call each; ms, "
                    "plain_ms and library_ms are eager calls back to back (the "
                    "host's launch cost included), device_ms is the kernel "
                    "replayed from a CUDA graph"})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Device time of K1 and K2 in several trees of the port, on one NVIDIA card.

    python3 chip_kernel_ab.py TREE [TREE ...] [--out FILE.jsonl] [--bf16-only | --whole]

Each TREE is a directory holding ``where2edit_tpu_torch/`` and
``chip_smoke.py`` (a checkout, or ``git archive`` of another commit unpacked
into an ignored directory). For each TREE, in the order given, a fresh
process builds that tree's K1 and K2 into its own ``_build/`` and prints one
JSON line: the card; K1 (``modconv3x3``) at the 1024² edit path's 9 shapes
at batch 1, per call and, where the tree has ``prepare_weight``, with its
weights prepared once; K1's max |Δ| / max |plain| per shape; K2
(``conv3x3``) at the 1024² discriminator's 9 shapes at batch 8; the bf16
forms, K1-bf16 at the 1024² trainer's 9 shapes at batch 8 (per-sample style,
demod and noise, bias, the activation) and K2-bf16 at the discriminator's 9
at batch 8, with their max |Δ| / max |twin|; and the sums. Times are device
ms per call from ``chip_smoke.graph_ms`` of that tree (calls replayed from a
CUDA graph). Each fp32 output's SHA-1 is kept (``k1_sha``, ``k2_sha``): the
inputs come from one seed, so a last line (``fp32_bitwise``) says per fp32
shape whether every tree gave the same bits. ``--bf16-only`` skips the fp32
rows. Give a tree twice (A B B A) to see the spread: compare trees only
within one run, on one card.

``--whole`` measures accuracy instead of time: for each TREE, the two bf16
GAN iterations of phase 17d of *this* checkout's ``chip_smoke.py``
(``train_whole``: 64² at channel multiplier 2, and 256² at 1), card
against CPU under ``cudnn.deterministic``, run on that tree's package; one
JSON line per tree with each program's loss and whole-model gradient
error and the image error, and the checks that missed their bars.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import math
import os
import subprocess
import sys


def measure(tree: str, fp32: bool = True) -> dict:
    sys.path.insert(0, tree)
    import torch  # noqa: PLC0415

    import chip_smoke as smoke  # noqa: PLC0415
    from where2edit_tpu_torch.kernels import common  # noqa: PLC0415
    from where2edit_tpu_torch.kernels import conv3x3 as k2  # noqa: PLC0415
    from where2edit_tpu_torch.kernels import modconv3x3 as k1  # noqa: PLC0415

    if not common.__file__.startswith(tree):
        raise RuntimeError(f"imported {common.__file__}, not the tree {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_kernel_ab: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    common.build(("modconv3x3", "conv3x3"))
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*s):
        return torch.randn(*s, generator=g, device=dev)

    def sha(t):
        return hashlib.sha1(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()

    rec = {"tree": tree, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip(),
        "k1": {}, "k1_prepared": {}, "k1_rel": {}, "k1_sha": {}, "k2": {}, "k2_sha": {},
        "k1_bf16": {}, "k1_bf16_rel": {}, "k2_bf16": {}, "k2_bf16_rel": {}}
    for res, cin, cout in smoke.k1_shapes() if fp32 else ():
        x, s, w = randn(1, res, res, cin), randn(1, cin), randn(3, 3, cin, cout)
        scale = 1.0 / math.sqrt(cin * 9)
        demod = torch.rsqrt(s.square() @ (scale * w).square().sum((0, 1)) + 1e-8)
        args = (x, (scale * s).contiguous(), w, demod, randn(1, res, res), randn(1),
                randn(cout), True)
        out = k1.modconv3x3(*args)
        rec["k1_sha"][res] = sha(out)
        rec["k1_rel"][res] = smoke.rel_err(out, k1.modconv3x3_plain(*args))[1]
        rec["k1"][res] = smoke.graph_ms(lambda: k1.modconv3x3(*args))
        if hasattr(k1, "prepare_weight"):
            wp = k1.prepare_weight(w)
            rec["k1_prepared"][res] = smoke.graph_ms(
                lambda: k1.modconv3x3(*args, prepared=wp))
    for res, cin, cout in smoke.k2_shapes() if fp32 else ():
        args = (randn(8, res, res, cin), randn(3, 3, cin, cout),
                1.0 / math.sqrt(cin * 9), randn(cout), True)
        rec["k2_sha"][res] = sha(k2.conv3x3(*args))
        rec["k2"][res] = smoke.graph_ms(lambda: k2.conv3x3(*args))
    batch = 8
    for res, cin, cout in smoke.k1_shapes():
        s, w = randn(batch, cin), randn(3, 3, cin, cout)
        scale = 1.0 / math.sqrt(cin * 9)
        demod = torch.rsqrt(s.square() @ (scale * w).square().sum((0, 1)) + 1e-8)
        args = (randn(batch, res, res, cin).to(bf), (scale * s).contiguous(), w, demod,
                randn(batch, res, res), randn(1), randn(cout), True)
        rec["k1_bf16_rel"][res] = smoke.rel_err(
            k1.modconv3x3(*args).float(), k1.modconv3x3_plain(*args).float())[1]
        rec["k1_bf16"][res] = smoke.graph_ms(lambda: k1.modconv3x3(*args), 10)
    for res, cin, cout in smoke.k2_shapes():
        args = (randn(batch, res, res, cin).to(bf), randn(3, 3, cin, cout),
                1.0 / math.sqrt(cin * 9), randn(cout), True)
        rec["k2_bf16_rel"][res] = smoke.rel_err(
            k2.conv3x3(*args).float(), k2.conv3x3_plain(*args).float())[1]
        rec["k2_bf16"][res] = smoke.graph_ms(lambda: k2.conv3x3(*args), 10)
    for key in ("k1", "k1_prepared", "k2", "k1_bf16", "k2_bf16"):
        rec[key + "_sum"] = sum(rec[key].values())
    return rec


def whole(tree: str) -> dict:
    """17d's bf16 GAN iterations (this checkout's ``chip_smoke.train_whole``)
    on the package of ``tree``."""
    sys.path.insert(0, tree)
    import torch  # noqa: PLC0415

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from where2edit_tpu_torch.kernels import common  # noqa: PLC0415

    if not common.__file__.startswith(tree):
        raise RuntimeError(f"imported {common.__file__}, not the tree {tree}")
    fails = []
    smoke.check = lambda cond, what: None if cond else fails.append(what)
    rec = {"tree": tree, "card": smoke.phase_device(), "fails": fails}
    common.build(("modconv3x3", "conv3x3", "modconv1x1"))
    torch.backends.cudnn.deterministic = True
    for name, kw in (("gan", {}), ("gan_narrow", {"size": 256, "channel_multiplier": 1})):
        run = smoke.train_whole(bf16=True, **kw)
        rec[name] = {p: {k: run[p][k] for k in ("loss_rel", "model_grad_rel")}
                     for p in smoke.PROGRAMS}
        rec[name]["image_rel"] = run["image_rel"]
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="directories to measure, in order")
    ap.add_argument("--out", default=None, help="also append every JSON line here")
    ap.add_argument("--bf16-only", action="store_true", help="skip the fp32 rows")
    ap.add_argument("--whole", action="store_true",
                    help="17d's bf16 GAN iterations, card against CPU, instead of times")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    flags = ["--bf16-only"] if args.bf16_only else ["--whole"] if args.whole else []
    if args.one:  # the child process: one tree
        tree = os.path.abspath(args.trees[0])
        rec = whole(tree) if args.whole else measure(tree, not args.bf16_only)
        print(json.dumps(rec), flush=True)
        return

    def emit(line):
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    recs = []
    for tree in args.trees:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree, *flags],
                             stdout=subprocess.PIPE, text=True, check=True).stdout
        line = out.strip().splitlines()[-1]
        recs.append(json.loads(line))
        emit(line)
    if args.whole:
        return
    same = {f"{key} {res}": len({r[key][res] for r in recs}) == 1
            for key in ("k1_sha", "k2_sha") for res in recs[0][key]}
    emit(json.dumps({"fp32_bitwise": same, "all": all(same.values())}))


if __name__ == "__main__":
    main()

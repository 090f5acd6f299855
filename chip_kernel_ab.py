#!/usr/bin/env python3
"""Device time of K1 and K2 in several trees of the port, on one NVIDIA card.

    python3 chip_kernel_ab.py TREE [TREE ...] [--out FILE.jsonl]

Each TREE is a directory holding ``where2edit_tpu_torch/`` and
``chip_smoke.py`` (a checkout, or ``git archive`` of another commit unpacked
into an ignored directory). For each TREE, in the order given, a fresh
process builds that tree's K1 and K2 into its own ``_build/`` and prints one
JSON line: the card, then K1 (``modconv3x3``) at the 1024² edit path's 9
shapes at batch 1, per call and, where the tree has ``prepare_weight``, with
its weights prepared once; K1's max |Δ| / max |plain| per shape; K2
(``conv3x3``) at the 1024² discriminator's 9 shapes at batch 8; and the
sums. Times are device ms per call from ``chip_smoke.graph_ms`` of that tree
(calls replayed from a CUDA graph). Give a tree twice (A B B A) to see the
spread: compare trees only within one run, on one card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys


def measure(tree: str) -> dict:
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

    def randn(*s):
        return torch.randn(*s, generator=g, device=dev)

    rec = {"tree": tree, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip(),
        "k1": {}, "k1_prepared": {}, "k1_rel": {}, "k2": {}}
    for res, cin, cout in smoke.k1_shapes():
        x, s, w = randn(1, res, res, cin), randn(1, cin), randn(3, 3, cin, cout)
        scale = 1.0 / math.sqrt(cin * 9)
        demod = torch.rsqrt(s.square() @ (scale * w).square().sum((0, 1)) + 1e-8)
        args = (x, (scale * s).contiguous(), w, demod, randn(1, res, res), randn(1),
                randn(cout), True)
        rec["k1_rel"][res] = smoke.rel_err(k1.modconv3x3(*args),
                                           k1.modconv3x3_plain(*args))[1]
        rec["k1"][res] = smoke.graph_ms(lambda: k1.modconv3x3(*args))
        if hasattr(k1, "prepare_weight"):
            wp = k1.prepare_weight(w)
            rec["k1_prepared"][res] = smoke.graph_ms(
                lambda: k1.modconv3x3(*args, prepared=wp))
    for res, cin, cout in smoke.k2_shapes():
        args = (randn(8, res, res, cin), randn(3, 3, cin, cout),
                1.0 / math.sqrt(cin * 9), randn(cout), True)
        rec["k2"][res] = smoke.graph_ms(lambda: k2.conv3x3(*args))
    for key in ("k1", "k1_prepared", "k2"):
        rec[key + "_sum"] = sum(rec[key].values())
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="directories to measure, in order")
    ap.add_argument("--out", default=None, help="also append every JSON line here")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:  # the child process: one tree
        print(json.dumps(measure(os.path.abspath(args.trees[0]))), flush=True)
        return
    for tree in args.trees:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                             stdout=subprocess.PIPE, text=True, check=True).stdout
        line = out.strip().splitlines()[-1]
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()

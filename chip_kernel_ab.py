#!/usr/bin/env python3
"""Device time of K1, K2 and K3 in several trees of the port, on one NVIDIA card.

    python3 chip_kernel_ab.py TREE [TREE ...] [--out FILE.jsonl]
                              [--bf16-only] [--k3-only] | --whole | --train

Each TREE is a directory holding ``where2edit_tpu_torch/`` and
``chip_smoke.py`` (a checkout, or ``git archive`` of another commit unpacked
into an ignored directory). For each TREE, in the order given, a fresh
process builds that tree's K1, K2 and K3 into its own ``_build/`` and prints
one JSON line: the card; K1 (``modconv3x3``) at the 1024² edit path's 9
shapes at batch 1, per call and, where the tree has ``prepare_weight``, with
its weights prepared once; K1's max |Δ| / max |plain| per shape; K2
(``conv3x3``) at the 1024² discriminator's 9 shapes at batch 8; K3
(``modconv1x1``) at the edit path's 28 shapes at batch 1 (the 9 ToRGBs, the
mapper's 19 convs); the bf16 forms, K1-bf16 at the 1024² trainer's 9 shapes
at batch 8 (per-sample style, demod and noise, bias, the activation),
K2-bf16 at the discriminator's 9 at batch 8 and K3-bf16 at the bf16
trainers' 36 shapes (phase 3b's: the 9 ToRGBs at batch 8 and 2 with fp32
out, the attention trainer's 18 mapper convs at batch 8 with bf16 out),
with their max |Δ| / max |twin|; K3-bf16's input gradient (plain) at the
1024² ToRGB, batch 8, eager ms; and the sums. Times are device ms per
call from ``chip_smoke.graph_ms`` of that tree (calls replayed from a CUDA
graph). Each output's SHA-1 is kept (``k1_sha``, ``k2_sha``, ``k3_sha``
fp32; ``k1_bf16_sha``, ``k2_bf16_sha``, and ``k3_bf16_sha`` of the
fp32-output ToRGBs): the inputs come from one seed, so
a last line says per shape whether every tree gave the same bits
(``fp32_bitwise``, ``bf16_bitwise``). ``--bf16-only`` skips the fp32 rows,
``--k3-only`` the K1 and K2 rows. Give a tree twice (A B B A) to see the
spread: compare trees only within one run, on one card.

``--whole`` measures accuracy instead of time: for each TREE, the two bf16
GAN iterations of phase 17d of *this* checkout's ``chip_smoke.py``
(``train_whole``: 64² at channel multiplier 2, and 256² at 1), card
against CPU under ``cudnn.deterministic``, run on that tree's package; one
JSON line per tree with each program's loss and whole-model gradient
error and the image error, and the checks that missed their bars.
``--train`` runs this checkout's phase 17a (the bf16 GAN CLI at 1024²,
batch 8, 5 iterations, then one profiled iteration) on each tree's
package: iteration ms, images/s, device busy and idle share, the kernel
categories and K1/K2/K3 device ms and launches by form.
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
import tempfile


def measure(tree: str, fp32: bool = True, k12: bool = True) -> dict:
    sys.path.insert(0, tree)
    import torch  # noqa: PLC0415

    import chip_smoke as smoke  # noqa: PLC0415
    from where2edit_tpu_torch.kernels import common  # noqa: PLC0415
    from where2edit_tpu_torch.kernels import conv3x3 as k2  # noqa: PLC0415
    from where2edit_tpu_torch.kernels import modconv1x1 as k3  # noqa: PLC0415
    from where2edit_tpu_torch.kernels import modconv3x3 as k1  # noqa: PLC0415

    if not common.__file__.startswith(tree):
        raise RuntimeError(f"imported {common.__file__}, not the tree {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_kernel_ab: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    common.build(("modconv3x3", "conv3x3", "modconv1x1"))
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
        "k3": {}, "k3_sha": {}, "k1_bf16": {}, "k1_bf16_rel": {}, "k1_bf16_sha": {},
        "k2_bf16": {}, "k2_bf16_rel": {}, "k2_bf16_sha": {}, "k3_bf16": {}, "k3_bf16_rel": {},
        "k3_bf16_sha": {}}
    for res, cin, cout in smoke.k1_shapes() if fp32 and k12 else ():
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
    for res, cin, cout in smoke.k2_shapes() if fp32 and k12 else ():
        args = (randn(8, res, res, cin), randn(3, 3, cin, cout),
                1.0 / math.sqrt(cin * 9), randn(cout), True)
        rec["k2_sha"][res] = sha(k2.conv3x3(*args))
        rec["k2"][res] = smoke.graph_ms(lambda: k2.conv3x3(*args))

    def k3_args(name, res, cin, cout, styled, has_res, batch, x_dtype, out_dtype):
        """K3's operands at one of phase 3's shapes; residual in the output's dtype."""
        p = res * res
        s, w = randn(batch, cin), randn(cin, cout)
        scale = 1.0 / math.sqrt(cin)
        demod = torch.rsqrt(s.square() @ (scale * w).square() + 1e-8) if styled else None
        noise, nw = (randn(1, p), randn(1)) if styled else (None, None)
        return (randn(batch, p, cin).to(x_dtype), (scale * s).contiguous(), w, demod, noise, nw,
                randn(cout), styled, randn(batch, p, cout).to(out_dtype) if has_res else None)

    for shape in smoke.k3_shapes() if fp32 else ():  # the edit path's, batch 1
        args = k3_args(*shape, 1, torch.float32, torch.float32)
        rec["k3_sha"][shape[0]] = sha(k3.modconv1x1(*args))
        rec["k3"][shape[0]] = smoke.graph_ms(lambda: k3.modconv1x1(*args))
    # phase 3b's K3-bf16 trainer shapes: the ToRGBs at batch 8 and 2 (fp32
    # out), the attention trainer's mapper convs at batch 8 (bf16 out)
    k3_bf16_shapes = ([(shape, batch, torch.float32) for batch in (8, smoke.STYLECLIP_BATCH)
                       for shape in smoke.k3_shapes()[:9]]
                      + [((*shape, True, False), smoke.ATTENTION_BATCH, bf)
                         for shape in smoke.mapper_conv_shapes(smoke.TRAIN_ATTENTION_LAYER)[1:]])
    for shape, batch, out_dtype in k3_bf16_shapes:
        args = k3_args(*shape, batch, bf, out_dtype)
        key = f"{shape[0]} batch {batch}"
        out = k3.modconv1x1(*args, out_dtype=out_dtype)
        if out_dtype == torch.float32:  # the ToRGBs: the FMA kernel's sums, bit for bit
            rec["k3_bf16_sha"][key] = sha(out)
        rec["k3_bf16_rel"][key] = smoke.rel_err(
            out.float(), k3.modconv1x1_plain(*args, out_dtype=out_dtype).float())[1]
        rec["k3_bf16"][key] = smoke.graph_ms(lambda: k3.modconv1x1(*args, out_dtype=out_dtype),
                                             10)
    # K3's backward is plain: its input gradient at the 1024² ToRGB, batch 8
    # (fp32 sums in the bf16 trainers), ms of eager calls
    args = k3_args(*smoke.k3_shapes()[8], 8, bf, torch.float32)
    x = args[0].requires_grad_(True)
    y = k3.modconv1x1(x, *args[1:], out_dtype=torch.float32)
    dy = randn(*y.shape)
    rec["k3_bf16_input_grad_ms"] = smoke.time_ms(
        lambda: torch.autograd.grad(y, x, dy, retain_graph=True))
    batch = 8
    for res, cin, cout in smoke.k1_shapes() if k12 else ():
        s, w = randn(batch, cin), randn(3, 3, cin, cout)
        scale = 1.0 / math.sqrt(cin * 9)
        demod = torch.rsqrt(s.square() @ (scale * w).square().sum((0, 1)) + 1e-8)
        args = (randn(batch, res, res, cin).to(bf), (scale * s).contiguous(), w, demod,
                randn(batch, res, res), randn(1), randn(cout), True)
        out = k1.modconv3x3(*args)
        rec["k1_bf16_sha"][res] = sha(out)
        rec["k1_bf16_rel"][res] = smoke.rel_err(out.float(), k1.modconv3x3_plain(*args).float())[1]
        rec["k1_bf16"][res] = smoke.graph_ms(lambda: k1.modconv3x3(*args), 10)
    for res, cin, cout in smoke.k2_shapes() if k12 else ():
        args = (randn(batch, res, res, cin).to(bf), randn(3, 3, cin, cout),
                1.0 / math.sqrt(cin * 9), randn(cout), True)
        out = k2.conv3x3(*args)
        rec["k2_bf16_sha"][res] = sha(out)
        rec["k2_bf16_rel"][res] = smoke.rel_err(out.float(), k2.conv3x3_plain(*args).float())[1]
        rec["k2_bf16"][res] = smoke.graph_ms(lambda: k2.conv3x3(*args), 10)
    for key in ("k1", "k1_prepared", "k2", "k3", "k1_bf16", "k2_bf16", "k3_bf16"):
        rec[key + "_sum"] = sum(rec[key].values())
    return rec


def this_smoke(tree: str):
    """This checkout's ``chip_smoke`` run on the package of ``tree`` (first on
    the path), its checks recorded instead of raised: (module, the list of
    failed checks)."""
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from where2edit_tpu_torch.kernels import common  # noqa: PLC0415

    if not common.__file__.startswith(tree):
        raise RuntimeError(f"imported {common.__file__}, not the tree {tree}")
    fails = []
    smoke.check = lambda cond, what: None if cond else fails.append(what)
    common.build(("modconv3x3", "conv3x3", "modconv1x1"))
    return smoke, fails


def whole(tree: str) -> dict:
    """17d's bf16 GAN iterations (this checkout's ``chip_smoke.train_whole``)
    on the package of ``tree``."""
    import torch  # noqa: PLC0415

    smoke, fails = this_smoke(tree)
    rec = {"tree": tree, "card": smoke.phase_device(), "fails": fails}
    torch.backends.cudnn.deterministic = True
    for name, kw in (("gan", {}), ("gan_narrow", {"size": 256, "channel_multiplier": 1})):
        run = smoke.train_whole(bf16=True, **kw)
        rec[name] = {p: {k: run[p][k] for k in ("loss_rel", "model_grad_rel")}
                     for p in smoke.PROGRAMS}
        rec[name]["image_rel"] = run["image_rel"]
    return rec


def train(tree: str) -> dict:
    """17a's bf16 GAN run at 1024², batch 8, and its profiled iteration
    (this checkout's ``chip_smoke.phase_train_bf16``) on the package of
    ``tree``: iteration ms, images/s, and the profile's device busy, idle
    share, categories and K1/K2/K3 device ms by form."""
    smoke, fails = this_smoke(tree)
    lines = []
    smoke.emit = lines.append
    rec = {"tree": tree, "card": smoke.phase_device(), "fails": fails}
    with tempfile.TemporaryDirectory() as work:
        smoke.phase_train_bf16(rec["card"], work, 0.0)
    run = next(r for r in lines if r["phase"] == "train_bf16")
    prof = next(r for r in lines if r["phase"] == "train_bf16_profile")
    rec.update(iteration_ms=run["iteration_ms"], images_per_s=run["images_per_s"],
               **{k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                                       "kernel_launches", "kernel_forms", "categories")})
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="directories to measure, in order")
    ap.add_argument("--out", default=None, help="also append every JSON line here")
    ap.add_argument("--bf16-only", action="store_true", help="skip the fp32 rows")
    ap.add_argument("--k3-only", action="store_true", help="skip the K1 and K2 rows")
    ap.add_argument("--whole", action="store_true",
                    help="17d's bf16 GAN iterations, card against CPU, instead of times")
    ap.add_argument("--train", action="store_true",
                    help="17a's bf16 GAN run and profiled iteration instead of kernel times")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    flags = (["--whole"] if args.whole else ["--train"] if args.train else
             ["--bf16-only"] * args.bf16_only + ["--k3-only"] * args.k3_only)
    if args.one:  # the child process: one tree
        tree = os.path.abspath(args.trees[0])
        rec = (whole(tree) if args.whole else train(tree) if args.train
               else measure(tree, not args.bf16_only, not args.k3_only))
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
    if args.whole or args.train:
        return
    same = {kind: {f"{key} {shape}": len({r.get(key, {}).get(shape) for r in recs}) == 1
                   for key in keys for shape in recs[0].get(key, {})}
            for kind, keys in (("fp32_bitwise", ("k1_sha", "k2_sha", "k3_sha")),
                               ("bf16_bitwise", ("k1_bf16_sha", "k2_bf16_sha",
                                                 "k3_bf16_sha")))}
    emit(json.dumps({**same, "all": all(v for d in same.values() for v in d.values())}))


if __name__ == "__main__":
    main()

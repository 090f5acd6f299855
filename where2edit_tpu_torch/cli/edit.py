"""One-shot text-guided editing CLI (counterpart of
where2edit_tpu/cli/edit.py for a seeded face).

Samples a face from ``--seed``, applies each ``--text`` prompt through the
same ``EditSession`` the demos use, and saves original/edited/attention
PNGs (skipped when PIL is missing). Every prompt after the first reuses the
session's cached styles and taps. Weights are seeded random until
checkpoints can be loaded.

    python -m where2edit_tpu_torch.cli.edit --seed 7 \\
        --text "a person with grey hair" --region hair --output_dir edits/
"""

from __future__ import annotations

import argparse
import os
import re
import time

import numpy as np
import torch

from where2edit_tpu_torch.demo.app import REGION_PROMPTS, build_session
from where2edit_tpu_torch.models.clip_tokenizer import tokenize


def _slug(text: str, maxlen: int = 40) -> str:
    s = re.sub(r"[^a-z0-9]+", "_", text.lower()).strip("_")
    return s[:maxlen] or "edit"


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seed", type=int, default=0,
                   help="sample a synthetic face from this seed")
    p.add_argument("--text", type=str, nargs="+", required=True,
                   help="edit prompt(s); each produces one edit of the face")
    p.add_argument("--region", type=str, default=None,
                   choices=sorted(REGION_PROMPTS),
                   help="fixed attention-region prompt")
    p.add_argument("--attention_text", type=str, default=None,
                   help="free-form attention prompt (defaults to --text)")
    p.add_argument("--strength", type=float, default=0.1,
                   help="edit strength alpha, in [0, 0.3]")
    p.add_argument("--coverage", type=float, default=0.0,
                   help="attention coverage in [0,1]; threshold = "
                        "1 - 0.25*coverage")
    p.add_argument("--truncation", type=float, default=0.7)
    p.add_argument("--batch_prompts", action="store_true",
                   help="run all --text prompts as one batch")
    p.add_argument("--stylegan_size", type=int, default=1024)
    p.add_argument("--attention_layer", type=int, default=13)
    p.add_argument("--cluster_layer", type=int, default=13)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--output_dir", type=str, default="edit_results")
    return p


def _save(images: torch.Tensor, path: str, value_range=(-1.0, 1.0)) -> bool:
    """Save an NHWC batch side by side as one PNG; False without PIL."""
    try:
        from PIL import Image  # noqa: PLC0415
    except ImportError:
        return False
    lo, hi = value_range
    arr = (images.detach().float().cpu().numpy() - lo) / (hi - lo)
    arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    Image.fromarray(np.concatenate(list(arr), axis=1)).save(path)
    return True


def main(argv=None):
    args = build_argparser().parse_args(argv)
    session = build_session(args.stylegan_size, args.attention_layer,
                            args.cluster_layer, device=args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    session.load_synthetic(args.seed, truncation=args.truncation)
    _save(session.image, os.path.join(args.output_dir, "original.png"))

    threshold = 1.0 - 0.25 * float(args.coverage)
    att_prompts = [REGION_PROMPTS[args.region] if args.region
                   else (args.attention_text or t) for t in args.text]
    groups = ([list(range(len(args.text)))] if args.batch_prompts
              else [[i] for i in range(len(args.text))])
    results = []
    for idx in groups:
        toks = tokenize([args.text[i] for i in idx])
        att = tokenize([att_prompts[i] for i in idx])
        t0 = time.perf_counter()
        imgs, amaps = session.edit(toks, att, strength_alpha=args.strength,
                                   attention_threshold=threshold)
        imgs, amaps = imgs.cpu(), amaps.cpu()  # the copy waits for the device
        ms = (time.perf_counter() - t0) * 1000 / len(idx)
        for j, i in enumerate(idx):
            stem = f"{i:02d}_{_slug(args.text[i])}"
            edit_path = os.path.join(args.output_dir, f"edit_{stem}.png")
            att_path = os.path.join(args.output_dir, f"attention_{stem}.png")
            saved = _save(imgs[j:j + 1], edit_path)
            _save(amaps[j:j + 1], att_path, value_range=(0.0, 1.0))
            print(f"[{i}] {args.text[i]!r} (attention: {att_prompts[i]!r}) "
                  f"{ms:.1f} ms" + (f" -> {edit_path}" if saved else ""))
            results.append({"text": args.text[i], "attention": att_prompts[i],
                            "ms": ms, "edit": edit_path if saved else None,
                            "attention_map": att_path if saved else None})
    return results


if __name__ == "__main__":
    main()

"""One-shot text-guided editing CLI (counterpart of
where2edit_tpu/cli/edit.py).

Loads one or more faces (a seeded sample; photos inverted by e4e; a W+
bank; a gallery entry), applies each ``--text`` prompt to every face
through the same ``EditSession`` the demos use (a trained mapper from
``--mapper``, the CLIP text tower from ``--clip_ckpt``), and saves
original/edited/attention PNGs (skipped when Pillow is missing). Every
prompt after the first reuses the session's cached styles and taps.

    python -m where2edit_tpu_torch.cli.edit --seed 7 \\
        --text "a person with grey hair" --region hair --output_dir edits/ \\
        --mapper final_mapper.pt --clip_ckpt ViT-B-32.pt
    python -m where2edit_tpu_torch.cli.edit --image face.png \\
        --e4e_ckpt e4e_ffhq_encode.pt --text "grey hair" --device cpu
"""

from __future__ import annotations

import os
import re
import time

import numpy as np
import torch

from where2edit_tpu_torch.cli.common import load_torch_state
from where2edit_tpu_torch.demo.app import (
    REGION_PROMPTS,
    load_gallery,
    load_psp,
    load_session,
)
from where2edit_tpu_torch.demo.app import build_argparser as demo_argparser
from where2edit_tpu_torch.demo.gallery import read_face_images
from where2edit_tpu_torch.models.clip_tokenizer import tokenize


def _slug(text: str, maxlen: int = 40) -> str:
    s = re.sub(r"[^a-z0-9]+", "_", text.lower()).strip("_")
    return s[:maxlen] or "edit"


def build_argparser():
    p = demo_argparser()
    p.description = __doc__
    src = p.add_mutually_exclusive_group()
    src.add_argument("--seed", type=int, default=None,
                     help="sample a synthetic face from this seed (default 0)")
    src.add_argument("--image", type=str, nargs="+", default=None,
                     help="face photo(s), inverted by e4e; needs --e4e_ckpt")
    src.add_argument("--latent", type=str, default=None,
                     help="W+ bank (B, n_latent, 512) or one face "
                          "(n_latent, 512): .npy, .npz or torch .pt")
    src.add_argument("--celeb", type=str, default=None,
                     help="gallery entry (from --celebs_path / --images_dir, "
                          "or built-in 'Celeb N'); 'list' prints the names")
    p.add_argument("--text", type=str, nargs="+", default=None,
                   help="edit prompt(s); each edits every loaded face "
                        "(required except with '--celeb list')")
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
                   help="run all --text prompts as one batch (single-face "
                        "sources only)")
    p.add_argument("--output_dir", type=str, default="edit_results")
    return p


def _load_wplus_bank(path: str) -> np.ndarray:
    """(B, n_latent, 512) float32 from .npy / .npz (its first array) or a
    torch file (a tensor, or a dict whose first value is one)."""
    if path.endswith((".npy", ".npz")):
        arr = np.load(path)
        if isinstance(arr, np.lib.npyio.NpzFile):
            arr = arr[arr.files[0]]
    else:
        obj = load_torch_state(path)
        if isinstance(obj, dict):  # e.g. saved {"latents": ...}
            obj = next(iter(obj.values()))
        arr = obj.numpy() if isinstance(obj, torch.Tensor) else np.asarray(obj)
    arr = np.asarray(arr, dtype=np.float32)
    return arr[None] if arr.ndim == 2 else arr


def _save(images: torch.Tensor, path: str, value_range=(-1.0, 1.0)) -> bool:
    """Save an NHWC batch side by side as one PNG; False without Pillow."""
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


def _load_faces(args, session) -> bool:
    """Load the source the flags name into ``session``; False for
    ``--celeb list`` (the names are printed, nothing is loaded)."""
    if args.image is not None:
        psp = load_psp(args)
        session.load_latent(psp.encode(read_face_images(args.image).to(psp.device)))
    elif args.latent is not None:
        session.load_latent(_load_wplus_bank(args.latent))
    elif args.celeb is not None:
        gallery = load_gallery(args, session)
        if args.celeb == "list":
            print("\n".join(gallery.names()))
            return False
        gallery.load(args.celeb)
    else:
        session.load_synthetic(args.seed or 0, truncation=args.truncation)
    return True


def main(argv=None):
    """Returns one row per (prompt, face): text, attention prompt, face
    index, ms per prompt, and the saved PNGs (None without Pillow)."""
    args = build_argparser().parse_args(argv)
    if args.text is None and args.celeb != "list":
        raise SystemExit("--text is required (except with '--celeb list')")
    if args.image is not None and not args.e4e_ckpt:
        raise SystemExit("--image requires --e4e_ckpt for inversion")
    session = load_session(args)
    if not _load_faces(args, session):
        return []
    faces = int(session.image.shape[0])
    sweep = args.batch_prompts and len(args.text) > 1
    if sweep and faces != 1:
        raise SystemExit("--batch_prompts needs a single-face source")
    os.makedirs(args.output_dir, exist_ok=True)
    _save(session.image, os.path.join(args.output_dir, "original.png"))

    threshold = 1.0 - 0.25 * float(args.coverage)
    att_prompts = [REGION_PROMPTS[args.region] if args.region
                   else (args.attention_text or t) for t in args.text]
    # one token row per edited image: a batch of prompts for one face, or
    # each prompt repeated once per loaded face
    groups = ([list(range(len(args.text)))] if sweep
              else [[i] * faces for i in range(len(args.text))])
    results = []
    for idx in groups:
        toks = tokenize([args.text[i] for i in idx])
        att = tokenize([att_prompts[i] for i in idx])
        t0 = time.perf_counter()
        imgs, amaps = session.edit(toks, att, strength_alpha=args.strength,
                                   attention_threshold=threshold)
        imgs, amaps = imgs.cpu(), amaps.cpu()  # the copy waits for the device
        ms = (time.perf_counter() - t0) * 1000 / len(set(idx))
        for row, i in enumerate(idx):
            face = 0 if sweep else row
            stem = f"{i:02d}_{_slug(args.text[i])}" + (
                f"_face{face}" if faces > 1 else "")
            edit_path = os.path.join(args.output_dir, f"edit_{stem}.png")
            att_path = os.path.join(args.output_dir, f"attention_{stem}.png")
            saved = _save(imgs[row:row + 1], edit_path)
            _save(amaps[row:row + 1], att_path, value_range=(0.0, 1.0))
            print(f"[{i}] face {face} {args.text[i]!r} (attention: "
                  f"{att_prompts[i]!r}) {ms:.1f} ms"
                  + (f" -> {edit_path}" if saved else ""))
            results.append({"text": args.text[i], "attention": att_prompts[i],
                            "face": face, "ms": ms,
                            "edit": edit_path if saved else None,
                            "attention_map": att_path if saved else None})
    return results


if __name__ == "__main__":
    main()

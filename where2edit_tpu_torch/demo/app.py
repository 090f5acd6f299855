"""Session construction for the demos and the CLI (counterpart of
where2edit_tpu/demo/app.py ``load_session`` / ``load_psp`` /
``load_gallery`` / ``build_argparser``).

The generator loads from ``--ckpt``'s ``g_ema`` when that file exists; the
mapper and the CLIP text tower are built from seeded random weights (their
checkpoints do not load yet), as is the generator without a checkpoint.
"""

from __future__ import annotations

import argparse
import os

import torch

from where2edit_tpu_torch import resolve_device
from where2edit_tpu_torch.cli.common import load_torch_state
from where2edit_tpu_torch.demo.api import EditSession
from where2edit_tpu_torch.demo.gallery import CelebGallery
from where2edit_tpu_torch.editing.attention_mappers import (
    FullSpaceMapperFEATClusterLinStyle,
)
from where2edit_tpu_torch.models.clip_model import TextTransformer
from where2edit_tpu_torch.models.psp import PSp
from where2edit_tpu_torch.models.stylegan2 import Generator

# the demo's fixed attention-region prompts
REGION_PROMPTS = {
    "skin": "tanned skin",
    "nose": "narrow nose",
    "eyes": "narrow eyes",
    "eyebrows": "thin eyebrows",
    "ears": "wearing a pair of earrings",
    "mouth": "pink lipsticks",
    "hair": "grey hair",
}


def build_models(size: int = 1024, attention_layer: int = 13,
                 cluster_layer: int = 13, seed: int = 0):
    """(generator, mapper, ViT-B/32 text tower) with random weights drawn on
    the CPU from one seeded torch.Generator; the order of the draws is fixed,
    so a seed always gives the same weights."""
    rng = torch.Generator().manual_seed(seed)
    gen = Generator(size, rng=rng)
    mapper = FullSpaceMapperFEATClusterLinStyle(
        layers=gen.n_latent, attention_layer=attention_layer,
        cluster_layer=cluster_layer, generator_size=size, rng=rng)
    text = TextTransformer(rng=rng)
    return gen, mapper, text


def build_session(size: int = 1024, attention_layer: int = 13,
                  cluster_layer: int = 13, seed: int = 0,
                  device: str | torch.device | None = None) -> EditSession:
    """An S-space ``EditSession`` at ``size`` from seeded random weights, on
    ``device`` (CUDA unless the caller names another)."""
    dev = resolve_device(device)
    gen, mapper, text = build_models(size, attention_layer, cluster_layer,
                                     seed)
    gen, mapper, text = (m.to(dev).eval() for m in (gen, mapper, text))
    return EditSession(generator=gen, mapper=mapper, clip_encode_text=text,
                       attention_layer=attention_layer)


def load_session(args) -> EditSession:
    """``build_session`` from the parsed flags, with the generator's weights
    from ``--ckpt`` (its ``g_ema`` entry, or the whole file as a state dict)
    when that file exists."""
    session = build_session(args.stylegan_size, args.attention_layer,
                            args.cluster_layer, device=args.device)
    if args.ckpt and os.path.isfile(args.ckpt):
        ckpt = load_torch_state(args.ckpt)
        session.generator.load_state_dict(ckpt.get("g_ema", ckpt))
    return session


def load_psp(args):
    """The e4e encoder for inverting photos from ``--e4e_ckpt``, on
    ``--device``; None without that flag."""
    if not args.e4e_ckpt:
        return None
    return PSp.from_state_dict(load_torch_state(args.e4e_ckpt),
                               stylegan_size=args.stylegan_size,
                               device=args.device)


def load_gallery(args, session: EditSession, psp=None):
    """The provided-faces gallery of ``--celebs_path`` / ``--images_dir``
    (built-in seeded faces without either); ``psp`` defaults to
    ``load_psp(args)``."""
    return CelebGallery(session, celebs_path=args.celebs_path,
                        images_dir=args.images_dir,
                        psp=psp if psp is not None else load_psp(args))


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", type=str,
                   default="pretrained_models/stylegan2-ffhq-config-f.pt",
                   help="generator checkpoint (its g_ema), loaded when the "
                        "file exists; seeded random weights otherwise")
    p.add_argument("--e4e_ckpt", type=str, default=None,
                   help="e4e checkpoint for inverting photos")
    p.add_argument("--stylegan_size", type=int, default=1024)
    p.add_argument("--attention_layer", type=int, default=13)
    p.add_argument("--cluster_layer", type=int, default=13)
    p.add_argument("--celebs_path", type=str, default=None,
                   help="W+ latent pack (example_celebs.pt style) for the "
                        "provided-faces gallery")
    p.add_argument("--images_dir", type=str, default=None,
                   help="directory of face images for the gallery "
                        "(inverted on selection; needs --e4e_ckpt)")
    p.add_argument("--device", type=str, default="cuda")
    return p

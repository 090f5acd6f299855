"""Session construction for the demos and the CLI (counterpart of
where2edit_tpu/demo/app.py ``load_session`` / ``load_psp`` /
``load_gallery`` / ``build_argparser``).

``load_session`` builds the S-space session the demo serves: the generator
from ``--ckpt``'s ``g_ema`` when that file exists, the mapper from
``--mapper`` (a reference mapper ``.pt``, bare or DDP-prefixed, or the
``final_mapper.pt`` that ``cli/run_attention.py`` writes) and the CLIP text
tower from ``--clip_ckpt`` (an OpenAI state dict or TorchScript archive).
Whatever is not given keeps seeded random weights, and stderr says so.
The W+ session (``EditSession(work_in_stylespace=False)``) is reached
through the API, as in the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from where2edit_tpu_torch import resolve_device
from where2edit_tpu_torch.cli.common import load_torch_state
from where2edit_tpu_torch.cli.run_attention import load_clip
from where2edit_tpu_torch.convert import reference_mapper_state_dict
from where2edit_tpu_torch.demo.api import EditSession
from where2edit_tpu_torch.demo.gallery import CelebGallery
from where2edit_tpu_torch.editing.attention_mappers import (
    FullSpaceMapperFEATClusterLinStyle,
)
from where2edit_tpu_torch.models.clip_model import TextTransformer
from where2edit_tpu_torch.models.psp import PSp, get_keys
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


def read_mapper_checkpoint(path: str) -> dict:
    """The mapper state dict of ``path``: the ``"mapper"`` entry of a
    checkpoint ``cli/run_attention.py`` wrote, the ``mapper.`` entries of a
    dict holding a ``state_dict`` (as the JAX package's readers take them),
    or a bare state dict; read as ``convert.reference_mapper_state_dict`` does
    (``module.`` stripped, the dead ``mapper_textca_{c}`` entries dropped).
    Anything else raises, naming the file."""
    obj = load_torch_state(path)
    if isinstance(obj, dict) and isinstance(obj.get("mapper"), dict):
        obj = obj["mapper"]
    elif isinstance(obj, dict) and "state_dict" in obj:
        obj = get_keys(obj, "mapper")
    if (not isinstance(obj, dict) or not obj
            or not all(isinstance(v, torch.Tensor) for v in obj.values())):
        raise ValueError(f"--mapper {path}: neither a mapper state dict nor a "
                         "checkpoint holding one")
    return reference_mapper_state_dict(obj)


def load_mapper_state(mapper, state_dict: dict, path: str = "the checkpoint"):
    """Load ``state_dict`` into ``mapper`` strictly, sizing its k-means
    buffer from the file. Without ``initial_state`` the mapper keeps no
    centres (as the JAX mapper without its clusters collection): it loads,
    and an edit with it raises."""
    sd = dict(state_dict)
    if "initial_state" in sd:
        mapper.initial_state = torch.zeros_like(sd["initial_state"], dtype=torch.float32)
        mapper.clusters = sd["initial_state"].shape[0]
    what = f"--mapper {path} does not fit {type(mapper).__name__}"
    try:
        missing, unexpected = mapper.load_state_dict(sd, strict=False)
    except RuntimeError as e:  # a shape that differs
        raise ValueError(f"{what}: {e}") from e
    missing = [k for k in missing if k != "initial_state"]
    if missing or unexpected:
        raise ValueError(f"{what}: missing {missing[:5]}, "
                         f"unexpected {unexpected[:5]}")
    if "initial_state" not in sd and hasattr(mapper, "initial_state"):
        mapper.initial_state = None
    return mapper


def load_session(args, encode_text=None) -> EditSession:
    """The demo's S-space session from the parsed flags: ``build_models``'
    seeded weights, with the generator's from ``--ckpt`` (its ``g_ema``
    entry, or the whole file as a state dict) when that file exists, the
    mapper's from ``--mapper`` and the text tower from ``--clip_ckpt``.
    ``encode_text``, when given, is the session's text encoder instead (a
    caller that holds a whole CLIP encodes text and images with one
    model)."""
    dev = resolve_device(args.device)
    gen, mapper, text = build_models(args.stylegan_size, args.attention_layer,
                                     args.cluster_layer)
    if args.ckpt and os.path.isfile(args.ckpt):
        ckpt = load_torch_state(args.ckpt)
        gen.load_state_dict(ckpt.get("g_ema", ckpt))
    if args.mapper:
        load_mapper_state(mapper, read_mapper_checkpoint(args.mapper), args.mapper)
    else:
        print("[warn] no --mapper checkpoint: the mapper has seeded random "
              "weights", file=sys.stderr)
    if encode_text is not None:
        encode = encode_text
    elif args.clip_ckpt:
        encode = load_clip(args.clip_ckpt, dev).encode_text
    else:
        print("[warn] no --clip_ckpt: the CLIP text tower has seeded random "
              "weights", file=sys.stderr)
        encode = text.to(dev).eval()
    gen, mapper = gen.to(dev).eval(), mapper.to(dev).eval()
    return EditSession(generator=gen, mapper=mapper, clip_encode_text=encode,
                       attention_layer=args.attention_layer)


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
    p.add_argument("--mapper", type=str, default=None,
                   help="trained mapper: a reference .pt (state dict, DDP "
                        "prefixes allowed) or cli/run_attention.py's "
                        "final_mapper.pt; seeded random weights otherwise")
    p.add_argument("--clip_ckpt", type=str, default=None,
                   help="OpenAI CLIP state dict or TorchScript archive for "
                        "the text tower; seeded random weights otherwise")
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

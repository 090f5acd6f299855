"""Quantitative evaluation CLI (counterpart of
where2edit_tpu/cli/evaluate.py), two modes:

* ``edits``: random-prompt edits of seeded faces, scored by the CLIP
  improvement (does the edit move the image towards its prompt), the
  ArcFace ID cosine between each original and its edit
  (``--ir_se50_weights``) and the Fréchet distance between the edited and
  the original images' feature pools (InceptionV3 pool3 with
  ``--inception_ckpt``, else CLIP image features);
* ``iou``: each CelebAMask-HQ test photo is inverted by e4e, the mapper
  predicts a map for each of 8 region prompts, and the binarised maps are
  scored against the photo's labels (per-class and macro IoU).

    python -m where2edit_tpu_torch.cli.evaluate edits --ckpt G.pt \\
        --mapper final_mapper.pt --clip_ckpt ViT-B-32.pt \\
        [--inception_ckpt pt_inception.pth] [--ir_se50_weights ir_se50.pth]
    python -m where2edit_tpu_torch.cli.evaluate iou --ckpt G.pt \\
        --mapper final_mapper.pt --e4e_ckpt e4e.pt --img_path IMG --label_path LBL

Text and image features come from one CLIP (``--clip_ckpt``, else ViT-B/32
with seeded random weights). Runs on CUDA unless ``--device cpu`` is given
(and raises without a card). Prints one JSON line and returns the result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import random

import torch

from where2edit_tpu_torch import resolve_device
from where2edit_tpu_torch.cli.common import load_torch_state
from where2edit_tpu_torch.cli.run_attention import load_clip
from where2edit_tpu_torch.demo.app import load_psp, load_session
from where2edit_tpu_torch.editing.attention_mappers import tap_resolution
from where2edit_tpu_torch.eval.iou import calculate_iou
from where2edit_tpu_torch.eval.metrics import EditEvaluator
from where2edit_tpu_torch.losses.clip_loss import CLIPLoss
from where2edit_tpu_torch.losses.id_loss import IDLoss
from where2edit_tpu_torch.models.clip_tokenizer import tokenize
from where2edit_tpu_torch.models.inception import InceptionV3
from where2edit_tpu_torch.models.irse import Backbone
from where2edit_tpu_torch.ops.interpolate import interpolate_bilinear
from where2edit_tpu_torch.train.corpus import load_corpus
from where2edit_tpu_torch.train.datasets import CelebAMaskHQ

# an edit of the sweep: the prompt rows are the attention rows too
EDIT_STRENGTH, EDIT_THRESHOLD = 0.1, 0.75
FALLBACK_PHRASES = ["grey hair", "narrow eyes", "a smiling face", "thick eyebrows"]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", choices=["edits", "iou"])
    p.add_argument("--ckpt", type=str,
                   default="pretrained_models/stylegan2-ffhq-config-f.pt")
    p.add_argument("--mapper", type=str, default=None)
    p.add_argument("--clip_ckpt", type=str, default=None)
    p.add_argument("--ir_se50_weights", type=str, default=None,
                   help="ArcFace IR-SE50 state dict: adds the ID cosine")
    p.add_argument("--inception_ckpt", type=str, default=None,
                   help="torchvision-layout InceptionV3 state dict: FID on "
                        "its pool3 features (CLIP image features otherwise)")
    p.add_argument("--e4e_ckpt", type=str, default=None)
    p.add_argument("--img_path", type=str,
                   default="face_parsing/Data_preprocessing/test_img")
    p.add_argument("--label_path", type=str,
                   default="face_parsing/Data_preprocessing/test_label")
    p.add_argument("--stylegan_size", type=int, default=1024)
    p.add_argument("--attention_layer", type=int, default=13)
    p.add_argument("--cluster_layer", type=int, default=13)
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--truncation", type=float, default=0.7)
    p.add_argument("--description_dir", type=str, default="celeba-caption")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; cpu runs the plain versions)")
    return p


def load_models(args):
    """(session, CLIPLoss) on ``args.device``: the demo's S-space session
    whose text encoder is the CLIP that also encodes the images."""
    dev = resolve_device(args.device)
    clip = load_clip(args.clip_ckpt, dev)
    session = load_session(args, encode_text=clip.encode_text)
    return session, CLIPLoss(clip, args.stylegan_size)


def load_id_extract(path: str, device):
    """``IDLoss(Backbone(112, drop_ratio=0.6)).extract_feats`` on the
    reference ArcFace state dict at ``path``."""
    facenet = Backbone.from_state_dict(load_torch_state(path), input_size=112,
                                       drop_ratio=0.6)
    return IDLoss(facenet.to(device).eval()).extract_feats


def load_fid_extract(path: str, device):
    """InceptionV3 pool3 features of generator images: [-1, 1] → [0, 1],
    bilinear to 299² (no corner alignment)."""
    inc = InceptionV3.from_state_dict(load_torch_state(path)).to(device).eval()
    return lambda img: inc(interpolate_bilinear((img + 1) / 2, 299,
                                                align_corners=False))[0]


def make_edit_fn(session, truncation: float = 0.7, span=None, wplus_for=None):
    """``edit_fn(seed, text_features) -> (original, edited)``: load the
    faces (``load_synthetic(seed)`` at the text batch, or
    ``load_latent(wplus_for(seed))``), then ``predict`` (the prompt rows
    as the attention rows, strength 0.1, threshold 0.75) and ``render``."""
    span = span or (lambda stage: contextlib.nullcontext())

    def edit_fn(seed, text_feats):
        with span("faces"):
            if wplus_for is None:
                session.load_synthetic(seed, truncation=truncation,
                                       batch=text_feats.shape[0])
            else:
                session.load_latent(wplus_for(seed))
        with span("edit"):
            new_lat, amap = session.predict(text_feats, text_feats,
                                            EDIT_STRENGTH, EDIT_THRESHOLD)
            img = session.render(new_lat, amap)
        return session.image, img

    return edit_fn


def sweep_prompts(args, rng: random.Random, device) -> list:
    """``args.iterations`` token batches of ``args.batch`` phrases drawn by
    ``rng`` from the corpus (four fixed phrases without one)."""
    corpus = load_corpus(args.description_dir, None, None, rng)
    phrases = corpus.phrases or FALLBACK_PHRASES
    return [torch.as_tensor(tokenize([phrases[rng.randrange(len(phrases))]
                                      for _ in range(args.batch)]),
                            device=device).long()
            for _ in range(args.iterations)]


def iou_callables(session, psp=None, span=None) -> dict:
    """``calculate_iou``'s ``invert_fn`` (``psp.encode`` of one photo),
    ``features_fn`` (``session.load_latent``: the S-space styles and the
    mapper-ready taps) and ``mapper_apply`` (the S-space mapper on those
    styles: ``train=False``, ``finalize=False``, zero noise), and a
    ``tokenizer`` giving token ids on the session's device."""
    span = span or (lambda stage: contextlib.nullcontext())
    dev = session.device

    def invert(img_arr):
        with span("invert"):
            return psp.encode(torch.from_numpy(img_arr[None]).to(dev))

    def features(w):
        with span("capture"):
            session.load_latent(w)
        return session.feature_map

    def mapper_apply(text_feats, latent, feats, blend_size):
        with span("mapper"):
            return session.mapper(text_feats, session.latent, feats, blend_size,
                                  train=False, finalize=False,
                                  deterministic_noise=True)

    def tokens(texts):
        return torch.as_tensor(tokenize(texts), device=dev).long()

    return {"invert_fn": invert, "features_fn": features,
            "mapper_apply": mapper_apply, "tokenizer": tokens}


def main(argv=None, span=None):
    """``span(stage)``, when given, is a context manager around each stage
    (edits: ``text``, ``faces``, ``edit``, ``clip_image``, ``arcface``,
    ``inception``; iou: ``invert``, ``capture``, ``mapper``):
    ``chip_smoke.py`` fences, times and counts with it."""
    args = build_argparser().parse_args(argv)
    span = span or (lambda stage: contextlib.nullcontext())
    rng = random.Random(args.seed)
    session, closs = load_models(args)
    dev = session.device

    if args.mode == "edits":
        evaluator = EditEvaluator(
            edit_fn=make_edit_fn(session, args.truncation, span),
            encode_image=closs.encode_image, encode_text=closs.encode_text,
            id_extract=(load_id_extract(args.ir_se50_weights, dev)
                        if args.ir_se50_weights else None),
            fid_extract=(load_fid_extract(args.inception_ckpt, dev)
                         if args.inception_ckpt else None),
            span=span)
        seeds = [args.seed * 100_000 + i for i in range(args.iterations)]
        result = evaluator.run(seeds, sweep_prompts(args, rng, dev))
        print(json.dumps(result, default=float))
        return result

    # --- iou mode
    if not args.e4e_ckpt:
        raise SystemExit("iou mode needs --e4e_ckpt to invert the photos")
    ds = CelebAMaskHQ(args.img_path, args.label_path)
    if len(ds) == 0:
        raise SystemExit(f"no CelebAMask-HQ data under {args.img_path}")
    psp = load_psp(args)
    # the labels at the attention map's resolution (64² at layer 13)
    map_size = tap_resolution(args.attention_layer)

    pairs = (ds.load(i, 256, map_size) for i in range(min(len(ds), 90)))
    per_class, macro = calculate_iou(
        **iou_callables(session, psp, span), encode_text=closs.encode_text,
        attention_layer=args.attention_layer, image_label_pairs=pairs)
    print(json.dumps({"per_class_iou": list(map(float, per_class)),
                      "macro_iou": macro}))
    return macro


if __name__ == "__main__":
    main()

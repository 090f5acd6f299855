"""Phase-2 region-attention training CLI (counterpart of
where2edit_tpu/cli/run_attention.py), one card.

Trains a region-attention mapper against CLIP, VGG and InfoNCE with the
generator frozen. The flags pick it as the JAX CLI does:
``--work_in_stylespace --use_cluster`` the production S-space mapper
(``FullSpaceMapperFEATClusterLinStyle``, its centres from ``run_clustering``'s
``--cluster_path``), ``--use_cluster`` alone its W+ twin
(``FullSpaceMapperFEATClusterLin``), ``--work_in_stylespace`` alone
``FullSpaceMapperFEATLinStyle`` and neither ``FullSpaceMapperFEATLin``.
With it: the corpus, the region-prompt bank,
periodic checkpoints with image and attention grids and ``video.txt``, the
own-phrase renders, a SIGTERM snapshot and a bit-exact ``--resume``.
``--bf16`` synthesises in bf16 (the losses, demod and Adam stay fp32);
``--remat`` recomputes the edit synthesis in the backward pass instead of
keeping its activations.

    python -m where2edit_tpu_torch.cli.run_attention --work_in_stylespace \\
        --use_cluster --cluster_path results/k_means_layer_13_10_clusters.pkl \\
        --batch_size 8 --step 300

Runs on CUDA unless ``--device cpu`` is given (and raises without a card).
Without ``--ckpt`` / ``--clip_ckpt`` / ``--vgg_ckpt`` files the models
take seeded random weights. The grids are skipped without Pillow.
"""

from __future__ import annotations

import argparse
import datetime
import os
import random
import signal
import sys

import numpy as np
import torch

from where2edit_tpu_torch import resolve_device
from where2edit_tpu_torch.cli.common import (
    build_generator,
    load_cluster_centers,
    load_torch_state,
    mean_latent,
    snapshot_sources,
)
from where2edit_tpu_torch.editing.attention_mappers import (
    FullSpaceMapperFEATClusterLin,
    FullSpaceMapperFEATClusterLinStyle,
    FullSpaceMapperFEATLin,
    FullSpaceMapperFEATLinStyle,
)
from where2edit_tpu_torch.losses.clip_loss import CLIPLoss
from where2edit_tpu_torch.losses.perceptual import PerceptualLoss
from where2edit_tpu_torch.models.clip_model import CLIP, clip_from_state_dict
from where2edit_tpu_torch.models.clip_tokenizer import tokenize
from where2edit_tpu_torch.models.vgg import Vgg16, load_vgg16_state
from where2edit_tpu_torch.train.attention_trainer import (
    AttentionTrainConfig,
    AttentionTrainer,
)
from where2edit_tpu_torch.train.checkpoints import (
    load_mapper_checkpoint,
    save_mapper_checkpoint,
)
from where2edit_tpu_torch.train.corpus import (
    ATTENTION_PROMPTS,
    load_corpus,
    sample_training_texts,
)
from where2edit_tpu_torch.utils.images import save_image_grid
from where2edit_tpu_torch.utils.logging import Logger, MetricsWriter
from where2edit_tpu_torch.utils.seed import set_random_seed


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--description_dir", type=str, default="celeba-caption")
    p.add_argument("--description", type=str, default="a person with purple hair")
    p.add_argument("--attention_description", type=str, default="blonde hair")
    p.add_argument("--own_description_dir", type=str, default="my_phras_simple.txt")
    p.add_argument("--ckpt", type=str,
                   default="pretrained_models/stylegan2-ffhq-config-f.pt")
    p.add_argument("--clip_ckpt", type=str, default=None,
                   help="OpenAI CLIP state dict or TorchScript archive (.pt)")
    p.add_argument("--vgg_ckpt", type=str, default=None,
                   help="torchvision vgg16 state dict (.pth)")
    p.add_argument("--stylegan_size", type=int, default=1024)
    p.add_argument("--channel_multiplier", type=int, default=2)
    p.add_argument("--attention_layer", type=int, default=8)
    p.add_argument("--use_cluster", action="store_true")
    p.add_argument("--cluster_path", type=str, default=None)
    p.add_argument("--cluster_layer", type=int, default=13)
    p.add_argument("--cluster_num", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=1,
                   help="GLOBAL batch (the reference's is per GPU)")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--lambda_ess", type=float, default=0.6)
    p.add_argument("--lambda_sec", type=float, default=0.6)
    p.add_argument("--lambda_id", type=float, default=0.3)
    p.add_argument("--lambda_delta", type=float, default=0.008)
    p.add_argument("--step", type=int, default=300)
    p.add_argument("--latent_path", type=str, default=None,
                   help="train on inverted latents instead of sampled z: a "
                        "torch W+ tensor (N, n_latent, 512), W (N, 512), or "
                        "{'latents': tensor}; every synthesis reads random rows")
    p.add_argument("--text_condition", action="store_true",
                   help="condition on CLIP text encodings of corpus phrases "
                        "instead of image features")
    p.add_argument("--text_bank_size", type=int, default=256,
                   help="phrases sampled into the text-conditioning bank")
    p.add_argument("--truncation", type=float, default=0.7)
    p.add_argument("--work_in_stylespace", action="store_true")
    p.add_argument("--save_intermediate_image_every", type=int, default=20)
    p.add_argument("--results_dir", type=str, default="results")
    p.add_argument("--resume", type=str, default="",
                   help="checkpoint file written by this CLI (or a bare "
                        "mapper state dict)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 synthesis during training (losses, demod and Adam "
                        "stay fp32)")
    p.add_argument("--remat", action="store_true",
                   help="recompute the grad-pass synthesis in the backward pass: "
                        "the same numbers, one more forward")
    p.add_argument("--seed", type=int, default=200)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; cpu runs the plain versions)")
    return p


def load_clip(clip_ckpt: str | None, device) -> CLIP:
    """``--clip_ckpt``'s CLIP (a state dict, or a TorchScript archive's),
    else ViT-B/32 with seeded random weights; frozen, on ``device``."""
    if clip_ckpt and os.path.isfile(clip_ckpt):
        sd = load_torch_state(clip_ckpt)
        sd = sd.state_dict() if hasattr(sd, "state_dict") else sd
        model = clip_from_state_dict(dict(sd))
    else:
        print("[warn] no CLIP checkpoint — random weights (smoke mode)")
        model = CLIP(rng=torch.Generator().manual_seed(0))
    return model.to(device).eval().requires_grad_(False)


def load_vgg(vgg_ckpt: str | None, device) -> Vgg16:
    """``--vgg_ckpt``'s VGG16 (torchvision keys), else seeded random
    weights; frozen, on ``device``."""
    vgg = Vgg16(rng=torch.Generator().manual_seed(1))
    if vgg_ckpt and os.path.isfile(vgg_ckpt):
        load_vgg16_state(vgg, load_torch_state(vgg_ckpt))
    else:
        print("[warn] no VGG checkpoint — random weights (smoke mode)")
    return vgg.to(device).eval().requires_grad_(False)


def load_latent_bank(path: str, gen) -> torch.Tensor:
    """(N, n_latent, 512) float32 from a W+ / W tensor or {'latents': ...}."""
    lat = load_torch_state(path)
    if isinstance(lat, dict):
        if "latents" not in lat:
            raise SystemExit(
                f"--latent_path {path} is a dict checkpoint without a 'latents' "
                f"key (keys: {sorted(lat)[:8]}); expected a W/W+ tensor or "
                "{'latents': tensor}")
        lat = lat["latents"]
    lat = np.asarray(lat, dtype=np.float32)
    if lat.ndim == 2:  # W codes → W+
        lat = np.repeat(lat[:, None, :], gen.n_latent, axis=1)
    if lat.ndim != 3 or lat.shape[1] != gen.n_latent or lat.shape[2] != gen.style_dim:
        raise SystemExit(f"--latent_path shape {lat.shape} incompatible with "
                         f"(N, {gen.n_latent}, {gen.style_dim})")
    return torch.from_numpy(lat).to(gen.device)


def build_mapper(args, n_latent: int):
    """The mapper of the flags' branch, with seeded random weights (the
    cluster mappers' centres from ``--cluster_path`` when given)."""
    kw = dict(layers=n_latent, attention_layer=args.attention_layer,
              channel_multiplier=args.channel_multiplier,
              generator_size=args.stylegan_size,
              rng=torch.Generator().manual_seed(args.seed))
    if not args.use_cluster:
        cls = (FullSpaceMapperFEATLinStyle if args.work_in_stylespace
               else FullSpaceMapperFEATLin)
        return cls(**kw)
    centers = (load_cluster_centers(args.cluster_path) if args.cluster_path
               else None)
    cls = (FullSpaceMapperFEATClusterLinStyle if args.work_in_stylespace
           else FullSpaceMapperFEATClusterLin)
    mapper = cls(cluster_layer=args.cluster_layer,
                 clusters=args.cluster_num if centers is None else centers.shape[0],
                 cluster_dim=576 if centers is None else centers.shape[1], **kw)
    if centers is not None:
        mapper.initial_state.copy_(torch.from_numpy(centers))
    return mapper


def main(argv=None, span=None):
    """Returns the run's output directory. ``span(stage, trainer)``, when
    given, is a context manager around each stage of every training step
    (``AttentionTrainer``'s): ``chip_smoke.py`` fences, times and counts
    with it."""
    args = build_argparser().parse_args(argv)
    dev = resolve_device(args.device)
    rng = set_random_seed(args.seed, dev)
    host_rng = random.Random(args.seed)

    stamp = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
    exp_name = args.description.replace(" ", "-") + "-" + stamp
    output_dir = os.path.join(args.results_dir, "outputs", exp_name)
    os.makedirs(output_dir, exist_ok=True)
    snapshot_sources(output_dir)
    stdout = sys.stdout
    sys.stdout = Logger(stdout, os.path.join(output_dir, "run.log"))
    try:
        return _train(args, dev, rng, host_rng, output_dir, exp_name, span)
    finally:
        sys.stdout = stdout


def _train(args, dev, rng, host_rng, output_dir, exp_name, span):
    metrics = MetricsWriter(os.path.join(args.results_dir, "logs", exp_name))
    print("--------args----------")
    for k, v in vars(args).items():
        print(f"{k}: {v}")
    print("--------args----------\n")

    corpus = load_corpus(args.description_dir, None, args.own_description_dir,
                         host_rng)
    gen, _ = build_generator(args.stylegan_size, args.ckpt,
                             args.channel_multiplier, device=dev,
                             dtype=torch.bfloat16 if args.bf16 else torch.float32)
    mean_w = mean_latent(gen, rng)
    clip_loss = CLIPLoss(load_clip(args.clip_ckpt, dev), args.stylegan_size)
    perceptual = PerceptualLoss(load_vgg(args.vgg_ckpt, dev), args.stylegan_size)

    def encode_texts(texts):
        """CLIP text encodings, 64 phrases per batch."""
        with torch.no_grad():
            return torch.cat([clip_loss.encode_text(
                torch.from_numpy(np.asarray(tokenize(texts[i:i + 64]))).long().to(dev))
                for i in range(0, len(texts), 64)])

    latent_bank = None
    if args.latent_path:
        latent_bank = load_latent_bank(args.latent_path, gen)
        print(f"[latent_path] {latent_bank.shape[0]} inverted latents loaded")
    text_bank = None
    if args.text_condition:
        texts = (sample_training_texts(corpus, args.text_bank_size, host_rng)
                 if corpus.phrases else [args.description])
        text_bank = encode_texts(texts)
        print(f"[text_condition] bank of {text_bank.shape[0]} phrase "
              f"encodings from {len(corpus.phrases)} corpus phrases")

    mapper = build_mapper(args, gen.n_latent).to(dev)

    cfg = AttentionTrainConfig(
        stylegan_size=args.stylegan_size, attention_layer=args.attention_layer,
        cluster_layer=args.cluster_layer, batch_size=args.batch_size,
        lr=args.lr, lambda_ess=args.lambda_ess, lambda_sec=args.lambda_sec,
        lambda_id=args.lambda_id, lambda_delta=args.lambda_delta,
        step=args.step, truncation=args.truncation,
        work_in_stylespace=args.work_in_stylespace, seed=args.seed,
        remat=args.remat)
    trainer = AttentionTrainer(cfg, generator=gen, mapper=mapper,
                               clip_loss=clip_loss, perceptual=perceptual,
                               mean_latent=mean_w, latent_bank=latent_bank,
                               text_bank=text_bank, span=span)
    start_step = 0
    if args.resume:
        start_step = load_mapper_checkpoint(args.resume, trainer)
        print(f"resumed from {args.resume}; continuing at step {start_step}")

    # the region prompts, CLIP-encoded once; each step draws one
    att_bank = encode_texts(list(ATTENTION_PROMPTS))
    own_text = encode_texts(corpus.phrases_own) if corpus.phrases_own else None

    @torch.no_grad()
    def sample_eval(batch):
        """(image, the mapper's latent, taps) of fresh truncated samples
        (random rows of the latent bank with ``--latent_path``)."""
        if latent_bank is not None:
            sel = torch.randint(0, latent_bank.shape[0], (batch,), generator=rng,
                                device=dev)
        else:
            sel = torch.randn(batch, gen.style_dim, generator=rng, device=dev)
        return trainer._capture(trainer._wplus(sel))

    @torch.no_grad()
    def render_sweep(latents, feats, batch):
        """One (edited image, attention map) batch per own phrase, the
        mapper in inference mode."""
        imgs, amaps = [], []
        for p in range(own_text.shape[0]):
            text = own_text[p:p + 1].expand(batch, -1)
            new_latents, mo = trainer.mapper_forward(text, latents, feats, None,
                                                     train=False)
            imgs.append(trainer.synthesize(new_latents, mo.attention_map, feats))
            amaps.append(mo.attention_map)
        return torch.cat(imgs), torch.cat(amaps)

    _, eval_latents, eval_feats = sample_eval(1)
    video_f = open(os.path.join(output_dir, "video.txt"), "w")  # noqa: SIM115

    def checkpoint(name: str, step: int) -> str:
        return save_mapper_checkpoint(os.path.join(output_dir, name), trainer,
                                      step, vars(args))

    def callback(i, scal, img, amap):
        for name, v in scal.items():
            metrics.add_scalar(f"loss/{name}", v, i)
        every = args.save_intermediate_image_every
        if every > 0 and (i + 1) % every == 0:
            checkpoint(f"{i + 1:05d}_mapper.pt", i + 1)
            if own_text is not None:
                imgs, amaps = render_sweep(eval_latents, eval_feats, 1)
                nrow = 1
            else:
                imgs, amaps, nrow = img, amap, max(args.batch_size, 1)
            save_image_grid(imgs, os.path.join(output_dir, f"{i + 1:05d}.jpg"),
                            nrow=nrow, scale_each=True)
            save_image_grid(amaps, os.path.join(output_dir,
                                                f"attention{i + 1:05d}.jpg"),
                            nrow=nrow, value_range=(0, 1))
            video_f.write(f"file ./{i + 1:05d}.jpg\nduration 0.2\n")
        print(f"step {i}: " + "; ".join(f"{k}={v:.4f}" for k, v in scal.items()))

    # SIGTERM asks for a stop at the next step boundary, then a snapshot
    stop = {"flag": False}

    def _on_sigterm(signum, frame):
        stop["flag"] = True
        print("[preempt] SIGTERM — snapshotting at the next step boundary")

    prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        trainer.run(att_bank, log_every=1, callback=callback,
                    start_step=start_step, stop_fn=lambda: stop["flag"])
    finally:
        signal.signal(signal.SIGTERM, prev_handler)
        video_f.close()
        metrics.close()

    if stop["flag"]:
        path = checkpoint("preempt_mapper.pt", trainer.steps_completed)
        print(f"[preempt] snapshot at step {trainer.steps_completed} → {path}")
        return output_dir
    checkpoint("final_mapper.pt", trainer.steps_completed)

    if own_text is not None:
        # originals row, then one row of edits per own phrase
        n = max(1, min(4, 2 * args.batch_size))
        img0, latents, feats = sample_eval(n)
        imgs, amaps = render_sweep(latents, feats, n)
        save_image_grid(torch.cat([img0, imgs]),
                        os.path.join(output_dir, "final_result.jpg"),
                        nrow=n, scale_each=True)
        save_image_grid(amaps, os.path.join(output_dir, "final_attention.jpg"),
                        nrow=n, value_range=(0, 1), scale_each=True)
    print(f"done → {output_dir}")
    return output_dir


if __name__ == "__main__":
    main()

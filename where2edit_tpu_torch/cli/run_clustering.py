"""Phase-1 semantic-region discovery CLI (counterpart of
where2edit_tpu/cli/run_clustering.py).

Samples truncated latents, collects one feature tap (plus position
channels, bilinear ×2) per face, fits k-means, pickles the centres as
``k_means_layer_{L}_{K}_clusters.pkl`` and renders a cluster-overlay grid
(skipped without Pillow).

    python -m where2edit_tpu_torch.cli.run_clustering --stylegan_size 1024 \\
        --attention_layer 13 --cluster_num 10 --batch_size 5 --step 20

Runs on CUDA unless ``--device cpu`` is given (and raises without a card);
the fit runs on the host (sklearn, else the native C++ Lloyd). ``--dp N``
collects the features on N ranks, one process per card (``--device cpu``:
N gloo processes): each synthesises its rows of every step's batch, and
rank 0 gathers the matrix in the one-process order, fits, writes the pickle
and renders the grid.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os

import torch

from where2edit_tpu_torch import resolve_device
from where2edit_tpu_torch.cli.common import (
    add_dp_args,
    build_generator,
    dp_entry,
    mean_latent,
    save_pickle,
)
from where2edit_tpu_torch.editing.clustering import (
    assign_clusters,
    cluster_features,
    kmeans_fit,
)
from where2edit_tpu_torch.ops.interpolate import interpolate_nearest
from where2edit_tpu_torch.parallel import dist
from where2edit_tpu_torch.utils.images import save_image_grid
from where2edit_tpu_torch.utils.seed import set_random_seed


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", type=str,
                   default="pretrained_models/stylegan2-ffhq-config-f.pt")
    p.add_argument("--stylegan_size", type=int, default=1024)
    p.add_argument("--channel_multiplier", type=int, default=2)
    p.add_argument("--attention_layer", type=int, default=13)
    p.add_argument("--cluster_num", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=5)
    p.add_argument("--step", type=int, default=20)
    p.add_argument("--truncation", type=float, default=0.7)
    p.add_argument("--seed", type=int, default=200)
    p.add_argument("--results_dir", type=str, default="results")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; cpu runs the plain versions)")
    add_dp_args(p, multihost=False)
    return p


@torch.no_grad()
def synthesize_tap(gen, wplus, layer: int):
    """(image, tap ``layer - 1``) of one synthesis from W+; no other tap is
    stored."""
    out = gen([wplus], input_is_latent=True, randomize_noise=False,
              return_features=True, tap_indices=(layer - 1,))
    return out.image, out.feature_map[layer - 1]


@torch.no_grad()
def truncated_wplus(gen, mean_w, z, truncation: float):
    w = gen.style_mlp(z)
    w = mean_w + truncation * (w - mean_w)
    return w[:, None, :].expand(-1, gen.n_latent, -1)


@torch.no_grad()
def collect_features(gen, mean_w, rng, *, layer: int, batch: int, steps: int,
                     truncation: float = 0.7) -> torch.Tensor:
    """The clustering matrix of ``steps`` batches of fresh faces, on the
    generator's device: (steps·batch·S·S, C + 2·C/16), S twice the tap's
    side. In a data-parallel group, this rank's rows of each step's batch
    (every rank draws the whole batch)."""
    data = None
    for i in range(steps):
        z = dist.rows(torch.randn(batch, gen.style_dim, generator=rng, device=gen.device))
        _, tap = synthesize_tap(gen, truncated_wplus(gen, mean_w, z, truncation),
                                layer)
        cf = cluster_features(tap, upsample2=True)
        if data is None:
            data = cf.new_empty((steps * cf.shape[0], cf.shape[1]))
        data[i * cf.shape[0]:(i + 1) * cf.shape[0]] = cf
    return data


def main(argv=None, span=None):
    """Returns the pickle's path (None when ``--dp`` spawned its ranks).
    ``span(stage)``, when given, is a context manager around each stage:
    collect, fit, visualize."""
    args = build_argparser().parse_args(argv)
    return dp_entry(args, functools.partial(_main, span=span), batch_flag="batch_size")


def _main(args, span=None):
    span = span or (lambda stage: contextlib.nullcontext())
    dev = resolve_device(args.device)
    rng = set_random_seed(args.seed, dev)
    gen, _ = build_generator(args.stylegan_size, args.ckpt,
                             args.channel_multiplier, device=dev)
    mean_w = mean_latent(gen, rng)

    out_path = os.path.join(
        args.results_dir,
        f"k_means_layer_{args.attention_layer}_{args.cluster_num}_clusters.pkl")
    with span("collect"):
        data = dist.gather_rows(
            collect_features(gen, mean_w, rng, layer=args.attention_layer,
                             batch=args.batch_size, steps=args.step,
                             truncation=args.truncation), steps=args.step)
    if not dist.is_main():
        return out_path
    data = data.cpu().numpy()
    print(f"clustering matrix: {data.shape}")
    with span("fit"):
        centers = kmeans_fit(data, args.cluster_num)

    os.makedirs(args.results_dir, exist_ok=True)
    save_pickle(centers, out_path)
    print(f"saved centers → {out_path}")

    with span("visualize"), torch.no_grad():
        z = torch.randn(4, gen.style_dim, generator=rng, device=dev)
        img, blend = synthesize_tap(gen, truncated_wplus(gen, mean_w, z,
                                                         args.truncation),
                                    args.attention_layer)
        ids = assign_clusters(blend, torch.from_numpy(centers).to(dev),
                              offset_per_sample=False)
        colors = (torch.rand(args.cluster_num, 3, generator=rng, device=dev)
                  - 0.5) * 2
        overlay = interpolate_nearest(colors[ids], args.stylegan_size)
        blended = overlay * 0.7 + img * 0.3
        save_image_grid(img, os.path.join(args.results_dir, "final_result.jpg"),
                        nrow=4, scale_each=True)
        save_image_grid(blended, os.path.join(args.results_dir,
                                              "final_cluster.jpg"),
                        nrow=4, scale_each=True)
    return out_path


if __name__ == "__main__":
    main()

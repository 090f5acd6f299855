"""StyleCLIP mapper inference CLI (counterpart of
where2edit_tpu/cli/mapper_inference.py), one card, fp32.

Reads a ``cli/mapper_train.py`` checkpoint (or a reference StyleCLIP
``.pt``), takes the mapper's architecture and the generator's size and
weights from the options stored in it unless a flag given here overrides
them, then edits a latent file batch by batch: ``w + 0.1·mapper(w)``,
decoded with fixed noise. Writes ``inference_results/{i:05d}.jpg`` (with
``--couple_outputs`` the original beside the edit), ``latents_{i:05d}.npy``
per batch and ``stats.txt`` (mean ± std of the per-batch time after the
first):

    python -m where2edit_tpu_torch.cli.mapper_inference --exp_dir exp \\
        --checkpoint_path exp/checkpoints/best_model.pt \\
        --latents_test_path test_faces.pt --couple_outputs

Runs on CUDA unless ``--device cpu`` is given (and raises without a card).
As the JAX CLI, it edits in W+ only: a ``work_in_stylespace`` checkpoint is
refused.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from where2edit_tpu_torch import resolve_device
from where2edit_tpu_torch.cli.common import build_generator, load_torch_state
from where2edit_tpu_torch.editing.latent_mappers import stylespace_count
from where2edit_tpu_torch.editing.styleclip_mapper import StyleCLIPMapper, build_mapper
from where2edit_tpu_torch.models.psp import get_keys
from where2edit_tpu_torch.utils.images import save_image_grid

# fallbacks when neither the checkpoint opts nor the CLI provide a value
DEFAULTS = {
    "couple_outputs": False,
    "work_in_stylespace": False,
    "mapper_type": "LevelsMapper",
    "no_coarse_mapper": False,
    "no_medium_mapper": False,
    "no_fine_mapper": False,
    "stylegan_size": 1024,
    "stylegan_weights": "pretrained_models/stylegan2-ffhq-config-f.pt",
    "test_batch_size": 2,
    "n_images": None,
}


def build_argparser() -> argparse.ArgumentParser:
    # optional flags default to SUPPRESS: an absent flag stays out of the
    # namespace, so it overrides no option stored in the checkpoint
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                argument_default=argparse.SUPPRESS)
    p.add_argument("--exp_dir", type=str, required=True)
    p.add_argument("--checkpoint_path", type=str, required=True)
    p.add_argument("--latents_test_path", type=str, required=True)
    p.add_argument("--couple_outputs", action="store_true")
    p.add_argument("--work_in_stylespace", action="store_true")
    p.add_argument("--mapper_type", type=str)
    p.add_argument("--no_coarse_mapper", action="store_true")
    p.add_argument("--no_medium_mapper", action="store_true")
    p.add_argument("--no_fine_mapper", action="store_true")
    p.add_argument("--stylegan_size", type=int)
    p.add_argument("--stylegan_weights", type=str)
    p.add_argument("--test_batch_size", type=int)
    p.add_argument("--n_images", type=int)
    p.add_argument("--device", type=str,
                   help="torch device (default: cuda; cpu runs the plain versions)")
    return p


def resolve_opts(cli_args: dict, ckpt_opts: dict | None) -> dict:
    """DEFAULTS ← checkpoint opts ← explicit CLI flags."""
    opts = dict(DEFAULTS)
    opts.update(ckpt_opts or {})
    opts.update(cli_args)
    return opts


def main(argv=None) -> str:
    """Returns the results directory."""
    args = vars(build_argparser().parse_args(argv))
    # the device is this run's, never the training run's stored option
    dev = resolve_device(args.pop("device", None))
    ckpt = load_torch_state(args["checkpoint_path"])
    opts = resolve_opts(args, ckpt.get("opts"))
    if opts["work_in_stylespace"]:
        raise SystemExit(
            f"{args['checkpoint_path']} is a work_in_stylespace checkpoint; "
            "this CLI edits W+ latents only, as the reference's does")

    size = int(opts["stylegan_size"])
    mapper = build_mapper(opts["mapper_type"], **opts,
                          n_styles=stylespace_count(size))
    mapper.load_state_dict(get_keys(ckpt, "mapper"))
    gen, latent_avg = build_generator(size, opts["stylegan_weights"], device=dev)
    net = StyleCLIPMapper(mapper.to(dev).eval(), gen, latent_avg)

    latents = torch.as_tensor(np.asarray(load_torch_state(args["latents_test_path"]),
                                         np.float32))
    if opts["n_images"]:
        latents = latents[: int(opts["n_images"])]

    out_dir = os.path.join(args["exp_dir"], "inference_results")
    os.makedirs(out_dir, exist_ok=True)
    couple = bool(opts["couple_outputs"])

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    times = []
    bs = int(opts["test_batch_size"])
    with torch.no_grad():
        for i in range(0, len(latents), bs):
            w = latents[i: i + bs].to(dev)
            sync()
            t0 = time.time()
            img, w_hat = net.edit(w)
            orig = gen([w], input_is_latent=True, randomize_noise=False).image \
                if couple else None
            sync()
            times.append(time.time() - t0)
            for j in range(img.shape[0]):
                # original | edited side by side
                pair = img[j:j + 1] if orig is None else torch.cat(
                    [orig[j:j + 1], img[j:j + 1]])
                save_image_grid(pair, os.path.join(out_dir, f"{i + j:05d}.jpg"),
                                nrow=pair.shape[0])
            np.save(os.path.join(out_dir, f"latents_{i:05d}.npy"),
                    w_hat.cpu().numpy())

    stats = (f"Runtime {np.mean(times[1:]):.4f}+-{np.std(times[1:]):.4f}"
             if len(times) > 1 else f"Runtime {times[0]:.4f}")
    with open(os.path.join(out_dir, "stats.txt"), "w") as f:
        f.write(stats)
    print(stats)
    return out_dir


if __name__ == "__main__":
    main()

"""Shared CLI plumbing (counterpart of where2edit_tpu/cli/common.py):
checkpoint loading, the generator, the mean latent, pickles, the source
snapshot of a run, the data-parallel flags and the SIGTERM stop."""

from __future__ import annotations

import os
import pickle
import shutil
import signal

import numpy as np
import torch

from where2edit_tpu_torch import resolve_device
from where2edit_tpu_torch.models.stylegan2 import Generator
from where2edit_tpu_torch.parallel import dist


def add_dp_args(p, multihost: bool = True) -> None:
    """``--dp`` (and ``--multihost``), as the JAX CLIs name them."""
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel over N ranks, one process per card (gloo "
                        "processes with --device cpu): the global batch is split "
                        "evenly; -1 = every visible card (2 processes on the CPU); "
                        "0 = one process, no group")
    if multihost:
        p.add_argument("--multihost", action="store_true",
                       help="join the process group torchrun describes in the "
                            "environment (env://) and run as its rank")


def available_devices(device) -> int:
    """Cards a group may span (CPU cores with ``device`` cpu)."""
    if torch.device(device or "cuda").type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def dp_entry(args, main_fn, batch_flag: str = "batch", dp: int | None = None):
    """``main_fn(args)`` as the data-parallel flags ask. In a group already
    (``--multihost`` under torchrun, or a caller's) every rank runs it
    there; ``dp`` (``args.dp`` by default) 0 runs it in this process with no
    group; else ``dp`` ranks are launched (``parallel.dist.launch``: a world
    of one in this process, which returns ``main_fn``'s value; a larger one
    in spawned processes, which returns None). The global batch
    ``args.<batch_flag>`` must split evenly. Ranks other than 0 print
    nothing."""
    dp = args.dp if dp is None else dp
    batch = getattr(args, batch_flag)
    resolve_device(args.device)  # no card and no --device cpu: refuse first
    if getattr(args, "multihost", False) and dist.initialize_multihost(args.device):
        print(f"[multihost] rank {dist.rank()} of {dist.world()}")
    if dist.in_group():
        if dp > 0 and dp != dist.world():
            raise SystemExit(f"--dp {dp} does not match the group's "
                             f"{dist.world()} ranks")
        if batch % dist.world():
            raise SystemExit(f"--{batch_flag} {batch} not divisible by --dp "
                             f"{dist.world()}")
        return _rank_main(main_fn, args)
    if dp == 0:
        return main_fn(args)
    n_dev = available_devices(args.device)
    cpu = torch.device(args.device or "cuda").type == "cpu"
    n = (2 if cpu else n_dev) if dp == -1 else dp
    if n > n_dev:
        raise SystemExit(f"--dp {n} exceeds the {n_dev} available devices")
    if batch % n:
        raise SystemExit(f"--{batch_flag} {batch} not divisible by --dp {n}")
    print(f"[dp] {n} ranks ({'gloo' if cpu else 'nccl'}), --{batch_flag} "
          f"{batch // n} each")
    return dist.launch(_rank_main, n, args.device, main_fn, args)


def _rank_main(main_fn, args):
    with dist.quiet_unless_main():
        return main_fn(args)


class Preemption:
    """SIGTERM asks for a stop at the next step boundary. Call the object at
    each step boundary: True from the first boundary at which any rank of
    the group has had the signal, on every rank at once (``stopped`` stays
    set). Use it as a context manager, which installs the handler and puts
    the previous one back."""

    def __init__(self, message: str):
        self.message = message
        self.flag = self.stopped = False

    def _on_sigterm(self, signum, frame):
        self.flag = True
        print(self.message)

    def __call__(self) -> bool:
        self.stopped = self.stopped or dist.any_rank(self.flag)
        return self.stopped

    def __enter__(self):
        self._prev = signal.signal(signal.SIGTERM, self._on_sigterm)
        return self

    def __exit__(self, *exc):
        signal.signal(signal.SIGTERM, self._prev)
        return False


def load_torch_state(path: str):
    """``torch.load`` onto the CPU; returns the raw object. Full unpickling
    (pSp / e4e checkpoints carry their training options), so the file must
    be one the operator trusts."""
    return torch.load(path, map_location="cpu", weights_only=False)


def snapshot_sources(output_dir: str) -> str:
    """Copy the package's sources into the run directory (the reference
    copies its scripts per run); build outputs are left out."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code_dir = os.path.join(output_dir, "code", "where2edit_tpu_torch")
    shutil.copytree(pkg_root, code_dir, dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc", "*.so",
                                                  "_build"))
    return code_dir


def build_generator(size: int, ckpt_path: str | None,
                    channel_multiplier: int = 2, device=None, seed: int = 0,
                    dtype: torch.dtype = torch.float32):
    """(generator on ``device``, latent_avg or None): the ``g_ema`` of
    ``ckpt_path`` (or the whole file as a state dict) when that file exists,
    else seeded random weights drawn on the CPU. ``dtype=torch.bfloat16``
    synthesises in bf16 (the trainers' ``--bf16``); the parameters, the
    modulation, demod and the RGB chain stay fp32."""
    gen = Generator(size, channel_multiplier=channel_multiplier,
                    rng=torch.Generator().manual_seed(seed), dtype=dtype)
    latent_avg = None
    if ckpt_path and os.path.isfile(ckpt_path):
        ckpt = load_torch_state(ckpt_path)
        gen.load_state_dict(ckpt.get("g_ema", ckpt))
        if ckpt.get("latent_avg") is not None:
            latent_avg = torch.as_tensor(ckpt["latent_avg"]).float().to(device)
    return gen.to(device).eval(), latent_avg


def mean_latent(gen, rng: torch.Generator, n: int = 4096) -> torch.Tensor:
    """(1, 512) mean of ``n`` mapped z drawn from ``rng``."""
    with torch.no_grad():
        return gen.mean_latent(n, rng)


def save_pickle(obj, path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_cluster_centers(path: str) -> np.ndarray:
    """k-means centres from a pickle (numpy, or a tensor) → float32 numpy."""
    with open(path, "rb") as f:
        centers = pickle.load(f)
    if hasattr(centers, "numpy"):
        centers = centers.numpy()
    return np.asarray(centers, dtype=np.float32)

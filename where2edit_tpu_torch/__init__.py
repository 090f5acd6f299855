"""where2edit_tpu_torch: the PyTorch + CUDA port of where2edit_tpu.

The package mirrors the JAX package's layout (``ops/``, ``nn/``,
``models/``, ``editing/``, ``demo/``, ``train/``, ``cli/``) and adds ``csrc/`` (CUDA C++
sources for Hopper, ``sm_90a``) and ``kernels/`` (their ctypes-bound
wrappers, each beside its plain PyTorch version).

Conventions shared with the JAX package so the two can be held against each
other: activations are NHWC at every public function; parameters use the
reference rosinality / OpenAI-CLIP state-dict key layout.

Precision is fp32 on the card. TF32 is disabled for matmuls and cuDNN
convolutions by ``resolve_device`` (cuDNN's default ``allow_tf32=True``
would put the up-conv below fp32).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Never falls back to the CPU: with no card and no explicit
    ``device="cpu"`` it raises. On a CUDA device it also sets the fp32
    policy (no TF32 in matmuls or cuDNN convolutions)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev

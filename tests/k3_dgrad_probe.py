"""How far the discriminator's gradient in chip_smoke.py phase 17d moves
when the bf16 ToRGBs' fp32 sums change in their last bits, on the CPU.

    python tests/k3_dgrad_probe.py [SIZE [CHANNEL_MULTIPLIER]]

17d holds one bf16 GAN iteration (64², channel multiplier 2, batch 4) on
the card against the CPU; its D program's whole-model gradient must agree
within 5e-2 (relative L2). This script runs that D program on the CPU
only, from 17d's state and draws, once with ``modconv1x1_plain`` as the
bf16 ToRGB (the reference) and once with each variant of the ToRGB's sums
in its place, and prints per variant the D gradient's relative L2 distance
from the reference and the ToRGB outputs' rms deviation from the
reference's: a random perturbation of 1e-7 and 1e-6 of each value, the
bf16 core's tensor-core sums in two and three bf16 parts
(``tests/test_torch_k3_bf16_core.py::_core_emulation``), its FMA form (the
FMA kernel's order), a plain sequential fp32 sum and an fp64-exact one.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_k3_bf16_core import _core_emulation  # noqa: E402

from where2edit_tpu_torch.kernels import modconv1x1 as k3  # noqa: E402
from where2edit_tpu_torch.kernels.common import plain_epilogue  # noqa: E402
from where2edit_tpu_torch.train.gan_trainer import GANTrainConfig, GANTrainer  # noqa: E402

PLAIN = k3.modconv1x1_plain


def _finish(y, x, demod, noise, noise_weight, bias, act, residual, out_dtype):
    if demod is not None:
        y = y * demod[:, None, :]
    res = None if residual is None else residual.float()
    return plain_epilogue(y, noise, noise_weight, bias, act, res).to(out_dtype or x.dtype)


def _bf16_only(sums):
    """A K3 twin whose bf16 calls take ``sums(x fp32, style, w)``."""
    def fn(x, style, w, demod=None, noise=None, noise_weight=None, bias=None, act=False,
           residual=None, out_dtype=None):
        if x.dtype != torch.bfloat16:
            return PLAIN(x, style, w, demod, noise, noise_weight, bias, act, residual,
                         out_dtype)
        return _finish(sums(x.float(), style, w), x, demod, noise, noise_weight, bias, act,
                       residual, out_dtype)
    return fn


def _emulated(parts):
    def fn(x, style, w, demod=None, noise=None, noise_weight=None, bias=None, act=False,
           residual=None, out_dtype=None):
        if x.dtype != torch.bfloat16:
            return PLAIN(x, style, w, demod, noise, noise_weight, bias, act, residual,
                         out_dtype)
        res = None if residual is None else residual.float()
        y = _core_emulation(x, style, w, demod, noise, noise_weight, bias, act, res,
                            parts=parts)
        return y.to(out_dtype or x.dtype)
    return fn


def _perturbed(eps):
    gen = torch.Generator().manual_seed(5)

    def fn(*args, **kw):
        y = PLAIN(*args, **kw)
        if args[0].dtype == torch.bfloat16 and y.dtype == torch.float32:
            y = y * (1 + eps * torch.randn(y.shape, generator=gen))
        return y
    return fn


def _sequential(x, style, w):
    f = style[:, :, None] * w[None]
    acc = torch.zeros(x.shape[0], x.shape[1], w.shape[1])
    for i in range(x.shape[2]):
        acc = acc + x[:, :, i:i + 1] * f[:, i:i + 1, :]
    return acc


def _exact(x, style, w):
    return torch.einsum("bpi,bi,io->bpo", x.double(), style.double(), w.double()).float()


def main(size: int = 64, channel_multiplier: int = 2) -> None:
    torch.set_num_threads(8)
    batch = 4  # 17d's iteration (chip_smoke.train_whole)
    cfg = GANTrainConfig(size=size, batch_size=batch, channel_multiplier=channel_multiplier,
                         bf16=True, d_bf16=True)
    cpu = GANTrainer(cfg, device="cpu")
    real = torch.from_numpy(np.random.default_rng(0).uniform(
        -1.0, 1.0, (batch, size, size, 3)).astype(np.float32))
    draws = cpu.draw(batch)
    g = torch.Generator().manual_seed(1)
    for name, p in cpu.g.named_parameters():
        if name.endswith("noise.weight"):
            p.data.copy_(0.1 * torch.randn(1, generator=g))
    state = {m: {k: v.clone() for k, v in getattr(cpu, m).state_dict().items()}
             for m in ("g", "d")}
    deviations = []

    def d_grad(variant):
        for m in ("g", "d"):
            getattr(cpu, m).load_state_dict(state[m])
            getattr(cpu, m).zero_grad(set_to_none=True)

        def tracked(*args, **kw):
            y = variant(*args, **kw)
            if args[0].dtype == torch.bfloat16 and y.dtype == torch.float32:
                ref = PLAIN(*args, **kw)
                deviations.append((float((y - ref).square().sum()), float(ref.square().sum())))
            return y
        k3.modconv1x1_plain = tracked
        try:
            cpu.d_step_with(real, draws)
        finally:
            k3.modconv1x1_plain = PLAIN
        return torch.cat([p.grad.double().flatten() for p in cpu.d.parameters()
                          if p.grad is not None])

    ref = d_grad(PLAIN)
    for name, variant in [("perturbed 1e-7", _perturbed(1e-7)),
                          ("perturbed 1e-6", _perturbed(1e-6)),
                          ("tensor cores, 2 parts", _emulated(2)),
                          ("tensor cores, 3 parts", _emulated(3)),
                          ("FMA form", _emulated("fma")),
                          ("sequential fp32", _bf16_only(_sequential)),
                          ("fp64 exact", _bf16_only(_exact))]:
        deviations.clear()
        got = d_grad(variant)
        dev = (sum(a for a, _ in deviations) / sum(b for _, b in deviations)) ** 0.5
        print(f"{name:24s} D gradient rel L2 {float((got - ref).norm() / ref.norm()):.4f}"
              f"  ToRGB rms deviation {dev:.2e}", flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))

"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version and a launch counter:

  * ``modconv3x3`` (K1) — replaces tools/conv3x3_bench.py::conv3x3_mod_fused
  * ``modconv1x1`` (K3) — replaces tools/pallas_bench.py::modulated_conv1x1
"""

from where2edit_tpu_torch.kernels import modconv1x1, modconv3x3

__all__ = ["modconv1x1", "modconv3x3"]

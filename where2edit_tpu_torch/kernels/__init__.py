"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version and a launch counter, each a twice-differentiable autograd Function:

  * ``modconv3x3`` (K1) — replaces tools/conv3x3_bench.py::conv3x3_mod_fused
  * ``conv3x3`` (K2) — replaces tools/conv3x3_bench.py::conv3x3_fused
  * ``modconv1x1`` (K3) — replaces tools/pallas_bench.py::modulated_conv1x1
"""

from where2edit_tpu_torch.kernels import conv3x3, modconv1x1, modconv3x3

__all__ = ["conv3x3", "modconv1x1", "modconv3x3"]

"""Operations and bytes per photo of the e4e encoder (``reference/e4e.py``)
at the configuration's widths, and of the whole photo edit.

Counted from the shapes, forward only, in float32: every conv and linear (2
per multiply-add, plus its bias), BN (an affine per value, 2), PReLU (2),
the SE gate (its mean, two 1x1 convs, the sigmoid, the product), the
shortcut (a strided copy, or a 1x1 conv and BN), the residual add and the
FPN's bilinear up-and-add (4 products and 3 sums a value, plus the add).
Bytes: each op's input and output values once, and each weight once per
batch (its share per photo).
"""

from __future__ import annotations

import math

from port_bench.reference import e4e as ref_e4e
from port_bench.work import edit as work_edit
from port_bench.work import stylegan2 as sg

F32 = 4


class _Tally:
    def __init__(self, batch: int):
        self.batch, self.flops, self.values, self.weights = batch, 0, 0, 0

    def conv(self, h_out: int, cin: int, cout: int, k: int, bias: bool, h_in: int) -> None:
        self.flops += h_out * h_out * cout * (2 * cin * k * k + (1 if bias else 0))
        self.values += h_in * h_in * cin + h_out * h_out * cout
        self.weights += cout * cin * k * k + (cout if bias else 0)

    def elementwise(self, n_in: int, n_out: int, flops: int, weights: int = 0) -> None:
        self.flops += flops
        self.values += n_in + n_out
        self.weights += weights


def counts(ecfg: dict, batch: int) -> dict:
    """{"flops", "bytes"} per photo of ``Encoder4Editing`` (every block
    that the progressive stage runs) on a ``ecfg["input_size"]``² photo."""
    t = _Tally(batch)
    h = ecfg["input_size"]
    t.conv(h, 3, 64, 3, False, h)
    t.elementwise(h * h * 64, h * h * 64, 2 * h * h * 64, 4 * 64)      # BN
    t.elementwise(h * h * 64, h * h * 64, 2 * h * h * 64, 64)          # PReLU
    taps = {}
    se = ecfg["mode"] == "ir_se"
    for i, (cin, depth, stride) in enumerate(ref_e4e.units(ecfg["num_layers"])):
        ho = h // stride
        n_in, n_mid, n_out = h * h * cin, h * h * depth, ho * ho * depth
        t.elementwise(n_in, n_in, 2 * n_in, 4 * cin)                     # BN
        t.conv(h, cin, depth, 3, False, h)
        t.elementwise(n_mid, n_mid, 2 * n_mid, depth)                    # PReLU
        t.conv(ho, depth, depth, 3, False, h)
        t.elementwise(n_out, n_out, 2 * n_out, 4 * depth)                # BN
        if se:
            r = depth // 16
            t.elementwise(n_out, n_out, n_out + 4 * depth * r + 4 * depth + n_out,
                          2 * depth * r)
        if cin == depth:
            t.elementwise(n_out, n_out, 0)                               # strided copy
        else:
            t.conv(ho, cin, depth, 1, False, h)
            t.elementwise(n_out, n_out, 2 * n_out, 4 * depth)            # BN
        t.elementwise(2 * n_out, n_out, n_out)                           # the residual add
        h = ho
        if i in ref_e4e.FPN_TAPS:
            taps[i] = (h, depth)
    (h1, w1), (h2, w2), (h3, _) = (taps[i] for i in ref_e4e.FPN_TAPS)
    for (hl, cl), hs in (((h2, w2), h3), ((h1, w1), h2)):               # laterals, up-and-add
        t.conv(hl, cl, 512, 1, True, hl)
        n = hl * hl * 512
        t.elementwise(hs * hs * 512 + n, n, 8 * n)
    n = 2 * int(math.log2(ecfg["stylegan_size"])) - 2
    width = {16: h3, 32: h2, 64: h1}
    for i in range(min(ecfg["progressive_stage"] + 1, n)):
        spatial = ref_e4e.block_spatial(i, ecfg["coarse_ind"], ecfg["middle_ind"])
        hi = width[spatial]
        for _ in range(int(math.log2(spatial))):
            ho = max((hi + 1) // 2, 1)
            t.conv(ho, 512, 512, 3, True, hi)
            t.elementwise(ho * ho * 512, ho * ho * 512, ho * ho * 512)  # leaky ReLU
            hi = ho
        t.conv(1, 512, 512, 1, True, 1)                                  # EqualLinear
        if i:
            t.elementwise(1024, 512, 512)                                # w0 + delta
    t.elementwise(n * 512, n * 512, n * 512, n * 512)                    # + latent_avg
    return {"flops": t.flops, "bytes": F32 * (t.values + t.weights / batch)}


def per_photo_edit(cfg: dict, traffic: dict) -> dict:
    """{"flops_per_unit": the whole photo edit (e4e, then the edit of
    ``work/edit.py`` less the seeded W+ style MLP, which a photo does not
    run), "kernel_bound_s_per_unit": the edit's kernel bounds (its K1 and K3
    calls are the edit's), and "e4e": e4e's least time per photo}."""
    ecfg, peaks = cfg["encoder"], cfg["precision"]
    e = counts(ecfg, traffic["batch"])
    edit = work_edit.per_edit(cfg, traffic)
    mlp = 2 * sg.synthesis_macs(cfg["generator"])["mlp"]
    return {"flops_per_unit": e["flops"] + edit["flops_per_unit"] - mlp,
            "e4e_flops_per_unit": e["flops"], "e4e_bytes_per_unit": e["bytes"],
            "kernel_bound_s_per_unit": dict(edit["kernel_bound_s_per_unit"],
                                            e4e=work_edit.bound_s(e["bytes"], e["flops"],
                                                                  peaks))}

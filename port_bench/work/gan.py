"""Operations per trained sample of a StyleGAN2 training iteration, and the
least time K1 and K2 need for a sample's share of their calls.

Per iteration at batch B (path batch B/shrink), averaged over the lazy
regularisers' cadence:

- ``d``: the fake batch (G forward, no gradient, two style-MLP passes),
  D forward on the real and the fake batch, D backward (input and weight
  gradients): B·G + 6·B·D.
- ``g``: G forward and backward (input and weight gradients), D forward and
  its input gradient only (D is frozen): 3·B·G + 2·B·D.
- ``r1`` every ``d_reg_every``: D forward and input gradient, then the
  backward of both (twice their cost): 6·B·D.
- ``path`` every ``g_reg_every``: G forward, the gradient with respect to
  W+ (input and style gradients), then the backward of all three (twice
  their cost): 9·(B/shrink)·G.

G is one image's synthesis (convs, ToRGBs, blurs) plus its style MLP and
affines, D one image through the discriminator. No recomputation is
counted; the EMA and Adam are elementwise and not counted.

K1's calls per iteration (the generator's non-resampling 3x3 convs): d 1×
at B; g 2× (forward, input gradient) at B; path 4× at B/shrink (forward,
input gradient, and the backward of each). K2's (the discriminator's
stride-1 3x3 convs): d 4× at B (forward and input gradient, real and
fake); g 2× at B; r1 4× at B. The port's launch counters read one call
fewer in each path program (35 of 36) and each R1 program (35 of 36) on
the card; the call left out here is the one at the smallest layer (4²),
whose bound is under 0.1 % of the program's.
"""

from __future__ import annotations

from port_bench.work import stylegan2 as sg
from port_bench.work.edit import bound_s


def per_sample(cfg: dict, traffic: dict) -> dict:
    g, d, tr, peaks = cfg["generator"], cfg["discriminator"], cfg["train"], cfg["precision"]
    b = traffic["batch"]
    pb = max(1, b // tr["path_batch_shrink"])
    r1 = 1.0 / tr["d_reg_every"] if tr["d_reg_every"] > 0 else 0.0
    path = 1.0 / tr["g_reg_every"] if tr["g_reg_every"] > 0 else 0.0
    G = sg.synthesis_flops(g)
    D = sg.discriminator_flops(d)
    flops = (b * G + 6 * b * D) + (3 * b * G + 2 * b * D) + r1 * 6 * b * D + path * 9 * pb * G
    k1_call = sum(bound_s(*sg.conv3x3_call(b, h, ci, co), peaks) for h, ci, co in sg.k1_calls(g))
    k1_path = [bound_s(*sg.conv3x3_call(pb, h, ci, co), peaks) for h, ci, co in sg.k1_calls(g)]
    k2_calls = [bound_s(*sg.conv3x3_call(b, h, ci, co), peaks) for h, ci, co in sg.k2_calls(d)]
    k2_call = sum(k2_calls)
    n1, n2 = len(sg.k1_calls(g)), len(sg.k2_calls(d))
    k1 = 3 * k1_call + path * (4 * sum(k1_path) - min(k1_path))
    k2 = 6 * k2_call + r1 * (4 * k2_call - min(k2_calls))
    return {"flops_per_unit": flops / b,
            "kernel_bound_s_per_unit": {"k1": k1 / b, "k2": k2 / b},
            "kernel_calls_per_step": {"k1": 3 * n1 + path * (4 * n1 - 1),
                                      "k2": 6 * n2 + r1 * (4 * n2 - 1)}}

"""Operations per trained sample of a region-attention mapper step, and
the least time K1 needs for a sample's share of its calls.

Per step at batch B: the edit target's capture (one image) and the
conditioning batch's synthesis without gradient (1 + B syntheses), CLIP's
image tower on the conditioning batch (B), the mapper forward and backward,
the edit synthesis forward and its backward to the styles (input and
style gradients: 3·B syntheses), CLIP's image tower on the edited batch
forward and to its input (2·B), and VGG16 through relu2_2 on the edited
batch forward and to its input (2·B) and on the target (1). A synthesis
counts its convs, ToRGBs and blurs; the nearest ×7 / average-pool resize
to 224² and the elementwise losses are not counted. No recomputation.

K1's calls per step: 9 forward at batch 1 (the capture), 9 at B (the
conditioning batch), 9 at B (the edit) and 8 input gradients at B (every
conv but the first, whose input is the frozen constant).
"""

from __future__ import annotations

from port_bench.work import stylegan2 as sg
from port_bench.work.edit import bound_s, mapper_flops


def clip_image_flops(c: dict) -> int:
    n = (c["resolution"] // c["patch_size"]) ** 2 + 1
    d = c["width"]
    per_layer = n * (4 * d * d + 2 * d * 4 * d) + 2 * n * n * d
    patch = (n - 1) * 3 * c["patch_size"] ** 2 * d
    return 2 * (c["layers"] * per_layer + patch + d * c["output_dim"])


def vgg_relu2_2_flops(size: int = 224) -> int:
    h = size
    macs = h * h * 9 * (3 * 64 + 64 * 64) + (h // 2) ** 2 * 9 * (64 * 128 + 128 * 128)
    return 2 * macs


def per_sample(cfg: dict, traffic: dict) -> dict:
    g, peaks = cfg["generator"], cfg["precision"]
    b = traffic["batch"]
    parts = sg.synthesis_macs(g)
    syn = 2 * (parts["conv"] + parts["torgb"] + parts["blur"])
    mlp = 2 * parts["mlp"]
    c, v = clip_image_flops(cfg["clip_image"]), vgg_relu2_2_flops()
    flops = ((1 + b) * (syn + mlp) + b * c + 3 * mapper_flops(cfg) * b + 3 * b * syn
             + 2 * b * c + 2 * b * v + v)
    calls = sg.k1_calls(g)
    one = [bound_s(*sg.conv3x3_call(1, h, ci, co), peaks) for h, ci, co in calls]
    full = [bound_s(*sg.conv3x3_call(b, h, ci, co), peaks) for h, ci, co in calls]
    k1 = sum(one) + 2 * sum(full) + sum(full[1:])
    return {"flops_per_unit": flops / b, "kernel_bound_s_per_unit": {"k1": k1 / b},
            "kernel_calls_per_step": {"k1": 4 * len(calls) - 1}}


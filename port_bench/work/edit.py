"""Operations per edit of the S-space region-attention edit, and the least
time K1 needs for an edit's share of its calls.

An edit is one row of a batch: the seeded W+ (the style MLP once), the
capture synthesis, the CLIP text tower on the edit prompt and on the
attention prompt, the mapper (its style MLPs, its 1x1 attention convs at
the blend size, the cluster distances) and the blended synthesis from the
edited styles (no MLP). Forward only; no recomputation. The mean latent is
set-up and is not counted.
"""

from __future__ import annotations

import math

from port_bench.work import stylegan2 as sg


def bound_s(nbytes: float, flops: float, peaks: dict) -> float:
    """max(bytes / HBM bandwidth, operations / peak rate)."""
    return max(nbytes / peaks["hbm_bytes_per_s"], flops / peaks["peak_flop_per_s"])


def clip_text_flops(c: dict) -> int:
    """One prompt through the text tower: the blocks' projections, the
    attention products, the MLP, and the output projection."""
    n, d = c["context_length"], c["width"]
    per_layer = n * (4 * d * d + 2 * d * 4 * d) + 2 * n * n * d
    return 2 * (c["layers"] * per_layer + d * c["output_dim"])


def mapper_flops(cfg: dict) -> int:
    g, m = cfg["generator"], cfg["mapper"]
    ch = sg.channels(g)
    size, att = g["size"], m["attention_layer"]
    blend = 4 * 2 ** (att // 3)
    n_oct = int(math.log2(size)) - 2
    taps = [ch[4], 3] + sum(([ch[2 ** (k + 3)]] * 2 + [3] for k in range(n_oct)), [])
    styles = [ch[4], ch[4]] + sum(([ch[2 ** (k + 2)], ch[2 ** (k + 3)], ch[2 ** (k + 3)]]
                                   for k in range(n_oct)), [])
    conv_taps = [i for i in range(len(taps)) if i % 3 != 1]
    macs = (ch[4] + sum(taps[i] for i in conv_taps)) * 32 * blend * blend
    macs += 32 * (len(conv_taps) + 1) * blend * blend          # the last conv
    macs += m["cluster_dim"] * m["clusters"] * blend * blend   # distances
    style_layers = [0, 2, 2] + sum(([3 * k + 3, 3 * k + 5, 3 * k + 5]
                                    for k in range(n_oct)), [])
    for c in range(style_layers[att]):
        d = styles[c]
        macs += d * d + 512 * 512 + 512 * 512 + (d + 512) * d
    return 2 * macs


def per_edit(cfg: dict, traffic: dict) -> dict:
    """{"flops_per_unit", "kernel_bound_s_per_unit": {"k1": s}}."""
    g, peaks = cfg["generator"], cfg["precision"]
    batch = traffic["batch"]
    parts = sg.synthesis_macs(g)
    synthesis = 2 * (parts["conv"] + parts["torgb"] + parts["blur"])
    flops = (2 * synthesis + 2 * parts["mlp"] + 2 * clip_text_flops(cfg["clip_text"])
             + mapper_flops(cfg))
    k1 = sum(bound_s(*sg.conv3x3_call(batch, h, cin, cout), peaks)
             for h, cin, cout in sg.k1_calls(g)) * 2 / batch
    return {"flops_per_unit": flops, "kernel_bound_s_per_unit": {"k1": k1},
            "kernel_calls_per_step": {"k1": 2 * len(sg.k1_calls(g))}}

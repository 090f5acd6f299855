"""Operations and bytes of the StyleGAN2 generator and discriminator,
counted from a configuration's shapes (rosinality / NVlabs config-f layout).

A multiply-add is two operations. A convolution's forward is counted once,
its input gradient and its weight gradient each as much again. FIR blurs
(upfirdn2d, 4x4 taps) count one multiply-add per tap and output value.
Nothing is counted for recomputation, elementwise epilogues, the noise
injection or the minibatch-stddev statistic.

Bytes of a kernel call: each input value read once and each output value
written once, at the precision's bytes per value, whatever the kernel reads
again.
"""

from __future__ import annotations

import math


def channels(cfg: dict) -> dict:
    cm = cfg["channel_multiplier"]
    return {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * cm, 128: 128 * cm,
            256: 64 * cm, 512: 32 * cm, 1024: 16 * cm}


def _octaves(size: int) -> list:
    return [2 ** i for i in range(3, int(math.log2(size)) + 1)]


def k1_calls(cfg: dict) -> list:
    """(h, cin, cout) of each non-resampling modulated 3x3 conv of one
    synthesis (K1's calls): conv1 at 4², then each octave's second conv."""
    ch = channels(cfg)
    return [(4, ch[4], ch[4])] + [(r, ch[r], ch[r]) for r in _octaves(cfg["size"])]


def k2_calls(cfg: dict) -> list:
    """(h, cin, cout) of each stride-1 3x3 conv of one discriminator pass
    (K2's calls): each ResBlock's first conv, then the final conv (the
    minibatch-stddev channel added to its input)."""
    ch = channels(cfg)
    size = cfg["size"]
    calls = [(r, ch[r], ch[r]) for r in reversed(_octaves(size))]
    return calls + [(4, ch[4] + 1, ch[4])]


def conv3x3_call(batch: int, h: int, cin: int, cout: int,
                 bytes_per_value: int = 4) -> tuple:
    """(bytes, operations) of one stride-1 3x3 conv call: the input, the
    weights and the output once each, plus the per-sample style and demod
    vectors and the bias."""
    values = batch * h * h * (cin + cout) + 9 * cin * cout + batch * (cin + cout) + cout
    return values * bytes_per_value, 2 * batch * h * h * cin * cout * 9


def synthesis_macs(cfg: dict) -> dict:
    """Multiply-adds of one image's synthesis by kind: ``conv`` (the 3x3
    convs, the up-convs' transposed convs included), ``torgb`` (the 1x1
    convs to RGB), ``blur`` (the up-convs' blur and the skip's upsampling
    FIR), ``mlp`` (the 8-layer style MLP and the 26 style affines)."""
    ch = channels(cfg)
    size, sd = cfg["size"], cfg["style_dim"]
    conv = 9 * ch[4] * ch[4] * 16
    torgb = 3 * ch[4] * 16
    blur = 0
    mlp = cfg["n_mlp"] * sd * sd + sd * (ch[4] + ch[4])
    prev = 4
    for r in _octaves(size):
        cin, cout = ch[prev], ch[r]
        conv += 9 * cin * cout * prev * prev       # transposed, stride 2
        blur += 16 * cout * r * r                  # 4x4 blur after it
        conv += 9 * cout * cout * r * r
        torgb += 3 * cout * r * r
        blur += 16 * 3 * r * r                     # skip upsampling FIR
        mlp += sd * (cin + cout + cout)
        prev = r
    return {"conv": conv, "torgb": torgb, "blur": blur, "mlp": mlp}


def discriminator_macs(cfg: dict) -> dict:
    """Multiply-adds of one image through D by kind: ``conv`` (every
    convolution and the two linears) and ``blur`` (the downsampling FIRs)."""
    ch = channels(cfg)
    size = cfg["size"]
    conv = 3 * ch[size] * size * size              # fromRGB 1x1
    blur = 0
    for r in reversed(_octaves(size)):
        cin, cout = ch[r], ch[r // 2]
        conv += 9 * cin * cin * r * r              # conv1
        blur += 16 * cin * (r + 1) * (r + 1)       # blur before conv2 (pad 2)
        conv += 9 * cin * cout * (r // 2) ** 2     # conv2, stride 2
        blur += 16 * cin * (r - 1) * (r - 1)       # blur before the skip (pad 1)
        conv += cin * cout * (r // 2) ** 2         # skip 1x1, stride 2
    conv += 9 * (ch[4] + 1) * ch[4] * 16           # final conv
    conv += ch[4] * 16 * ch[4] + ch[4]             # final linears
    return {"conv": conv, "blur": blur}


def synthesis_flops(cfg: dict) -> int:
    return 2 * sum(synthesis_macs(cfg).values())


def discriminator_flops(cfg: dict) -> int:
    return 2 * sum(discriminator_macs(cfg).values())

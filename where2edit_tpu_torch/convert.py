"""JAX-package variables → the port's state dicts.

Inputs are the JAX package's variable trees as nested dicts of **numpy**
arrays (``jax.tree.map(np.asarray, variables)``); this module imports no
JAX. Outputs are name → torch tensor dicts in the reference rosinality /
OpenAI-CLIP key layout that the port's modules use, so one set of weights
drives both packages (the parity tests) and reference checkpoints load the
same way.

Layout maps: conv (kh, kw, I, O) → (1, O, I, kh, kw); linear (I, O) →
(O, I); NHWC constants and noise buffers → NCHW.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from where2edit_tpu_torch.models.irse import get_blocks
from where2edit_tpu_torch.models.stylegan2 import channel_table
from where2edit_tpu_torch.models.vgg import VGG16_CONVS
from where2edit_tpu_torch.ops.upfirdn2d import make_kernel


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _mod_conv_w(a) -> torch.Tensor:
    return _t(np.asarray(a).transpose(3, 2, 0, 1)[None])


def _conv_w(a) -> torch.Tensor:
    """(kh, kw, I, O) -> (O, I, kh, kw)."""
    return _t(np.asarray(a).transpose(3, 2, 0, 1))


def _lin_w(a) -> torch.Tensor:
    return _t(np.asarray(a).T)


def _nchw(a) -> torch.Tensor:
    return _t(np.asarray(a).transpose(0, 3, 1, 2))


def _equal_linear(p: dict, prefix: str) -> dict:
    return {f"{prefix}.weight": _lin_w(p["weight"]),
            f"{prefix}.bias": _t(p["bias"])}


def _styled_conv(p: dict, prefix: str, *, upsample: bool = False) -> dict:
    out = {
        f"{prefix}.conv.weight": _mod_conv_w(p["conv"]["weight"]),
        f"{prefix}.noise.weight": _t(p["noise"]["weight"]),
        f"{prefix}.activate.bias": _t(p["activate_bias"]),
    }
    if "modulation" in p["conv"]:
        out.update(_equal_linear(p["conv"]["modulation"],
                                 f"{prefix}.conv.modulation"))
    if upsample:
        out[f"{prefix}.conv.blur.kernel"] = _t(make_kernel([1, 3, 3, 1]) * 4)
    return out


def _to_rgb(p: dict, prefix: str, *, upsample: bool) -> dict:
    out = {f"{prefix}.conv.weight": _mod_conv_w(p["conv"]["weight"]),
           f"{prefix}.bias": _nchw(p["bias"])}
    out.update(_equal_linear(p["conv"]["modulation"], f"{prefix}.conv.modulation"))
    if upsample:
        out[f"{prefix}.upsample.kernel"] = _t(make_kernel([1, 3, 3, 1]) * 4)
    return out


def generator_state_dict(variables: dict, size: int, n_mlp: int = 8) -> dict:
    """``{"params", "noises"}`` of ``where2edit_tpu.models.Generator`` → the
    port's ``Generator`` state dict."""
    params = variables["params"]
    noises = variables.get("noises", {})
    n_oct = int(math.log2(size)) - 2
    sd = {}
    for i in range(n_mlp):  # style.0 is the PixelNorm
        sd.update(_equal_linear(params[f"style_{i}"], f"style.{i + 1}"))
    sd["input.input"] = _nchw(params["input"]["input"])
    sd.update(_styled_conv(params["conv1"], "conv1"))
    sd.update(_to_rgb(params["to_rgb1"], "to_rgb1", upsample=False))
    for i in range(2 * n_oct):
        sd.update(_styled_conv(params[f"convs_{i}"], f"convs.{i}",
                               upsample=i % 2 == 0))
    for i in range(n_oct):
        sd.update(_to_rgb(params[f"to_rgbs_{i}"], f"to_rgbs.{i}", upsample=True))
    for i in range(2 * n_oct + 1):
        r = 2 ** ((i + 5) // 2)
        key = f"noise_{i}"
        sd[f"noises.{key}"] = (_nchw(noises[key]) if key in noises
                               else torch.zeros(1, 1, r, r))
    return sd


def _conv_layer(p: dict, prefix: str, *, downsample: bool) -> dict:
    """A ``ConvLayer``: Sequential indexes [Blur,] EqualConv2d
    [, FusedLeakyReLU]."""
    idx = 1 if downsample else 0
    out = {f"{prefix}.{idx}.weight": _conv_w(p["conv"]["weight"])}
    if downsample:
        out[f"{prefix}.0.kernel"] = _t(make_kernel([1, 3, 3, 1]))
    if "bias" in p["conv"]:
        out[f"{prefix}.{idx}.bias"] = _t(p["conv"]["bias"])
    if "activate_bias" in p:
        out[f"{prefix}.{idx + 1}.bias"] = _t(p["activate_bias"])
    return out


def discriminator_state_dict(variables: dict, size: int,
                             channel_multiplier: int = 2) -> dict:
    """``{"params"}`` (or the params tree itself) of
    ``where2edit_tpu.models.Discriminator`` → the port's ``Discriminator``
    state dict. Raises if the tree's widths are not those of
    ``channel_multiplier``."""
    params = variables.get("params", variables)
    width = np.asarray(params["conv_in"]["conv"]["weight"]).shape[-1]
    if width != channel_table(channel_multiplier)[size]:
        raise ValueError(f"conv_in has {width} channels, not those of "
                         f"channel_multiplier {channel_multiplier} at {size}")
    sd = _conv_layer(params["conv_in"], "convs.0", downsample=False)
    for j in range(int(math.log2(size)) - 2):
        blk, pre = params[f"block_{j}"], f"convs.{j + 1}"
        sd.update(_conv_layer(blk["conv1"], f"{pre}.conv1", downsample=False))
        sd.update(_conv_layer(blk["conv2"], f"{pre}.conv2", downsample=True))
        sd.update(_conv_layer(blk["skip"], f"{pre}.skip", downsample=True))
    sd.update(_conv_layer(params["final_conv"], "final_conv", downsample=False))
    sd.update(_equal_linear(params["final_linear1"], "final_linear.0"))
    sd.update(_equal_linear(params["final_linear2"], "final_linear.1"))
    return sd


def mapper_state_dict(variables: dict) -> dict:
    """``{"params", "clusters"}`` of
    ``FullSpaceMapperFEATClusterLinStyle`` → the port's state dict. The JAX
    attention convs take S-space input and so have no ``modulation``
    parameters; ``load_converted`` tolerates exactly those missing keys."""
    params = variables["params"]
    sd = {"initial_bias": _t(params["initial_bias"])}
    for name, p in params.items():
        if name.startswith("mapper_text_"):
            c, j = name[len("mapper_text_"):].rsplit("_", 1)
            sd.update(_equal_linear(p, f"mapper_text_{c}.{j}"))
        elif name.startswith(("mapper_", "attention_textca_")):
            sd.update(_equal_linear(p, name))
        elif name.startswith("attention_"):
            sd.update(_styled_conv(p, name))
    if "clusters" in variables:
        sd["initial_state"] = _t(variables["clusters"]["initial_state"])
    return sd


def _clip_blocks(blk: dict, prefix: str) -> dict:
    """A scanned CLIP Transformer's blocks (stacked along axis 0) → the
    OpenAI ``{prefix}.resblocks.{i}.*`` keys."""
    sd = {}
    for i in range(np.asarray(blk["ln_1"]["scale"]).shape[0]):
        pre = f"{prefix}.resblocks.{i}"
        for ln in ("ln_1", "ln_2"):
            sd[f"{pre}.{ln}.weight"] = _t(blk[ln]["scale"][i])
            sd[f"{pre}.{ln}.bias"] = _t(blk[ln]["bias"][i])
        a = blk["attn"]
        sd[f"{pre}.attn.in_proj_weight"] = _lin_w(a["in_proj_weight"][i])
        sd[f"{pre}.attn.in_proj_bias"] = _t(a["in_proj_bias"][i])
        sd[f"{pre}.attn.out_proj.weight"] = _lin_w(a["out_proj_weight"][i])
        sd[f"{pre}.attn.out_proj.bias"] = _t(a["out_proj_bias"][i])
        for name in ("c_fc", "c_proj"):
            d = blk[f"mlp_{name}"]
            sd[f"{pre}.mlp.{name}.weight"] = _lin_w(d["kernel"][i])
            sd[f"{pre}.mlp.{name}.bias"] = _t(d["bias"][i])
    return sd


def _ln(p: dict, prefix: str) -> dict:
    return {f"{prefix}.weight": _t(p["scale"]), f"{prefix}.bias": _t(p["bias"])}


def clip_text_state_dict(variables: dict) -> dict:
    """``where2edit_tpu.models.clip_model`` CLIP (or TextTransformer)
    variables → the port's ``TextTransformer`` state dict; the scanned
    Transformer's blocks are stacked along axis 0 and come apart here."""
    p = variables["params"]
    p = p.get("text", p)
    sd = {
        "token_embedding.weight": _t(p["token_embedding"]),
        "positional_embedding": _t(p["positional_embedding"]),
        **_ln(p["ln_final"], "ln_final"),
        "text_projection": _t(p["text_projection"]),
    }
    sd.update(_clip_blocks(p["transformer"]["blocks"]["blk"], "transformer"))
    return sd


def clip_state_dict(variables: dict) -> dict:
    """``where2edit_tpu.models.clip_model.CLIP`` variables → the OpenAI
    state dict the port's ``CLIP`` loads (the inverse of
    ``where2edit_tpu/convert/clip.py::convert_clip_params``)."""
    p = variables["params"]
    v = p["visual"]
    sd = clip_text_state_dict(variables)
    sd.update({
        "visual.conv1.weight": _conv_w(v["conv1_weight"]),
        "visual.class_embedding": _t(v["class_embedding"]),
        "visual.positional_embedding": _t(v["positional_embedding"]),
        **_ln(v["ln_pre"], "visual.ln_pre"),
        **_ln(v["ln_post"], "visual.ln_post"),
        "visual.proj": _t(v["proj"]),
        "logit_scale": _t(p["logit_scale"]),
    })
    sd.update(_clip_blocks(v["transformer"]["blocks"]["blk"], "visual.transformer"))
    return sd


def vgg16_state_dict(variables: dict) -> dict:
    """``where2edit_tpu.models.vgg.Vgg16`` variables → torchvision's
    ``features.{idx}.*`` keys (the inverse of
    ``where2edit_tpu/convert/vgg.py::convert_vgg16_params``)."""
    p = variables["params"]
    sd = {}
    for idx, _, _ in VGG16_CONVS:
        sd[f"features.{idx}.weight"] = _conv_w(p[f"conv_{idx}"]["weight"])
        sd[f"features.{idx}.bias"] = _t(p[f"conv_{idx}"]["bias"])
    return sd


def _batch_norm(p: dict, s: dict, prefix: str) -> dict:
    return {f"{prefix}.weight": _t(p["scale"]), f"{prefix}.bias": _t(p["bias"]),
            f"{prefix}.running_mean": _t(s["mean"]),
            f"{prefix}.running_var": _t(s["var"])}


def _bottleneck(p: dict, s: dict, prefix: str) -> dict:
    sd = {}
    if "shortcut_conv" in p:
        sd[f"{prefix}.shortcut_layer.0.weight"] = _conv_w(p["shortcut_conv"]["weight"])
        sd.update(_batch_norm(p["shortcut_bn"], s["shortcut_bn"],
                              f"{prefix}.shortcut_layer.1"))
    sd.update(_batch_norm(p["bn1"], s["bn1"], f"{prefix}.res_layer.0"))
    sd[f"{prefix}.res_layer.1.weight"] = _conv_w(p["conv1"]["weight"])
    sd[f"{prefix}.res_layer.2.weight"] = _t(p["prelu"]["alpha"])
    sd[f"{prefix}.res_layer.3.weight"] = _conv_w(p["conv2"]["weight"])
    sd.update(_batch_norm(p["bn2"], s["bn2"], f"{prefix}.res_layer.4"))
    if "se" in p:
        for fc in ("fc1", "fc2"):
            sd[f"{prefix}.res_layer.5.{fc}.weight"] = _conv_w(p["se"][fc]["weight"])
    return sd


def _index(tree: dict, j: int) -> dict:
    """Entry ``j`` of a tree stacked along axis 0 (an ``nn.scan``'s)."""
    return {k: _index(v, j) if isinstance(v, dict) else np.asarray(v)[j]
            for k, v in tree.items()}


def encoder_state_dict(variables: dict, kind: str = "e4e",
                       stylegan_size: int = 1024, num_layers: int = 50) -> dict:
    """``{"params", "batch_stats"}`` of a ``where2edit_tpu.models.encoders``
    encoder -> the reference-layout state dict (the inverse of
    ``where2edit_tpu/convert/irse.py::convert_encoder_params``). ``kind``:
    'gradual', 'e4e' or 'w'. The 50-layer trunk's stage tails and the
    three style groups are stacked along axis 0 there and come apart here;
    other depths are unrolled there too."""
    params, stats = variables["params"], variables["batch_stats"]
    bp, bs = params["body"], stats["body"]
    sd = {"input_layer.0.weight": _conv_w(bp["input_conv"]["weight"]),
          "input_layer.2.weight": _t(bp["input_prelu"]["alpha"])}
    sd.update(_batch_norm(bp["input_bn"], bs["input_bn"], "input_layer.1"))
    idx = 0
    for si, stage in enumerate(get_blocks(num_layers)):
        for j in range(len(stage)):
            tail = f"stage{si}_tail"
            if j > 0 and tail in bp:
                p, s = _index(bp[tail]["blk"], j - 1), _index(bs[tail]["blk"], j - 1)
            else:
                p, s = bp[f"body_{idx}"], bs[f"body_{idx}"]
            sd.update(_bottleneck(p, s, f"body.{idx}"))
            idx += 1
    if kind == "w":
        sd.update(_equal_linear(params["linear"], "linear"))
        return sd
    style_count = 2 * int(math.log2(stylegan_size)) - 2
    groups = (("styles_coarse", 0), ("styles_middle", 3), ("styles_fine", 7))
    for name, first in groups:
        blk = params[name]["blk"]
        n = np.asarray(blk["linear"]["weight"]).shape[0]
        for j in range(n):
            p, pre = _index(blk, j), f"styles.{first + j}"
            for c in range(len(p) - 1):  # conv_0 … conv_{n-1}, then linear
                conv = p[f"conv_{c}"]
                sd[f"{pre}.convs.{2 * c}.weight"] = _conv_w(conv["weight"])
                sd[f"{pre}.convs.{2 * c}.bias"] = _t(conv["bias"])
            sd.update(_equal_linear(p["linear"], f"{pre}.linear"))
    if first + n != style_count:
        raise ValueError(f"{first + n} style blocks, not the {style_count} of "
                         f"stylegan_size {stylegan_size}")
    for name in ("latlayer1", "latlayer2"):
        sd[f"{name}.weight"] = _conv_w(params[name]["weight"])
        sd[f"{name}.bias"] = _t(params[name]["bias"])
    return sd


def load_converted(module: nn.Module, state_dict: dict) -> nn.Module:
    """Load a converted state dict. Only the S-space attention convs'
    unused ``conv.modulation`` parameters and BatchNorm's
    ``num_batches_tracked`` counters (which flax does not keep) may be
    missing; anything else missing or unexpected raises."""
    missing, unexpected = module.load_state_dict(state_dict, strict=False)
    bad = [k for k in missing if ".conv.modulation." not in k
           and not k.endswith(".num_batches_tracked")]
    if bad or unexpected:
        raise KeyError(f"missing {bad}, unexpected {list(unexpected)}")
    return module

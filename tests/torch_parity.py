"""Shared set-up for the port's parity tests (tests/test_torch_*.py).

Weights are made once by the JAX package, perturbed with numpy where its
init leaves a path dormant (noise buffers and gains, activation and ToRGB
biases start at zero), and handed to both packages: JAX keeps its tree, the
port loads it through ``where2edit_tpu_torch.convert``. Inputs come from a
numpy seed and cross as numpy arrays.

JAX is imported inside the functions that use it, so ``chip_smoke.py``
(on a machine without JAX) draws the evaluation's seeded weights from the
same builders (``inception_state``, ``arcface_state``) as the tests.
"""

import math

import numpy as np
import torch

from where2edit_tpu_torch import convert


def np_tree(tree):
    import jax  # noqa: PLC0415

    return jax.tree.map(np.asarray, tree)


def perturb(tree, rng, scale: float = 0.3):
    """Randomise the leaves that a fresh init leaves at zero: NoiseInjection
    gains, activation biases, ToRGB biases and noise buffers."""
    def visit(node, path):
        if isinstance(node, dict):
            return {k: visit(v, path + (k,)) for k, v in node.items()}
        name = path[-1]
        parent = path[-2] if len(path) > 1 else ""
        if (name == "activate_bias" or path[0] == "noises"
                or (parent == "noise" and name == "weight")
                or (name == "bias" and parent.startswith("to_rgb"))):
            return (rng.standard_normal(node.shape) * scale).astype(np.float32)
        return node
    return visit(tree, ())


def jax_generator(size: int, seed: int = 0):
    """(flax Generator, perturbed numpy variables)."""
    import jax  # noqa: PLC0415
    import jax.numpy as jnp  # noqa: PLC0415

    from where2edit_tpu.models.stylegan2 import Generator  # noqa: PLC0415

    gen = Generator(size=size)
    key = jax.random.PRNGKey(seed)
    variables = jax.jit(lambda: gen.init({"params": key, "noise": key},
                                         [jnp.zeros((1, 512))]))()
    variables = {k: dict(v) for k, v in np_tree(variables).items()}
    return gen, perturb(variables, np.random.default_rng(seed))


def torch_generator(np_vars, size: int):
    from where2edit_tpu_torch.models.stylegan2 import Generator  # noqa: PLC0415

    gen = Generator(size)
    convert.load_converted(gen, convert.generator_state_dict(np_vars, size))
    return gen.eval()


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def close(got, want, tol: float):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the region-attention trainer at generator size 32: attention layer 8 blends
# at the 16² ToRGB as the 1024² production layer does, cluster layer 10 is a
# 512-wide 32² conv; a small CLIP (width 64, one block, 512-wide embeddings)
# and the real VGG16 (test_torch_attention_*.py)
# ---------------------------------------------------------------------------

ATT_SIZE, ATT_LAYER, ATT_CLUSTER, ATT_BATCH, ATT_PROMPTS = 32, 8, 10, 2, 7
ATT_STEPS = 300
# per loss term, relative; the mapper's gradient in relative L2, whole model
# and per tensor (fp32 sums in another order through three syntheses, CLIP
# and VGG; a leaky-ReLU pre-activation rounded to the other side takes the
# other slope)
ATT_LOSS_TOL, ATT_MODEL_GRAD_TOL, ATT_PARAM_GRAD_TOL = 1e-4, 1e-3, 5e-2
TINY_CLIP = dict(embed_dim=512, image_resolution=224, vision_width=64,
                 vision_layers=1, vision_patch_size=32, text_width=64,
                 text_heads=1, text_layers=1, vision_heads=1)


def position_centres(rng, k: int = 10, width: int = 512) -> np.ndarray:
    """k-means centres with a zero feature part and random positions: every
    pixel's region is set by geometry alone, so two packages summing in
    another order cannot split a near-tie two ways."""
    pos = rng.uniform(-1, 1, (k, 2)).astype(np.float32)
    c = np.zeros((k, width + 2 * (width // 16)), np.float32)
    c[:, width:width + width // 16] = pos[:, :1]
    c[:, width + width // 16:] = pos[:, 1:]
    return c


# the mappers the trainer's parity tests run: (works in S-space, has
# clusters, JAX variables → the port's state dict)
ATT_MAPPERS = {
    "FullSpaceMapperFEATClusterLinStyle": (True, True, convert.mapper_state_dict),
    "FullSpaceMapperFEATClusterLin": (False, True, convert.feat_mapper_state_dict),
    "FullSpaceMapperFEATLin": (False, False, convert.feat_mapper_state_dict),
}


def _attention_mapper_kw(name: str) -> dict:
    kw = dict(layers=8, attention_layer=ATT_LAYER, generator_size=ATT_SIZE)
    if ATT_MAPPERS[name][1]:
        kw["cluster_layer"] = ATT_CLUSTER
    return kw


def attention_models(mapper: str = "FullSpaceMapperFEATClusterLinStyle") -> dict:
    """The JAX generator, ``mapper`` (a name in ``ATT_MAPPERS``), small CLIP
    and VGG16 with their numpy variables (perturbed where a fresh init is
    dormant: the S-space mapper's noise and activation biases, the W+
    mappers' biases, with their trunk's head at 2.5 where 5 would saturate
    the map; near 0.8 the coverage penalty, a sum of (mean - 0.8) over the
    regions, would be a difference of near-equal numbers, which no relative
    bar can hold), and a mean latent."""
    import jax  # noqa: PLC0415
    import jax.numpy as jnp  # noqa: PLC0415

    from where2edit_tpu.editing import attention_mappers as jam  # noqa: PLC0415
    from where2edit_tpu.models.clip_model import CLIP  # noqa: PLC0415
    from where2edit_tpu.models.vgg import Vgg16  # noqa: PLC0415

    torch.set_num_threads(2)
    rng = np.random.default_rng(0)
    stylespace, clusters, _ = ATT_MAPPERS[mapper]
    gen, gvars = jax_generator(ATT_SIZE)
    jmap = getattr(jam, mapper)(**_attention_mapper_kw(mapper))
    out = jax.jit(lambda v: gen.apply(v, [jnp.zeros((1, 512))], randomize_noise=False,
                                      return_features=True))(jax.tree.map(jnp.asarray, gvars))
    feats = list(out.feature_map) + [jnp.asarray(gvars["params"]["input"]["input"])]
    if stylespace:
        mvars = jax.jit(lambda: jmap.init({"params": jax.random.PRNGKey(1)},
                                          jnp.zeros((1, 512)), out.style_vector, feats,
                                          16, deterministic_noise=True))()
    else:
        mvars = jax.jit(lambda: jmap.init({"params": jax.random.PRNGKey(1)},
                                          jnp.zeros((1, 512)), jnp.zeros((1, 8, 512)),
                                          feats, 16))()
    mvars = {k: dict(v) for k, v in np_tree(mvars).items()}
    if stylespace:
        mvars["params"] = perturb(mvars["params"], rng)
        mvars["params"]["initial_bias"] = np.full((1,), 1.5, np.float32)
    else:
        def biases(node, name=""):
            if isinstance(node, dict):
                return {k: biases(v, k) for k, v in node.items()}
            return ((rng.standard_normal(node.shape) * 0.1).astype(np.float32)
                    if name == "bias" else node)
        mvars["params"] = biases(mvars["params"])
        att = mvars["params"]["att"]
        att["attention_last"] = dict(att["attention_last"],
                                     bias=np.full((1,), 2.5, np.float32))
    if clusters:
        mvars["clusters"] = {"initial_state": position_centres(rng)}
    jclip = CLIP(**TINY_CLIP)
    clip_vars = np_tree(jax.jit(lambda: jclip.init(
        jax.random.PRNGKey(2), jnp.zeros((1, 224, 224, 3)),
        jnp.zeros((1, 77), jnp.int32)))())
    jvgg = Vgg16()
    vgg_vars = np_tree(jax.jit(lambda: jvgg.init(jax.random.PRNGKey(3),
                                                 jnp.zeros((1, 32, 32, 3))))())
    mean_w = rng.standard_normal((1, 512)).astype(np.float32) * 0.1
    return dict(gen=gen, gvars=gvars, jmap=jmap, mvars=mvars, jclip=jclip,
                clip_vars=clip_vars, jvgg=jvgg, vgg_vars=vgg_vars, mean_w=mean_w,
                mapper=mapper, stylespace=stylespace)


def attention_trainer(m: dict, freeze: float = 1.15, perceptual=None, **kw):
    """The port's ``AttentionTrainer`` on ``attention_models()``'s weights
    (``perceptual`` replaces the VGG16 loss when given)."""
    from where2edit_tpu_torch.editing import attention_mappers as tam  # noqa: PLC0415
    from where2edit_tpu_torch.losses.clip_loss import CLIPLoss  # noqa: PLC0415
    from where2edit_tpu_torch.losses.perceptual import PerceptualLoss  # noqa: PLC0415
    from where2edit_tpu_torch.models.clip_model import CLIP, load_clip_state  # noqa: PLC0415
    from where2edit_tpu_torch.models.vgg import Vgg16, load_vgg16_state  # noqa: PLC0415
    from where2edit_tpu_torch.train.attention_trainer import (  # noqa: PLC0415
        AttentionTrainConfig,
        AttentionTrainer,
    )

    tmap = getattr(tam, m["mapper"])(**_attention_mapper_kw(m["mapper"]))
    convert.load_converted(tmap, ATT_MAPPERS[m["mapper"]][2](m["mvars"]))
    if perceptual is None:
        vgg = load_vgg16_state(Vgg16(), convert.vgg16_state_dict(m["vgg_vars"]))
        perceptual = PerceptualLoss(vgg.eval(), ATT_SIZE)
    clip = load_clip_state(CLIP(**TINY_CLIP), convert.clip_state_dict(m["clip_vars"]))
    cfg = AttentionTrainConfig(stylegan_size=ATT_SIZE, attention_layer=ATT_LAYER,
                               cluster_layer=ATT_CLUSTER, batch_size=ATT_BATCH,
                               step=ATT_STEPS, work_in_stylespace=m["stylespace"],
                               freeze_attention_until=freeze)
    return AttentionTrainer(cfg, generator=torch_generator(m["gvars"], ATT_SIZE),
                            mapper=tmap, clip_loss=CLIPLoss(clip.eval(), ATT_SIZE),
                            perceptual=perceptual, mean_latent=t(m["mean_w"]), **kw)


def jax_attention_draws(key, n_bank=None, n_text=None):
    """The draws the JAX ``_step`` makes from ``key`` (k1: the condition,
    k2: the target, k3: the region prompts), as a port ``Draws``."""
    import jax  # noqa: PLC0415

    from where2edit_tpu_torch.train.attention_trainer import Draws  # noqa: PLC0415

    k1, k2, k3 = jax.random.split(key, 3)
    att = jax.random.randint(k3, (ATT_BATCH,), 0, ATT_PROMPTS)
    n_cond = n_text if n_text is not None else n_bank
    cond = (jax.random.normal(k1, (ATT_BATCH, 512)) if n_cond is None
            else jax.random.randint(k1, (ATT_BATCH,), 0, n_cond))
    target = (jax.random.normal(k2, (ATT_BATCH, 512)) if n_bank is None
              else jax.random.randint(k2, (ATT_BATCH,), 0, n_bank))
    return Draws(*(torch.from_numpy(np.array(a)) for a in (cond, target, att)))


def jax_attention_step(m: dict, key, step_idx: int, bank, latent_bank=None,
                       text_bank=None):
    """(aux, unmasked gradients under the port's names) of one JAX
    ``_step``. The JAX package stays as it is: its trainer gets an optax
    chain whose first link keeps the gradients it receives, and ``_step``
    is jitted again."""
    import jax  # noqa: PLC0415
    import jax.numpy as jnp  # noqa: PLC0415
    import optax  # noqa: PLC0415

    from where2edit_tpu.losses.clip_loss import CLIPLoss  # noqa: PLC0415
    from where2edit_tpu.losses.perceptual import PerceptualLoss  # noqa: PLC0415
    from where2edit_tpu.train import attention_trainer as jat  # noqa: PLC0415

    clip_loss = CLIPLoss(m["jclip"], m["clip_vars"], ATT_SIZE)
    perceptual = PerceptualLoss(m["jvgg"], m["vgg_vars"], ATT_SIZE)
    cfg = jat.AttentionTrainConfig(stylegan_size=ATT_SIZE, attention_layer=ATT_LAYER,
                                   cluster_layer=ATT_CLUSTER, batch_size=ATT_BATCH,
                                   step=ATT_STEPS, work_in_stylespace=m["stylespace"],
                                   freeze_attention_until=0.0)
    params = jax.tree.map(jnp.asarray, m["mvars"]["params"])
    tr = jat.AttentionTrainer(
        cfg, generator=m["gen"], gen_vars=jax.tree.map(jnp.asarray, m["gvars"]),
        mapper=m["jmap"], mapper_params=params,
        encode_image=lambda lv, img: clip_loss.apply_encode_image(lv["clip"], img),
        perceptual=lambda lv, a, b: perceptual.apply(lv["vgg"], a, b),
        mean_latent=jnp.asarray(m["mean_w"]),
        mapper_extra_variables={k: jax.tree.map(jnp.asarray, v)
                                for k, v in m["mvars"].items() if k != "params"},
        loss_variables={"clip": m["clip_vars"], "vgg": m["vgg_vars"]},
        latent_bank=latent_bank, text_bank=text_bank)
    keep = optax.GradientTransformation(
        lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        lambda updates, state, p=None: (updates, {"g": updates}))
    tr.opt = optax.chain(keep, optax.adam(jat.styleclip_lr_schedule(cfg.lr, cfg.step)))
    tr._jit_step = jax.jit(tr._step)
    _, opt_state, aux, _, _ = tr._jit_step(
        tr.gen_vars, tr.mapper_variables_extra, tr.loss_variables, params,
        tr.opt.init(params), jnp.asarray(float(step_idx)), key, jnp.asarray(bank),
        tr.latent_bank, tr.text_bank)
    return ({k: float(v) for k, v in aux.items()},
            ATT_MAPPERS[m["mapper"]][2]({"params": np_tree(opt_state[0]["g"])}))


def compare_attention_step(aux_t: dict, aux_j: dict, trainer, grads_j: dict) -> None:
    """Every loss term within ``ATT_LOSS_TOL``; the port trainer's gradients
    (``p.grad``) against ``grads_j`` within ``ATT_MODEL_GRAD_TOL`` for the
    whole mapper and ``ATT_PARAM_GRAD_TOL`` per tensor."""
    for name, want in aux_j.items():
        got = float(aux_t[name])
        assert abs(got - want) <= ATT_LOSS_TOL * max(abs(want), 1e-6), (name, got, want)
    assert set(trainer.param_names) == set(grads_j) - {"initial_state"}
    diff2 = ref2 = 0.0
    for name, p in zip(trainer.param_names, trainer.params):
        g, w = p.grad.double(), grads_j[name].double()
        d2, r2 = float((g - w).square().sum()), float(w.square().sum())
        diff2, ref2 = diff2 + d2, ref2 + r2
        assert d2 == 0.0 or (d2 / r2) ** 0.5 <= ATT_PARAM_GRAD_TOL, name
    assert (diff2 / ref2) ** 0.5 <= ATT_MODEL_GRAD_TOL


# ---------------------------------------------------------------------------
# the evaluation's extractors: seeded state dicts in the layouts their
# checkpoints ship in (test_torch_inception.py, test_torch_arcface.py,
# test_torch_evaluate_cli.py, chip_smoke.py)
# ---------------------------------------------------------------------------

def _seeded_state(module_fn, seed: int, conv_gain: float) -> dict:
    """The state-dict layout of ``module_fn()`` (built on the meta device)
    filled from ``np.random.default_rng(seed)``, in key order: convs
    N(0, conv_gain/fan_in), linears N(0, 1/fan_in), biases and running
    means N(0, 0.01), BatchNorm scales 1 + N(0, 0.01), running variances
    U(0.5, 1.5), PReLU slopes 0.25 + N(0, 0.01): the running statistics are
    exercised, and activations keep O(1) scale through the depth."""
    with torch.device("meta"):
        layout = module_fn().state_dict()
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in layout.items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(0)
            continue
        if k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif k.endswith(("running_mean", "bias")):
            a = 0.1 * rng.standard_normal(shape)
        elif len(shape) == 4:
            a = rng.standard_normal(shape) * math.sqrt(conv_gain / np.prod(shape[1:]))
        elif len(shape) == 2:
            a = rng.standard_normal(shape) / math.sqrt(shape[1])
        elif k.endswith(("input_layer.2.weight", "res_layer.2.weight")):
            a = 0.25 + 0.1 * rng.standard_normal(shape)
        else:
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


def inception_state(seed: int = 0) -> dict:
    """A torchvision-layout InceptionV3 state dict (1008 classes) with
    He-scaled convs (each is followed by a ReLU)."""
    from where2edit_tpu_torch.models.inception import InceptionV3  # noqa: PLC0415

    return _seeded_state(InceptionV3, seed, conv_gain=2.0)


def arcface_state(seed: int = 0, input_size: int = 112) -> dict:
    """A reference-layout ArcFace IR-SE50 state dict (``input_layer.*``,
    ``body.*``, ``output_layer.*``)."""
    from where2edit_tpu_torch.models.irse import Backbone  # noqa: PLC0415

    return _seeded_state(lambda: Backbone(input_size), seed, conv_gain=1.0)


K3_BF16_MAX_SMEM = 232448  # bytes a block may use on the H100


def k3_bf16_plan(b: int, p: int, cin: int, cout: int, out_size: int, res_size: int,
                 sms: int) -> dict | None:
    """A mirror of the bf16 K3 core's work plan (``csrc/modconv1x1.cu``,
    ``k3_bf16::make_plan``; the card reports its own through
    ``kernels/modconv1x1.py::plan_bf16``), or None where the core does not
    take the shape. Units are one sample x one tile of ``tile`` pixels
    (64 where P ≤ 64, where Cout > 8, where the FMA form (fp32 out, Cout ≤
    8) has Cin > 128 or where 128-pixel units would be fewer than the SMs;
    256 where Cin ≤ 32, Cout ≤ 8 and 256-pixel units still fill the SMs;
    else 128), sample-major; K runs over ``slices`` of ``kc`` channels (32
    where Cin rounded up to 8 is ≤ 32, else 64); the fold has ``nc`` = 8 or
    32 output channels (fp32 in the FMA form, else its two bf16 parts); each
    consumer's ring has ``stages`` stages (at most 8, or the FMA form's
    slices, which are staged all at once) of one slice's TMA box and, in
    the last slice's, the unit's residual tile; two fold slots where they
    leave 4 stages, else one. ``unit_flags``: per unit, bit 0 its residual tile moves by one bulk
    copy (both ends 16-byte aligned), else value by value; bit 1 its output
    tile leaves in 16-byte stores (its first value 16-byte aligned), else
    value by value."""
    def cdiv(a, d):
        return -(-a // d)

    def up(v, m):
        return cdiv(v, m) * m

    if min(b, p, cin, cout, sms) < 1 or cout > 32:
        return None
    cx = up(cin, 8)
    fma = out_size == 4 and cout <= 8  # the FMA form: its fold fp32, its slices all staged
    tile = (64 if p <= 64 or cout > 8 or (fma and cx > 128) or b * cdiv(p, 128) < sms
            else 256 if cx <= 32 and cout <= 8 and b * cdiv(p, 256) >= sms else 128)
    tiles = cdiv(p, tile)
    units = b * tiles
    kc = 32 if cx <= 32 else 64
    slices = cdiv(cx, kc)
    nc = 8 if cout <= 8 else 32
    x_bytes = tile * kc * 2
    stage_bytes = up(x_bytes + up(tile * cout * res_size, 16), 1024)
    fold_bytes = up(nc * slices * kc * 4 if fma  # fp32, or its two bf16 parts
                    else slices * 2 * nc * kc * 2, 1024)
    out_bytes = up(tile * cout * 4, 128)
    need = max(2, slices) if fma else 2
    cap = max(8, need)
    for fold_slots in (2, 1):
        ring_off = fold_slots * fold_bytes
        fixed = 1024 + ring_off + 4 * out_bytes + 8 * (4 * cap + 4)
        stages = min(cap, (K3_BF16_MAX_SMEM - fixed) // (2 * stage_bytes))
        if stages >= (max(4, need) if fold_slots == 2 else need):
            break
    else:
        return None
    out_off = ring_off + 2 * stages * stage_bytes
    bar_off = out_off + 4 * out_bytes

    def bulk(first, n, size):
        return size > 0 and (first * size) % 16 == 0 and (n * size) % 16 == 0

    flags = []
    for u in range(units):
        s, p0 = divmod(u, tiles)
        first, n = (s * p + p0 * tile) * cout, min(tile, p - p0 * tile) * cout
        flags.append(int(bulk(first, n, res_size)) | int((first * out_size) % 16 == 0) << 1)
    return {"tile": tile, "tiles": tiles, "units": units, "grid": min(units, sms), "kc": kc,
            "slices": slices, "nc": nc, "res_size": res_size, "out_size": out_size,
            "x_bytes": x_bytes, "stage_bytes": stage_bytes, "stages": stages,
            "fold_bytes": fold_bytes, "fold_slots": fold_slots, "out_bytes": out_bytes,
            "ring_off": ring_off, "out_off": out_off, "bar_off": bar_off,
            "smem": 1024 + bar_off + 8 * (4 * stages + 2 * fold_slots), "unit_flags": flags}

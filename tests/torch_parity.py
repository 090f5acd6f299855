"""Shared set-up for the port's parity tests (tests/test_torch_*.py).

Weights are made once by the JAX package, perturbed with numpy where its
init leaves a path dormant (noise buffers and gains, activation and ToRGB
biases start at zero), and handed to both packages: JAX keeps its tree, the
port loads it through ``where2edit_tpu_torch.convert``. Inputs come from a
numpy seed and cross as numpy arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from where2edit_tpu_torch import convert


def np_tree(tree):
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


def attention_models() -> dict:
    """The JAX generator, mapper, small CLIP and VGG16 with their numpy
    variables (perturbed where a fresh init is dormant), and a mean latent."""
    from where2edit_tpu.editing.attention_mappers import (  # noqa: PLC0415
        FullSpaceMapperFEATClusterLinStyle,
    )
    from where2edit_tpu.models.clip_model import CLIP  # noqa: PLC0415
    from where2edit_tpu.models.vgg import Vgg16  # noqa: PLC0415

    torch.set_num_threads(2)
    rng = np.random.default_rng(0)
    gen, gvars = jax_generator(ATT_SIZE)
    jmap = FullSpaceMapperFEATClusterLinStyle(
        layers=8, attention_layer=ATT_LAYER, cluster_layer=ATT_CLUSTER,
        generator_size=ATT_SIZE)
    out = jax.jit(lambda v: gen.apply(v, [jnp.zeros((1, 512))], randomize_noise=False,
                                      return_features=True))(jax.tree.map(jnp.asarray, gvars))
    feats = list(out.feature_map) + [jnp.asarray(gvars["params"]["input"]["input"])]
    mvars = jax.jit(lambda: jmap.init({"params": jax.random.PRNGKey(1)},
                                      jnp.zeros((1, 512)), out.style_vector, feats,
                                      16, deterministic_noise=True))()
    mvars = {k: dict(v) for k, v in np_tree(mvars).items()}
    mvars["params"] = perturb(mvars["params"], rng)
    mvars["params"]["initial_bias"] = np.full((1,), 1.5, np.float32)
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
                clip_vars=clip_vars, jvgg=jvgg, vgg_vars=vgg_vars, mean_w=mean_w)


def attention_trainer(m: dict, freeze: float = 1.15, perceptual=None, **kw):
    """The port's ``AttentionTrainer`` on ``attention_models()``'s weights
    (``perceptual`` replaces the VGG16 loss when given)."""
    from where2edit_tpu_torch.editing.attention_mappers import (  # noqa: PLC0415
        FullSpaceMapperFEATClusterLinStyle,
    )
    from where2edit_tpu_torch.losses.clip_loss import CLIPLoss  # noqa: PLC0415
    from where2edit_tpu_torch.losses.perceptual import PerceptualLoss  # noqa: PLC0415
    from where2edit_tpu_torch.models.clip_model import CLIP, load_clip_state  # noqa: PLC0415
    from where2edit_tpu_torch.models.vgg import Vgg16, load_vgg16_state  # noqa: PLC0415
    from where2edit_tpu_torch.train.attention_trainer import (  # noqa: PLC0415
        AttentionTrainConfig,
        AttentionTrainer,
    )

    tmap = FullSpaceMapperFEATClusterLinStyle(
        layers=8, attention_layer=ATT_LAYER, cluster_layer=ATT_CLUSTER,
        generator_size=ATT_SIZE)
    convert.load_converted(tmap, convert.mapper_state_dict(m["mvars"]))
    if perceptual is None:
        vgg = load_vgg16_state(Vgg16(), convert.vgg16_state_dict(m["vgg_vars"]))
        perceptual = PerceptualLoss(vgg.eval(), ATT_SIZE)
    clip = load_clip_state(CLIP(**TINY_CLIP), convert.clip_state_dict(m["clip_vars"]))
    cfg = AttentionTrainConfig(stylegan_size=ATT_SIZE, attention_layer=ATT_LAYER,
                               cluster_layer=ATT_CLUSTER, batch_size=ATT_BATCH,
                               step=ATT_STEPS, work_in_stylespace=True,
                               freeze_attention_until=freeze)
    return AttentionTrainer(cfg, generator=torch_generator(m["gvars"], ATT_SIZE),
                            mapper=tmap, clip_loss=CLIPLoss(clip.eval(), ATT_SIZE),
                            perceptual=perceptual, mean_latent=t(m["mean_w"]), **kw)


def jax_attention_draws(key, n_bank=None, n_text=None):
    """The draws the JAX ``_step`` makes from ``key`` (k1: the condition,
    k2: the target, k3: the region prompts), as a port ``Draws``."""
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
    from where2edit_tpu.losses.clip_loss import CLIPLoss  # noqa: PLC0415
    from where2edit_tpu.losses.perceptual import PerceptualLoss  # noqa: PLC0415
    from where2edit_tpu.train import attention_trainer as jat  # noqa: PLC0415

    clip_loss = CLIPLoss(m["jclip"], m["clip_vars"], ATT_SIZE)
    perceptual = PerceptualLoss(m["jvgg"], m["vgg_vars"], ATT_SIZE)
    cfg = jat.AttentionTrainConfig(stylegan_size=ATT_SIZE, attention_layer=ATT_LAYER,
                                   cluster_layer=ATT_CLUSTER, batch_size=ATT_BATCH,
                                   step=ATT_STEPS, work_in_stylespace=True,
                                   freeze_attention_until=0.0)
    params = jax.tree.map(jnp.asarray, m["mvars"]["params"])
    tr = jat.AttentionTrainer(
        cfg, generator=m["gen"], gen_vars=jax.tree.map(jnp.asarray, m["gvars"]),
        mapper=m["jmap"], mapper_params=params,
        encode_image=lambda lv, img: clip_loss.apply_encode_image(lv["clip"], img),
        perceptual=lambda lv, a, b: perceptual.apply(lv["vgg"], a, b),
        mean_latent=jnp.asarray(m["mean_w"]),
        mapper_extra_variables={"clusters": jax.tree.map(jnp.asarray,
                                                         m["mvars"]["clusters"])},
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
            convert.mapper_state_dict({"params": np_tree(opt_state[0]["g"])}))


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

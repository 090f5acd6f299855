"""The port's StyleCLIP ``Coach`` (``train/coach.py``) against the JAX
package's, on the CPU.

One step from the same mapper weights (JAX init, biases perturbed,
converted by ``convert.latent_mapper_state_dict``), the same W+ batch
(through ``train_latents``), the same 64² generator, a small CLIP and the
seeded ArcFace IR-SE50 of ``torch_parity.arcface_state``, the same token
ids: in W+ (``LevelsMapper``) and in S-space
(``WithoutToRGBStyleSpaceMapper``). The JAX gradients come from an optax
link that keeps them, ahead of its Ranger (the JAX package stays as it
is). Loss terms within 1e-4 relative; the mapper's gradient within 1e-3 in
relative L2 over the whole mapper and 5e-2 per tensor (fp32 through two
syntheses, CLIP and IR-SE50, and the mapper's leaky-ReLU kinks).

Then the train loop's schedule against the JAX loop's at 32², L2 loss only:
the checkpoints written, the ``timestamp.txt`` entries (best or not, at
which step) and the sanity validation's None at step 0.
"""

import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from where2edit_tpu.convert.irse import convert_backbone_params
from where2edit_tpu.editing.styleclip_mapper import build_mapper as jbuild
from where2edit_tpu.losses.clip_loss import CLIPLoss as JCLIPLoss
from where2edit_tpu.losses.id_loss import IDLoss as JIDLoss
from where2edit_tpu.models.clip_model import CLIP as JCLIP
from where2edit_tpu.models.irse import Backbone as JBackbone
from where2edit_tpu.train import coach as jcoach
from where2edit_tpu.train.ranger import ranger as jranger
from where2edit_tpu_torch import convert
from where2edit_tpu_torch.editing.latent_mappers import stylespace_count
from where2edit_tpu_torch.editing.styleclip_mapper import build_mapper
from where2edit_tpu_torch.losses.clip_loss import CLIPLoss
from where2edit_tpu_torch.losses.id_loss import IDLoss
from where2edit_tpu_torch.models.clip_model import CLIP, load_clip_state
from where2edit_tpu_torch.models.clip_tokenizer import tokenize
from where2edit_tpu_torch.models.irse import Backbone
from where2edit_tpu_torch.train.coach import Coach, CoachConfig

from torch_parity import (
    ATT_LOSS_TOL,
    ATT_MODEL_GRAD_TOL,
    ATT_PARAM_GRAD_TOL,
    TINY_CLIP,
    arcface_state,
    jax_generator,
    np_tree,
    t,
    torch_generator,
)

SIZE, BATCH = 64, 2
MAPPERS = {"LevelsMapper": False, "WithoutToRGBStyleSpaceMapper": True}


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """Both packages' ``MetricsWriter`` writes JSON lines only (importing
    TensorBoard pulls in TensorFlow where it is installed)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(min(torch.get_num_threads(), 2))
    rng = np.random.default_rng(0)
    gen, gvars = jax_generator(SIZE)
    jclip = JCLIP(**TINY_CLIP)
    clip_vars = np_tree(jax.jit(lambda: jclip.init(
        jax.random.PRNGKey(2), jnp.zeros((1, 224, 224, 3)),
        jnp.zeros((1, 77), jnp.int32)))())
    arc = arcface_state(seed=0)
    arc_jax = jax.tree.map(jnp.asarray, convert_backbone_params(arc))
    w = (rng.standard_normal((BATCH, gen.n_latent, 512)) * 0.5).astype(np.float32)
    return dict(gen=gen, gvars=gvars, jclip=jclip, clip_vars=clip_vars, arc=arc,
                arc_jax=arc_jax, w=w,
                mean_w=(rng.standard_normal((1, 512)) * 0.1).astype(np.float32),
                tokens=np.asarray(tokenize(["a person with purple hair"]), np.int32),
                rng=rng)


def _mapper_vars(world, mapper_type: str) -> dict:
    """JAX init on this generator's inputs, biases N(0, 30) (0.3 at run
    time through lr_mul 0.01)."""
    jm = jbuild(mapper_type)
    if MAPPERS[mapper_type]:
        arg = [jnp.zeros((1, 512)) for _ in range(stylespace_count(SIZE))]
    else:
        arg = jnp.zeros((1, world["gen"].n_latent, 512))
    v = np_tree(jax.jit(lambda a: jm.init({"params": jax.random.PRNGKey(1)}, a))(arg))
    rng = world["rng"]

    def visit(node, name=""):
        if isinstance(node, dict):
            return {k: visit(v, k) for k, v in node.items()}
        return ((rng.standard_normal(node.shape) * 30).astype(np.float32)
                if name == "bias" else node)
    return jm, {"params": visit(dict(v["params"]))}


def _config(cls, tmp, mapper_type: str, **kw):
    base = dict(exp_dir=str(tmp), mapper_type=mapper_type,
                work_in_stylespace=MAPPERS[mapper_type], batch_size=BATCH,
                test_batch_size=BATCH, train_dataset_size=BATCH,
                test_dataset_size=BATCH, stylegan_size=SIZE)
    base.update(kw)
    return cls(**base)


def _jax_step(world, tmp, mapper_type: str, jm, mvars):
    """(losses, gradients under the port's names) of one JAX Coach step."""
    facenet = JBackbone(input_size=112, drop_ratio=0.6)
    coach = jcoach.Coach(
        _config(jcoach.CoachConfig, tmp, mapper_type), generator=world["gen"],
        generator_variables=jax.tree.map(jnp.asarray, world["gvars"]), mapper=jm,
        mapper_variables=jax.tree.map(jnp.asarray, mvars),
        clip_loss_fn=JCLIPLoss(world["jclip"], world["clip_vars"], SIZE),
        id_loss_fn=JIDLoss(facenet, world["arc_jax"]),
        latent_avg=jnp.asarray(world["mean_w"]), text_tokens=world["tokens"],
        train_latents=world["w"], test_latents=world["w"])
    keep = optax.GradientTransformation(
        lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        lambda updates, state, p=None: (updates, {"g": updates}))
    coach.opt = optax.chain(keep, jranger(coach.cfg.learning_rate))
    coach._step_fn = coach._build_step()
    batch = next(coach._batches(coach.train_latents, BATCH, False))
    _, opt_state, aux, _ = coach._step_fn(coach.mapper_params,
                                          coach.opt.init(coach.mapper_params), batch)
    grads = convert.latent_mapper_state_dict({"params": np_tree(opt_state[0]["g"])},
                                             mapper_type)
    return {k: float(v) for k, v in aux.items()}, grads


def _port_coach(world, tmp, mapper_type: str, mvars, **kw):
    tm = build_mapper(mapper_type, n_styles=stylespace_count(SIZE))
    tm.load_state_dict(convert.latent_mapper_state_dict(mvars, mapper_type))
    clip = load_clip_state(CLIP(**TINY_CLIP), convert.clip_state_dict(world["clip_vars"]))
    facenet = Backbone.from_state_dict(world["arc"], input_size=112, drop_ratio=0.6)
    return Coach(_config(CoachConfig, tmp, mapper_type, **kw),
                 generator=torch_generator(world["gvars"], SIZE), mapper=tm,
                 clip_loss=CLIPLoss(clip, SIZE), id_loss=IDLoss(facenet),
                 latent_avg=t(world["mean_w"]),
                 text_tokens=torch.from_numpy(world["tokens"]).long(),
                 train_latents=world["w"], test_latents=world["w"])


@pytest.mark.parametrize("mapper_type", sorted(MAPPERS))
def test_torch_coach_step_matches_jax(world, tmp_path, mapper_type):
    jm, mvars = _mapper_vars(world, mapper_type)
    aux_j, grads_j = _jax_step(world, tmp_path / "jax", mapper_type, jm, mvars)
    coach = _port_coach(world, tmp_path / "port", mapper_type, mvars)
    batch = next(coach._batches(coach.train_latents, BATCH, False))
    aux_t, _ = coach.step(batch)
    assert set(aux_t) == set(aux_j) == {"loss", "loss_id", "loss_clip", "loss_l2_latent"}
    for name, want in aux_j.items():
        got = float(aux_t[name])
        assert abs(got - want) <= ATT_LOSS_TOL * max(abs(want), 1e-6), (name, got, want)
    named = dict(coach.mapper.named_parameters())
    assert set(named) == set(grads_j)
    diff2 = ref2 = 0.0
    for name, p in named.items():
        g, w = p.grad.double(), grads_j[name].double()
        d2, r2 = float((g - w).square().sum()), float(w.square().sum())
        diff2, ref2 = diff2 + d2, ref2 + r2
        assert d2 == 0.0 or (d2 / r2) ** 0.5 <= ATT_PARAM_GRAD_TOL, name
    assert ref2 > 0 and (diff2 / ref2) ** 0.5 <= ATT_MODEL_GRAD_TOL


def _schedule(exp_dir) -> tuple:
    """(checkpoint names without a suffix, [(best?, step)] of
    timestamp.txt)."""
    ckpt_dir = os.path.join(exp_dir, "checkpoints")
    names = sorted(os.path.splitext(n)[0] for n in os.listdir(ckpt_dir)
                   if n != "timestamp.txt")
    with open(os.path.join(ckpt_dir, "timestamp.txt")) as f:
        entries = [(m.group(1) is not None, int(m.group(2)))
                   for m in re.finditer(r"(\*\*Best\*\*: )?Step - (\d+),", f.read())]
    return names, entries


def _test_losses(exp_dir) -> list:
    with open(os.path.join(exp_dir, "logs", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r["value"] for r in rows if r["tag"] == "test/loss"]


def test_torch_coach_train_loop_schedule_matches_jax(tmp_path):
    """32², L2 only, 6 test batches (so the step-0 validation is the
    sanity pass), validation every 2 steps, saves every 3, 5 steps over 3
    epochs: the same checkpoints and timestamp entries as the JAX loop, and
    validation losses within 1e-4. At lr 0, so that "best" is decided the
    same way in both: a real lr moves this loss by ~1e-8 a step (the
    mapper's lr_mul is 0.01), a near-tie either package may break its own
    way."""
    torch.set_num_threads(min(torch.get_num_threads(), 2))
    size, rng = 32, np.random.default_rng(5)
    gen, gvars = jax_generator(size)
    train = (rng.standard_normal((4, gen.n_latent, 512)) * 0.5).astype(np.float32)
    test = (rng.standard_normal((6, gen.n_latent, 512)) * 0.5).astype(np.float32)
    jm = jbuild("LevelsMapper")
    mvars = np_tree(jax.jit(lambda a: jm.init({"params": jax.random.PRNGKey(3)}, a))(
        jnp.zeros((1, gen.n_latent, 512))))
    kw = dict(mapper_type="LevelsMapper", batch_size=2, test_batch_size=1,
              train_dataset_size=4, test_dataset_size=6, id_lambda=0.0,
              clip_lambda=0.0, stylegan_size=size, max_steps=4, val_interval=2,
              save_interval=3, board_interval=1, learning_rate=0.0)
    jc = jcoach.Coach(jcoach.CoachConfig(exp_dir=str(tmp_path / "jax"), **kw),
                      generator=gen, generator_variables=jax.tree.map(jnp.asarray, gvars),
                      mapper=jm, mapper_variables=jax.tree.map(jnp.asarray, mvars),
                      latent_avg=jnp.zeros((1, 512)), train_latents=train,
                      test_latents=test)
    jval0 = jc.validate()
    jc.train()
    tm = build_mapper("LevelsMapper")
    tm.load_state_dict(convert.latent_mapper_state_dict(mvars, "LevelsMapper"))
    tc = Coach(CoachConfig(exp_dir=str(tmp_path / "port"), **kw),
               generator=torch_generator(gvars, size), mapper=tm,
               latent_avg=torch.zeros(1, 512), train_latents=train, test_latents=test)
    assert jval0 is None and tc.validate() is None
    assert tc.train() is None and tc.global_step == 4
    got, want = (_test_losses(tmp_path / name) for name in ("port", "jax"))
    assert len(got) == 2 and got[0] == got[1]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    port = _schedule(tmp_path / "port")
    assert port == _schedule(tmp_path / "jax")
    assert port[0] == ["best_model", "iteration_0", "iteration_3", "iteration_4"]
    assert port[1] == [(False, 0), (True, 2), (False, 3), (False, 4)]

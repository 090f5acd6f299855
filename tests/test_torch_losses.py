"""The port's training losses and their plumbing against the JAX package's
on the same weights and inputs: VGG16's four taps at a 32² input and its
early stop (1e-4), the perceptual loss at generator size 32 (1e-4, also
with a batch-1 target read broadcast), InfoNCE (1e-6), the StyleCLIP lr
schedule, the corpus loader and text sampler (equal lists from the same
seed), image grids and run logging.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from where2edit_tpu.losses.infonce import infonce_consistency as j_infonce
from where2edit_tpu.losses.perceptual import PerceptualLoss as JPerceptual
from where2edit_tpu.models.vgg import Vgg16 as JVgg16
from where2edit_tpu.train import corpus as jcorpus
from where2edit_tpu.train.lr import styleclip_lr_schedule as j_schedule
from where2edit_tpu.utils.images import to_uint8 as j_to_uint8
from where2edit_tpu_torch import convert
from where2edit_tpu_torch.losses.infonce import infonce_consistency
from where2edit_tpu_torch.losses.perceptual import PerceptualLoss
from where2edit_tpu_torch.models.vgg import Vgg16, load_vgg16_state
from where2edit_tpu_torch.train import corpus
from where2edit_tpu_torch.train.lr import styleclip_lr_schedule
from where2edit_tpu_torch.utils.images import save_image_grid, to_uint8
from where2edit_tpu_torch.utils.logging import Logger, MetricsWriter, read_scalars

from torch_parity import close, np_tree, t

TOL = 1e-4


@pytest.fixture(scope="module")
def vggs():
    torch.set_num_threads(2)
    jm = JVgg16()
    v = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))()
    v = np_tree(v)
    rng = np.random.default_rng(0)  # non-zero biases, so every key carries weight
    v = {"params": {k: {"weight": p["weight"],
                        "bias": (0.1 * rng.standard_normal(p["bias"].shape)).astype(np.float32)}
                    for k, p in v["params"].items()}}
    tm = load_vgg16_state(Vgg16(), convert.vgg16_state_dict(v))
    return jm, v, tm.eval()


def test_torch_vgg16_taps_match_jax(vggs):
    jm, v, tm = vggs
    x = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    want = jm.apply(jax.tree.map(jnp.asarray, v), jnp.asarray(x))
    with torch.no_grad():
        got = tm(t(x))
        early = tm(t(x), last="relu2_2")
    for name in ("relu1_2", "relu2_2", "relu3_3", "relu4_3"):
        w = np.asarray(getattr(want, name))
        close(getattr(got, name), w, TOL * max(1.0, float(np.abs(w).max())))
    assert early.relu3_3 is None and early.relu4_3 is None
    assert torch.equal(early.relu2_2, got.relu2_2)


def test_torch_vgg16_loads_torchvision_layouts(vggs):
    _, v, tm = vggs
    sd = convert.vgg16_state_dict(v)
    full = {**sd, "classifier.0.weight": torch.zeros(2, 2)}
    bare = {k[len("features."):]: x for k, x in sd.items()}
    for layout in (full, bare):
        m = load_vgg16_state(Vgg16(), layout)
        for k, x in m.state_dict().items():
            assert torch.equal(x, sd[k]), k


def test_torch_perceptual_loss_matches_jax(vggs):
    jm, v, tm = vggs
    rng = np.random.default_rng(2)
    a = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    want = JPerceptual(jm, v, 32).apply(jax.tree.map(jnp.asarray, v), jnp.asarray(a),
                                        jnp.asarray(np.repeat(b, 2, axis=0)))
    loss = PerceptualLoss(tm, 32)
    with torch.no_grad():
        got = loss(t(a), t(b))  # the batch-1 target, read broadcast
        got_full = loss(t(a), t(np.repeat(b, 2, axis=0)))
    close(got, want, TOL)
    close(got_full, want, TOL)


def test_torch_infonce_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.standard_normal((6, 512)).astype(np.float32)
    cond = rng.standard_normal((6, 512)).astype(np.float32)
    want = j_infonce(jnp.asarray(img), jnp.asarray(cond))
    close(infonce_consistency(t(img), t(cond)), want, 1e-6)
    # at batch 1 the loss is the cross-entropy of one logit: identically 0
    assert float(infonce_consistency(t(img[:1]), t(cond[:1]))) == 0.0


@pytest.mark.parametrize("step", [0, 15, 60, 299])
def test_torch_lr_schedule_matches_jax(step):
    want = float(j_schedule(0.1, 300)(jnp.asarray(step, jnp.int32)))
    got = styleclip_lr_schedule(0.1, 300)(step)
    assert isinstance(got, float)
    # the port computes in float64; JAX's float32 0.5 - 0.5·cos(x) near
    # x = 0 (step 299) loses digits to cancellation: one float32 ulp of the
    # ramp, times the initial lr
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=0.1 * float(np.finfo(np.float32).eps))
    if step == 0:
        assert got == 0.0


def test_torch_corpus_matches_jax(tmp_path):
    caps = tmp_path / "celeba-caption"
    caps.mkdir()
    (caps / "0.txt").write_text("She has big eyes, purple hair, and a pointy nose.\n"
                                "The woman has wavy hair and arched eyebrows.\n")
    (caps / "1.txt").write_text("He wears glasses, a beard. He is smiling.\n")
    (caps / "2.txt").write_text("")
    own = tmp_path / "own.txt"
    own.write_text("purple hair\n\nbig eyes\n")
    got = corpus.load_corpus(str(caps), None, str(own), random.Random(7))
    want = jcorpus.load_corpus(str(caps), None, str(own), random.Random(7))
    assert got.__dict__ == want.__dict__
    assert got.phrases == want.phrases and got.phrases
    assert corpus.sample_training_texts(got, 12, random.Random(5)) == \
        jcorpus.sample_training_texts(want, 12, random.Random(5))
    assert corpus.ATTENTION_PROMPTS == jcorpus.ATTENTION_PROMPTS
    assert corpus.IOU_PROMPTS == jcorpus.IOU_PROMPTS


def test_torch_image_grid_and_logging(tmp_path):
    img = np.random.default_rng(4).uniform(-1.2, 1.2, (3, 8, 8, 3)).astype(np.float32)
    for kw in ({}, {"scale_each": True}):
        np.testing.assert_array_equal(to_uint8(torch.from_numpy(img), **kw),
                                      j_to_uint8(img, **kw))
    assert save_image_grid(img, str(tmp_path / "g.jpg"), nrow=2)
    assert save_image_grid(img[..., :1], str(tmp_path / "m.png"), value_range=(0, 1))
    from PIL import Image  # noqa: PLC0415

    assert Image.open(tmp_path / "g.jpg").size == (2 * 10 + 2, 2 * 10 + 2)
    log = Logger(open(tmp_path / "out.txt", "w"), str(tmp_path / "run.log"))
    log.write("hello\n")
    log.flush()
    assert (tmp_path / "run.log").read_text() == "hello\n"
    mw = MetricsWriter(str(tmp_path / "logs"))
    mw.add_scalar("loss/loss", 1.5, 3)
    mw.close()
    rows = read_scalars(str(tmp_path / "logs"))
    assert [(r["tag"], r["value"], r["step"]) for r in rows] == [("loss/loss", 1.5, 3)]

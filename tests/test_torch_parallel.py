"""Data parallelism of the port (``where2edit_tpu_torch/parallel/``) on the
CPU: two gloo ranks against one process on the global batch.

One pair of rank processes is spawned for the module (``parallel.launch``,
a ``file://`` store under the module's temporary directory) and runs every
case below; each case is one function that the parent also runs with no
group (meanwhile), so the single-process reference is the same code on the
whole batch.
The GAN cases load the weights ``tests/test_torch_gan.py`` holds against
the JAX trainer (JAX init, perturbed), so the two-rank bars chain to the
reference through its single-process tests.

Bars, each against one process on the global batch:
- ``gather_with_grad``: forward equal to the concatenation; first and
  second derivatives of a per-rank-scaled ``var(0).sum()`` of the gathered
  rows at 1e-6 (float64); ``broadcast_from_first`` gives every rank rank
  0's value.
- the discriminator with the global minibatch-stddev at global batch 8:
  outputs at 1e-6; R1 and its gradient w.r.t. D's parameters at 1e-5; at
  world size 1 the output is bitwise the module without the flag.
- one GAN iteration (d, r1, g, path, ema) at global batch 8, twice: every
  metric at rtol 1e-5; the averaged gradients before each of the four
  optimizer steps of the first iteration at rtol 1e-4 / atol 1e-6; G, D and
  G_ema after two iterations at atol 5·lr (Adam with b1 = 0 moves a
  parameter whose gradient is a last-bit difference away from zero by up
  to ~lr: the JAX suite's bar for its sharded step,
  tests/test_gan_training.py:322-333); ``pl_mean`` at 1e-6. In bf16
  (``bf16``, ``d_bf16``) at the bf16 bars of ``chip_smoke.py``
  (``BF16_LOSS_REL_TOL``, ``BF16_MODEL_GRAD_TOL``): metrics and ``pl_mean`` at
  1e-2 relative, each program's whole-model gradient at 5e-2 relative L2,
  parameters as fp32.
- one region-attention step with the gathered InfoNCE at global batch 4:
  the loss terms at 1e-5, the mapper's gradients at 1e-4 (relative L2, per
  tensor); the gathered InfoNCE and a parameter's gradient through it
  against one process (no factor of the world size), and the loss against
  the JAX package's ``infonce_consistency`` on the concatenated features
  at 1e-5.
- one StyleCLIP coach step at global batch 4, at tests/test_torch_coach.py's
  bars: loss terms at 1e-4 relative, the mapper's gradient at 1e-3
  relative L2 over the mapper and 5e-2 per tensor.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from where2edit_tpu_torch import convert
from where2edit_tpu_torch.parallel import dist
from where2edit_tpu_torch.parallel.collectives import broadcast_from_first, gather_with_grad

from torch_parity import TINY_CLIP, position_centres

GAN_SIZE, GAN_BATCH, LR = 8, 8, 0.002
ATT_SIZE, ATT_BATCH = 32, 4
COACH_SIZE, COACH_BATCH = 32, 4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, as in the rank processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _gan_weights() -> dict:
    """The JAX package's G and D at 8² (512 wide), initialised and
    perturbed as tests/test_torch_gan.py's, as numpy trees."""
    import jax  # noqa: PLC0415
    import jax.numpy as jnp  # noqa: PLC0415

    from where2edit_tpu.models.stylegan2 import Discriminator, Generator  # noqa: PLC0415

    from torch_parity import np_tree, perturb  # noqa: PLC0415

    jg = Generator(size=GAN_SIZE, channel_multiplier=1)
    jd = Discriminator(size=GAN_SIZE, channel_multiplier=1)
    gv = jax.jit(lambda: jg.init({"params": jax.random.PRNGKey(1),
                                  "noise": jax.random.PRNGKey(2)},
                                 [jnp.zeros((1, 512))]))()
    dv = jax.jit(lambda: jd.init({"params": jax.random.PRNGKey(3)},
                                 jnp.zeros((1, GAN_SIZE, GAN_SIZE, 3))))()
    rng = np.random.default_rng(0)
    return {"g": perturb({k: dict(v) for k, v in np_tree(gv).items()}, rng),
            "d": perturb(np_tree(dv), rng)}


def _inputs() -> dict:
    rng = np.random.default_rng(21)
    return {
        "gan": _gan_weights(),
        "real": rng.uniform(-1, 1, (GAN_BATCH, GAN_SIZE, GAN_SIZE, 3)).astype(np.float32),
        "x64": rng.standard_normal((8, 3)),
        "feats": rng.standard_normal((2, 8, 512)).astype(np.float32),
        "proj": rng.standard_normal((512, 512)).astype(np.float32) * 0.05,
        "bank": rng.standard_normal((7, 512)).astype(np.float32),
        "mean_w": (rng.standard_normal((1, 512)) * 0.1).astype(np.float32),
        "centres": position_centres(rng),
        "latents": (rng.standard_normal((COACH_BATCH, 8, 512)) * 0.5).astype(np.float32),
    }


# ---------------------------------------------------------------------------
# the cases: each runs in the rank processes and, with no group, in the parent
# ---------------------------------------------------------------------------

def gather_case(inp) -> dict:
    x = dist.rows(torch.from_numpy(inp["x64"])).clone().requires_grad_(True)
    xg = gather_with_grad(x)
    loss = xg.var(0).sum() * (1.0 + dist.rank())
    (g,) = torch.autograd.grad(loss, x, create_graph=True)
    (gg,) = torch.autograd.grad(g.square().sum(), x)
    return {"fwd": xg.detach(), "g": g.detach(), "gg": gg,
            "first": broadcast_from_first(x.detach() * (1.0 + dist.rank()))}


def _discriminator(inp, dtype=torch.float32):
    from where2edit_tpu_torch.models.stylegan2 import Discriminator  # noqa: PLC0415

    d = Discriminator(GAN_SIZE, 1, dtype=dtype)
    convert.load_converted(d, convert.discriminator_state_dict(inp["gan"]["d"], GAN_SIZE, 1))
    d.global_stddev = dist.in_group()
    return d


def discriminator_case(inp) -> dict:
    from where2edit_tpu_torch.train.gan_trainer import r1_penalty  # noqa: PLC0415

    d = _discriminator(inp)
    real = dist.rows(torch.from_numpy(inp["real"]))
    with torch.no_grad():
        out = d(real)
    r1 = r1_penalty(d, real)
    r1.backward()
    dist.all_reduce_grads(d.parameters())
    return {"out": out, "r1": float(dist.mean(r1.detach())),
            "grads": {n: p.grad for n, p in d.named_parameters()} if dist.is_main()
            else None}


def gan_case(inp, **levers) -> dict:
    """Two iterations that run every program; the averaged gradients
    before each optimizer step of the first."""
    from where2edit_tpu_torch.train.gan_trainer import GANTrainConfig, GANTrainer  # noqa: PLC0415

    tr = GANTrainer(GANTrainConfig(size=GAN_SIZE, batch_size=GAN_BATCH,
                                   channel_multiplier=1, d_reg_every=1,
                                   g_reg_every=1, lr=LR, **levers), device="cpu")
    convert.load_converted(tr.g, convert.generator_state_dict(inp["gan"]["g"], GAN_SIZE))
    convert.load_converted(tr.d, convert.discriminator_state_dict(inp["gan"]["d"],
                                                                 GAN_SIZE, 1))
    tr.g_ema.load_state_dict(tr.g.state_dict())
    grads = []
    for opt in (tr.d_opt, tr.g_opt):
        def step(*a, _step=opt.step, _opt=opt, **k):
            if tr.global_step == 0 and dist.is_main():
                grads.append([None if p.grad is None else p.grad.clone()
                              for p in _opt.param_groups[0]["params"]])
            return _step(*a, **k)
        opt.step = step
    real = dist.rows(torch.from_numpy(inp["real"]))
    metrics = [{k: float(v) for k, v in tr.step(real).items()} for _ in range(2)]
    return {"metrics": metrics, "grads": grads, "pl_mean": float(tr.pl_mean),
            "params": ({m: getattr(tr, m).state_dict() for m in ("g", "d", "g_ema")}
                       if dist.is_main() else None)}


class PooledFeatures(torch.nn.Module):
    """A cheap stand-in for VGG16: the 224² image average-pooled 8x8 as its
    relu2_2."""

    def forward(self, x, last="relu4_3"):
        from where2edit_tpu_torch.models.vgg import VggFeatures  # noqa: PLC0415

        pooled = torch.nn.functional.avg_pool2d(x.permute(0, 3, 1, 2), 8)
        return VggFeatures(relu2_2=pooled.permute(0, 2, 3, 1))


def attention_case(inp) -> dict:
    """One step at step 60 of 300 (both ramps on, nothing frozen) of the
    production S-space mapper on a 32² generator, seeded weights."""
    from where2edit_tpu_torch.editing.attention_mappers import (  # noqa: PLC0415
        FullSpaceMapperFEATClusterLinStyle,
    )
    from where2edit_tpu_torch.losses.clip_loss import CLIPLoss  # noqa: PLC0415
    from where2edit_tpu_torch.losses.infonce import infonce_consistency  # noqa: PLC0415
    from where2edit_tpu_torch.losses.perceptual import PerceptualLoss  # noqa: PLC0415
    from where2edit_tpu_torch.models.clip_model import CLIP  # noqa: PLC0415
    from where2edit_tpu_torch.models.stylegan2 import Generator  # noqa: PLC0415
    from where2edit_tpu_torch.train.attention_trainer import (  # noqa: PLC0415
        AttentionTrainConfig,
        AttentionTrainer,
    )

    gen = Generator(ATT_SIZE, rng=torch.Generator().manual_seed(0)).eval()
    mapper = FullSpaceMapperFEATClusterLinStyle(
        layers=gen.n_latent, attention_layer=8, cluster_layer=10, generator_size=ATT_SIZE,
        rng=torch.Generator().manual_seed(1))
    mapper.initial_state.copy_(torch.from_numpy(inp["centres"]))
    clip = CLIP(**TINY_CLIP, rng=torch.Generator().manual_seed(2)).eval()
    cfg = AttentionTrainConfig(stylegan_size=ATT_SIZE, attention_layer=8, cluster_layer=10,
                               batch_size=ATT_BATCH, work_in_stylespace=True,
                               freeze_attention_until=0.0)
    tr = AttentionTrainer(cfg, generator=gen, mapper=mapper,
                          clip_loss=CLIPLoss(clip, ATT_SIZE),
                          perceptual=PerceptualLoss(PooledFeatures(), ATT_SIZE),
                          mean_latent=torch.from_numpy(inp["mean_w"]))
    grads = []
    step = tr.opt.step
    tr.opt.step = lambda g: (grads.append([x.clone() for x in g]), step(g))
    aux, _, _ = tr.step(60, torch.from_numpy(inp["bank"]))
    # the gathered InfoNCE alone, and a replicated parameter's gradient through it
    proj = torch.from_numpy(inp["proj"]).requires_grad_(True)
    img, cond = (dist.rows(torch.from_numpy(f)) for f in inp["feats"])
    nce = infonce_consistency(img @ proj, cond, gather=True)
    nce.backward()
    dist.all_reduce_grads([proj])
    return {"aux": {k: float(v) for k, v in aux.items()},
            "grads": dict(zip(tr.param_names, grads[0])) if dist.is_main() else None,
            "nce": float(nce.detach()), "nce_grad": proj.grad}


def coach_case(inp, exp_dir: str) -> dict:
    """One coach step of ``LevelsMapper`` on a 32² generator, the CLIP and
    latent-L2 losses, Ranger."""
    from where2edit_tpu_torch.editing.styleclip_mapper import build_mapper  # noqa: PLC0415
    from where2edit_tpu_torch.losses.clip_loss import CLIPLoss  # noqa: PLC0415
    from where2edit_tpu_torch.models.clip_model import CLIP  # noqa: PLC0415
    from where2edit_tpu_torch.models.clip_tokenizer import tokenize  # noqa: PLC0415
    from where2edit_tpu_torch.models.stylegan2 import Generator  # noqa: PLC0415
    from where2edit_tpu_torch.train.coach import Coach, CoachConfig  # noqa: PLC0415

    gen = Generator(COACH_SIZE, rng=torch.Generator().manual_seed(3))
    clip = CLIP(**TINY_CLIP, rng=torch.Generator().manual_seed(4))
    coach = Coach(
        CoachConfig(exp_dir=exp_dir, batch_size=COACH_BATCH, test_batch_size=1,
                    train_dataset_size=COACH_BATCH, test_dataset_size=1,
                    stylegan_size=COACH_SIZE),
        generator=gen, mapper=build_mapper("LevelsMapper", rng=torch.Generator().manual_seed(5)),
        clip_loss=CLIPLoss(clip, COACH_SIZE),
        text_tokens=torch.as_tensor(np.asarray(tokenize(["purple hair"]))).long(),
        train_latents=inp["latents"], test_latents=inp["latents"][:1])
    grads = []
    step = coach.opt.step
    coach.opt.step = lambda: (grads.append({n: p.grad.clone() for n, p in
                                            coach.mapper.named_parameters()}), step())
    batch = next(coach._batches(coach.train_latents, COACH_BATCH, True))
    aux, _ = coach.step(batch)
    coach.metrics.close()
    return {"rows": batch.shape[0], "aux": {k: float(v) for k, v in aux.items()},
            "grads": grads[0] if dist.is_main() else None}


def all_cases(inp, work: str) -> dict:
    return {"gather": gather_case(inp), "discriminator": discriminator_case(inp),
            "gan_fp32": gan_case(inp), "gan_bf16": gan_case(inp, bf16=True, d_bf16=True),
            "attention": attention_case(inp),
            "coach": coach_case(inp, os.path.join(work, f"coach_{dist.world()}"))}


def _worker(root: str) -> None:
    """A rank of the pair: every case, its results to ``rank<r>.pt``."""
    torch.set_num_threads(2)
    sys.modules["torch.utils.tensorboard"] = None  # no TensorFlow import
    inp = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    torch.save(all_cases(inp, root), os.path.join(root, f"rank{dist.rank()}.pt"))


def _world_one(root: str) -> dict:
    """The flagged discriminator's output in a gloo group of one."""
    inp = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    d = _discriminator(inp)
    assert d.global_stddev
    with torch.no_grad():
        return {"out": d(torch.from_numpy(inp["real"]))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, each rank's results, the directory, the single process's
    results): the pair runs while this process computes the reference."""
    root = tmp_path_factory.mktemp("dp")
    inp = _inputs()
    torch.save(inp, root / "inputs.pt")
    failed = []

    def pair():
        try:
            dist.launch(_worker, 2, "cpu", str(root), store_dir=str(root), timeout_s=600)
        except BaseException as e:  # re-raised below
            failed.append(e)

    thread = threading.Thread(target=pair)
    thread.start()
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)  # no TensorFlow import
        single = all_cases(inp, str(root))
    thread.join()
    if failed:
        raise failed[0]
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return inp, ranks, str(root), single


def _close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def _rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


# ---------------------------------------------------------------------------
# the bars
# ---------------------------------------------------------------------------

def test_torch_dp_gather_with_grad_twice_differentiable(runs):
    _, ranks, _, single = runs
    want = single["gather"]
    for r in ranks:
        assert torch.equal(r["gather"]["fwd"], want["fwd"])  # the concatenation
        assert torch.equal(r["gather"]["first"], want["fwd"][:4])  # rank 0's rows
    # the ranks' losses sum to (1 + 2)·var(0).sum(); the single process's
    # loss is var(0).sum() scaled by 1: its derivatives times 3
    for key in ("g", "gg"):
        got = torch.cat([r["gather"][key] for r in ranks])
        scale = 3.0 if key == "g" else 9.0
        _close(got, want[key] * scale, 1e-6, 1e-12, key)


def test_torch_dp_discriminator_global_stddev_and_r1(runs):
    _, ranks, _, single = runs
    want = single["discriminator"]
    _close(torch.cat([r["discriminator"]["out"] for r in ranks]), want["out"], 1e-6,
           1e-7, "D output")
    for r in ranks:
        _close(r["discriminator"]["r1"], want["r1"], 1e-5, 0.0, "R1")
    for name, g in ranks[0]["discriminator"]["grads"].items():
        w = want["grads"][name]
        assert (g is None) == (w is None), name
        if w is not None:
            _close(g, w, 1e-5, 1e-5 * float(w.abs().max()), name)


def test_torch_dp_discriminator_world_one_is_bitwise(runs):
    _, _, root, single = runs
    got = dist.launch(_world_one, 1, "cpu", root)
    assert not dist.in_group()
    assert torch.equal(got["out"], single["discriminator"]["out"])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_torch_dp_gan_iteration_is_the_global_batch_step(runs, dtype):
    _, ranks, _, single = runs
    got, want = ranks[0][f"gan_{dtype}"], single[f"gan_{dtype}"]
    metric_tol = 1e-5 if dtype == "fp32" else 1e-2
    for r in ranks:
        for it, (m, w) in enumerate(zip(r[f"gan_{dtype}"]["metrics"], want["metrics"])):
            assert set(m) == set(w) == {"d_loss", "r1", "g_loss", "path", "path_length"}
            for k in w:
                _close(m[k], w[k], metric_tol, 0.0, f"iteration {it} {k}")
        _close(r[f"gan_{dtype}"]["pl_mean"], want["pl_mean"],
               1e-6 if dtype == "fp32" else 1e-2, 0.0, "pl_mean")
    # d, r1 (D), g, path (G): the averaged gradients before each step
    assert len(got["grads"]) == len(want["grads"]) == 4
    for prog, (gs, ws) in zip(("d", "r1", "g", "path"), zip(got["grads"], want["grads"])):
        assert [g is None for g in gs] == [w is None for w in ws], prog
        pairs = [(g, w) for g, w in zip(gs, ws) if w is not None]
        if dtype == "fp32":
            for i, (g, w) in enumerate(pairs):
                _close(g, w, 1e-4, 1e-6, f"{prog} gradient {i}")
        else:  # the whole model's gradient, at the bf16 bar
            flat = [torch.cat([x.reshape(-1) for x in side]) for side in zip(*pairs)]
            assert _rel_l2(*flat) <= 5e-2, (prog, _rel_l2(*flat))
    for m in ("g", "d", "g_ema"):
        for name, v in want["params"][m].items():
            _close(got["params"][m][name], v, 0.0, 5 * LR, f"{m}.{name}")


def test_torch_dp_attention_step_with_gathered_infonce(runs):
    _, ranks, _, single = runs
    want = single["attention"]
    for r in ranks:
        a = r["attention"]
        for k, w in want["aux"].items():
            assert abs(a["aux"][k] - w) <= 1e-5 * max(abs(w), 1e-6), (k, a["aux"][k], w)
        _close(a["nce"], want["nce"], 1e-5, 0.0, "InfoNCE")
        # the gather's backward sums over the ranks and the average divides
        # by them: the global gradient, no factor of the world size
        _close(a["nce_grad"], want["nce_grad"], 1e-5,
               1e-5 * float(want["nce_grad"].abs().max()), "grad through InfoNCE")
    grads = ranks[0]["attention"]["grads"]
    assert set(grads) == set(want["grads"])
    for name, w in want["grads"].items():
        if float(w.abs().max()) == 0.0:
            assert float(grads[name].abs().max()) == 0.0, name
        else:
            assert _rel_l2(grads[name], w) <= 1e-4, (name, _rel_l2(grads[name], w))


def test_torch_dp_infonce_matches_jax_on_the_concatenation(runs):
    import jax.numpy as jnp  # noqa: PLC0415

    from where2edit_tpu.losses.infonce import infonce_consistency  # noqa: PLC0415

    inp, ranks, _, _ = runs
    img, cond = inp["feats"]
    want = float(infonce_consistency(jnp.asarray(img @ inp["proj"]), jnp.asarray(cond)))
    for r in ranks:
        _close(r["attention"]["nce"], want, 1e-5, 0.0, "InfoNCE vs JAX")


def test_torch_dp_coach_step(runs):
    _, ranks, _, single = runs
    want = single["coach"]
    assert want["rows"] == COACH_BATCH
    for r in ranks:
        c = r["coach"]
        assert c["rows"] == COACH_BATCH // 2
        assert set(c["aux"]) == set(want["aux"]) == {"loss_clip", "loss_l2_latent", "loss"}
        for k, w in want["aux"].items():
            assert abs(c["aux"][k] - w) <= 1e-4 * max(abs(w), 1e-6), (k, c["aux"][k], w)
    diff2 = ref2 = 0.0
    for name, w in want["grads"].items():
        g = ranks[0]["coach"]["grads"][name]
        d2, r2 = float((g.double() - w.double()).square().sum()), float(w.double().square().sum())
        diff2, ref2 = diff2 + d2, ref2 + r2
        assert d2 == 0.0 or (d2 / r2) ** 0.5 <= 5e-2, name
    assert (diff2 / ref2) ** 0.5 <= 1e-3


def test_torch_dp_initialize_multihost_joins_torchrun_group(monkeypatch, tmp_path):
    """Without torchrun's environment ``initialize_multihost`` is a no-op;
    with it (a group of one on a localhost port) a CLI's ``--multihost``
    joins the group and trains as its rank."""
    import socket  # noqa: PLC0415

    from where2edit_tpu_torch.cli import train_stylegan  # noqa: PLC0415

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert not dist.initialize_multihost("cpu") and not dist.in_group()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for key, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("MASTER_ADDR", "127.0.0.1"),
                       ("MASTER_PORT", str(port)), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(key, value)
    try:
        trainer = train_stylegan.main([
            "--synthetic", "2", "--size", "8", "--batch", "2", "--iter", "1",
            "--device", "cpu", "--save_every", "0", "--sample_every", "0",
            "--d_reg_every", "0", "--g_reg_every", "0", "--results_dir", str(tmp_path),
            "--multihost"])
        assert dist.in_group() and dist.world() == 1
        assert trainer.global_step == 1 and trainer.d.global_stddev
    finally:
        if dist.in_group():
            torch.distributed.destroy_process_group()
    assert os.listdir(tmp_path / "logs") and (tmp_path / "ckpt_0000001.pt").is_file()

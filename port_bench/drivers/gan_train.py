"""Driver of StyleGAN2 training: ``GANTrainer.step`` (``train/gan_trainer.py``)
on seeded real batches made on the device (no dataset is read), with at
most two iterations in flight: the host enqueues iteration i+1 before it
waits for iteration i.

Set-up builds one trainer, replaces its weights with the benchmark's seeded
ones, and drives it through its first ``check_iterations`` iterations
through ``step`` itself, recording the draws each program made, each
program's gradients at the first iteration and the losses. The window
continues the same trainer, so it always starts at the same point of the
regularisers' cadence. Once the window has closed and the trainer is freed,
``reference/gan.py`` follows those iterations from the same weights, reals
and draws.
"""

from __future__ import annotations

import torch

from port_bench.lib import common
from port_bench.lib import weights as wlib
from port_bench.reference import gan as ref_gan
from port_bench.work import gan as work_gan
from where2edit_tpu_torch import resolve_device
from where2edit_tpu_torch.kernels import conv3x3 as k2
from where2edit_tpu_torch.kernels import modconv3x3 as k1
from where2edit_tpu_torch.models.stylegan2 import Discriminator, Generator
from where2edit_tpu_torch.train.gan_trainer import GANTrainConfig, GANTrainer

PROGRAMS = {"d": "d_step_with", "r1": "r1_step", "g": "g_step_with", "path": "path_step_with"}


class State:
    pass


def _norms(module) -> dict:
    return {k: float(p.grad.norm()) for k, p in module.named_parameters() if p.grad is not None}


def _changes(module, start: dict) -> dict:
    return {k: float((p.detach() - start[k]).norm()) for k, p in module.named_parameters()}


def _record(st, trainer) -> None:
    """Wrap the trainer's programs (instance attributes) to keep their
    draws and, at the first iteration, their parameters' gradients."""
    for prog, attr in PROGRAMS.items():
        orig = getattr(trainer, attr)
        module = trainer.d if prog in ("d", "r1") else trainer.g

        def wrapped(*args, _orig=orig, _prog=prog, _module=module):
            out = _orig(*args)
            st.draws[trainer.global_step][_prog] = args
            if trainer.global_step == 0:
                st.grads[_prog] = _norms(_module)
            return out

        setattr(trainer, attr, wrapped)


def _weights_and_reals(st, env, g_module, d_module) -> None:
    """The seeded weights of G and D and the real batches, drawn on the
    device; the same seed gives the same ones."""
    cfg, tr, dev = env.config, env.traffic, st.dev
    rng = torch.Generator(dev).manual_seed(common.derived_seed(env.seed, 6))
    st.g_sd = wlib.draw(wlib.shapes_of(g_module), cfg["init"]["generator"], rng, dev)
    st.d_sd = wlib.draw(wlib.shapes_of(d_module), cfg["init"]["discriminator"], rng, dev)
    size = cfg["generator"]["size"]
    st.reals = torch.rand(tr["real_batches"], tr["batch"], size, size, 3, generator=rng,
                          device=dev) * 2.0 - 1.0


def setup(env) -> State:
    st = State()
    cfg, tr = env.config, env.traffic
    g, t = cfg["generator"], cfg["train"]
    dev = resolve_device(env.device)
    st.dev = dev
    tcfg = GANTrainConfig(
        size=g["size"], batch_size=tr["batch"], lr=t["lr"], r1=t["r1"],
        d_reg_every=t["d_reg_every"], g_reg_every=t["g_reg_every"],
        path_regularize=t["path_regularize"], path_batch_shrink=t["path_batch_shrink"],
        mixing=t["mixing"], ema_kimg=t["ema_kimg"],
        channel_multiplier=g["channel_multiplier"],
        seed=common.derived_seed(env.seed, 5) % 2 ** 62)
    trainer = GANTrainer(tcfg, device=dev)
    env.phase("trainer_s")
    _weights_and_reals(st, env, trainer.g, trainer.d)
    trainer.g.load_state_dict(st.g_sd)
    trainer.g_ema.load_state_dict(st.g_sd)
    trainer.d.load_state_dict(st.d_sd)
    env.phase("weights_s")

    st.trainer, st.draws, st.grads, st.losses = trainer, {}, {}, []
    _record(st, trainer)
    for i in range(tr["check_iterations"]):
        st.draws[i] = {}
        m = trainer.step(st.reals[i % tr["real_batches"]])
        st.losses.append({k: float(v) for k, v in m.items() if k != "path_length"})
        env.phase("first_iteration_s" if i == 0 else f"iteration_{i}_s")
    for attr in PROGRAMS.values():
        delattr(trainer, attr)
    st.changes = {"g": _changes(trainer.g, st.g_sd), "d": _changes(trainer.d, st.d_sd),
                  "g_ema": _changes(trainer.g_ema, st.g_sd)}
    return st


def window(st, env, seconds: float) -> dict:
    """Time-limited (or, traced, ``trace_iterations`` iterations)."""
    tr, trainer = env.traffic, st.trainer
    b = tr["batch"]
    span = (lambda program, _trainer: env.span(f"gan.{program}"))
    launches = (k1.launches, k2.launches)
    n, done, window_s = common.closed_loop(
        env, lambda: trainer.step(st.reals[trainer.global_step % tr["real_batches"]],
                                  span=span),
        seconds, tr["trace_iterations"])
    return {"attempted": n * b, "failed": 0, "units": done * b, "steps": done,
            "window_s": window_s,
            "k1_launches_per_step": (k1.launches - launches[0]) / max(done, 1),
            "k2_launches_per_step": (k2.launches - launches[1]) / max(done, 1)}


def end_to_end(result: dict) -> dict:
    return {"train_samples_per_s": result["units"] / result["window_s"]}


def work(env) -> dict:
    return work_gan.per_sample(env.config, env.traffic)


def follow(st, env, tf32: bool = False, trainer_cls=ref_gan.Trainer) -> dict:
    """The reference through the recorded iterations: its losses, its
    first iteration's gradient norms by program, and its parameters'
    change after the last iteration."""
    cfg, tr = env.config, env.traffic
    train = dict(cfg["train"], batch=tr["batch"])
    out = {"losses": [], "grads": {}}
    with common.precision(tf32):
        ref = trainer_cls(st.g_sd, st.d_sd, cfg["generator"], train)
        for i in range(tr["check_iterations"]):
            d = st.draws[i]
            path = d.get("path", (None, None))
            r = ref.iteration(st.reals[i % tr["real_batches"]], d["d"][1], d["g"][0],
                              path[0], path[1])
            out["losses"].append({k: float(r[k]) for k in ("d_loss", "r1", "g_loss", "path")
                                  if k in r})
            if i == 0:
                out["grads"] = {p: {k: float(g.norm()) for k, g in r[f"{p}_grads"].items()
                                    if g is not None}
                                for p in PROGRAMS if f"{p}_grads" in r}
        with torch.no_grad():
            out["changes"] = {
                "g": {k: float((v - st.g_sd[k]).norm()) for k, v in ref.g_params.items()},
                "d": {k: float((v - st.d_sd[k]).norm()) for k, v in ref.d_params.items()},
                "g_ema": {k: float((ref.g_ema[k] - st.g_sd[k]).norm())
                          for k in ref.g_params}}
    return out


def numbers(got: dict, want: dict) -> dict:
    """The numbers held against the reference:

    - ``d0_loss_gap``: the first program's loss (d, iteration 0: the only
      loss taken before any update), relative;
    - ``d0_grad_gap``, ``d0_grad_median``: the worst and the median leaf of
      that program's gradient (D's);
    - ``change_gap``: the worst leaf of the parameters' change after the
      recorded iterations (G, D and the EMA), leaving out leaves whose
      reference gradient (program d for D, g for G) is nought to rounding.

    Readings beside them, not compared (see PERF.md): ``loss_gap`` (every
    recorded loss: after Adam's first step, sign(g)·lr, a gradient element
    within rounding of 0 moves its weight either way, and the later losses
    follow), ``grad_gap`` and ``grad_gap_median`` (the worst and the median
    leaf over the first iteration's four programs: r1, g and path run after
    an update, and a noise gain's gradient sums every pixel with
    cancellation)."""
    gaps = [[abs(g[k] - r[k]) / max(abs(r[k]), 1e-30) for k in r]
            for g, r in zip(got["losses"], want["losses"])]
    d0 = want["losses"][0]["d_loss"]
    leaves, grad_gap, grad_leaf = [], 0.0, ""
    for prog, ref in want["grads"].items():
        per = common.leaf_gaps(got["grads"].get(prog, {}), ref)
        leaves += list(per.values())
        leaf = max(per, key=per.get)
        if per[leaf] >= grad_gap:
            grad_gap, grad_leaf = per[leaf], f"{prog}:{leaf}"
    change_gap, change_leaf = 0.0, ""
    for part, prog in (("g", "g"), ("d", "d"), ("g_ema", "g")):
        ref_grad = want["grads"][prog]
        med = common.median(ref_grad.values())
        keep = [k for k, v in ref_grad.items() if v >= 1e-3 * med]
        gap, leaf = common.leaf_gap({k: got["changes"][part][k] for k in keep},
                                    {k: want["changes"][part][k] for k in keep},
                                    floor_share=0.0)
        if gap >= change_gap:
            change_gap, change_leaf = gap, f"{part}:{leaf}"
    d_leaves = common.leaf_gaps(got["grads"]["d"], want["grads"]["d"])
    return {"d0_loss_gap": abs(got["losses"][0]["d_loss"] - d0) / abs(d0),
            "d0_grad_gap": max(d_leaves.values()), "d0_grad_median": common.median(d_leaves.values()),
            "grad_gap_median": common.median(leaves), "change_gap": change_gap,
            "loss_gap": max(max(g) for g in gaps), "grad_gap": grad_gap,
            "grad_leaf": grad_leaf, "change_leaf": change_leaf}


def check(st, env, result) -> dict:
    """Free the trainer, then follow the recorded iterations with the
    reference; returns the numbers (``numbers``)."""
    st.trainer = None
    if st.dev.type == "cuda":
        torch.cuda.empty_cache()
    want = follow(st, env)
    got = {"losses": st.losses, "grads": st.grads, "changes": st.changes}
    return numbers(got, want)


def control_draws(env, dev) -> dict:
    """Seeded draws of the recorded programs' shapes, as
    ``GANTrainer.draw`` makes them, for the control."""
    cfg, tr = env.config, env.traffic
    g, t = cfg["generator"], cfg["train"]
    rng = torch.Generator(dev).manual_seed(common.derived_seed(env.seed, 7))
    n_latent = 2 * int(g["size"]).bit_length() - 4
    layers = 2 * (int(g["size"]).bit_length() - 3) + 1

    def draw(b):
        z1 = torch.randn(b, g["style_dim"], generator=rng, device=dev)
        z2 = torch.randn(b, g["style_dim"], generator=rng, device=dev)
        mixed = torch.rand((), generator=rng, device=dev) < t["mixing"]
        inject = torch.where(mixed, torch.randint(1, n_latent, (), generator=rng, device=dev),
                             n_latent)
        noise = [torch.randn(b, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2), 1, generator=rng,
                             device=dev) for i in range(layers)]
        return (z1, z2, inject, noise)

    out = {}
    pb = max(1, tr["batch"] // t["path_batch_shrink"])
    for i in range(tr["check_iterations"]):
        out[i] = {"d": (None, draw(tr["batch"])), "g": (draw(tr["batch"]),)}
        if t["g_reg_every"] > 0 and i % t["g_reg_every"] == 0:
            out[i]["path"] = (draw(pb), torch.randn(pb, g["size"], g["size"], 3,
                                                    generator=rng, device=dev))
    return out


def control(env, trainer_cls=None) -> dict:
    """The control of ``check``: the reference, with TF32 on (or, given
    ``trainer_cls``, a reference trainer with a planted fault) in the
    program's place, through the same iterations from this seed's weights,
    held against the fp32 reference. Returns the same numbers as
    ``check``."""
    st = State()
    st.dev = resolve_device(env.device)
    g, d = env.config["generator"], env.config["discriminator"]
    with torch.device("meta"):
        gm = Generator(g["size"], channel_multiplier=g["channel_multiplier"])
        dm = Discriminator(d["size"], d["channel_multiplier"])
    _weights_and_reals(st, env, gm, dm)
    st.draws = control_draws(env, st.dev)
    want = follow(st, env)
    if trainer_cls is None:
        got = follow(st, env, tf32=True)
    else:
        got = follow(st, env, trainer_cls=trainer_cls)
    return numbers(got, want)

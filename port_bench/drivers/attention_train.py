"""Driver of region-attention mapper training: ``AttentionTrainer.step``
(``train/attention_trainer.py``) in S-space with clusters, as
``cli/run_attention.py --work_in_stylespace --use_cluster`` builds it, with
at most two steps in flight.

Set-up builds the generator, the mapper, a whole CLIP (text and image
towers) and VGG16 on the device, loads the benchmark's seeded weights into
them, encodes the demo's region prompts with the program's CLIP as the
attention bank, and drives the trainer through its first
``check_iterations`` steps through ``step`` itself, recording each step's
draws, the first step's gradients and the loss terms. The window continues
the same trainer. Once it has closed and the program is freed,
``reference/attention.py`` follows those steps from the same weights and
draws.
"""

from __future__ import annotations

import torch

from port_bench.lib import common, tokens
from port_bench.lib import weights as wlib
from port_bench.reference import attention as ref_att
from port_bench.reference import clip_text, stylegan2
from port_bench.work import attention as work_att
from where2edit_tpu_torch import resolve_device
from where2edit_tpu_torch.editing.attention_mappers import FullSpaceMapperFEATClusterLinStyle
from where2edit_tpu_torch.kernels import modconv3x3 as k1
from where2edit_tpu_torch.losses.clip_loss import CLIPLoss
from where2edit_tpu_torch.losses.perceptual import PerceptualLoss
from where2edit_tpu_torch.models.clip_model import CLIP
from where2edit_tpu_torch.models.stylegan2 import Generator
from where2edit_tpu_torch.models.vgg import Vgg16
from where2edit_tpu_torch.train.attention_trainer import AttentionTrainConfig, AttentionTrainer



class State:
    pass


def _models(cfg: dict, dev):
    g, m, t, v = cfg["generator"], cfg["mapper"], cfg["clip_text"], cfg["clip_image"]
    with torch.device(dev):
        gen = Generator(g["size"], style_dim=g["style_dim"], n_mlp=g["n_mlp"],
                        channel_multiplier=g["channel_multiplier"],
                        blur_kernel=g["blur_kernel"], lr_mlp=g["lr_mlp"])
        mapper = FullSpaceMapperFEATClusterLinStyle(
            layers=gen.n_latent, attention_layer=m["attention_layer"],
            cluster_layer=m["cluster_layer"], channel_multiplier=g["channel_multiplier"],
            clusters=m["clusters"], cluster_dim=m["cluster_dim"],
            coverage_threshold=m["coverage_threshold"], generator_size=g["size"])
        clip = CLIP(embed_dim=t["output_dim"], image_resolution=v["resolution"],
                    vision_width=v["width"], vision_layers=v["layers"],
                    vision_patch_size=v["patch_size"], context_length=t["context_length"],
                    vocab_size=t["vocab_size"], text_width=t["width"], text_heads=t["heads"],
                    text_layers=t["layers"], vision_heads=v["heads"])
        vgg = Vgg16()
    return {"generator": gen.to(dev), "mapper": mapper.to(dev), "clip": clip.to(dev),
            "vgg": vgg.to(dev)}


def _weights(st, env, modules: dict) -> None:
    rng = torch.Generator(st.dev).manual_seed(common.derived_seed(env.seed, 8))
    st.weights = {k: wlib.draw(wlib.shapes_of(m), env.config["init"][k], rng, st.dev)
                  for k, m in modules.items()}
    st.mean_seed = common.derived_seed(env.seed, 9)
    st.att_tokens = torch.tensor([tokens.tokenize(p) for p in env.traffic["attention_prompts"]],
                                 device=st.dev)


def _train_config(env) -> AttentionTrainConfig:
    cfg, tr = env.config, env.traffic
    t = cfg["attention_train"]
    return AttentionTrainConfig(
        stylegan_size=cfg["generator"]["size"],
        attention_layer=cfg["mapper"]["attention_layer"],
        cluster_layer=cfg["mapper"]["cluster_layer"], batch_size=tr["batch"], lr=t["lr"],
        lambda_ess=t["lambda_ess"], lambda_sec=t["lambda_sec"], lambda_id=t["lambda_id"],
        lambda_delta=t["lambda_delta"], step=t["step"], truncation=t["truncation"],
        work_in_stylespace=True, seed=common.derived_seed(env.seed, 10) % 2 ** 62)


def setup(env) -> State:
    st = State()
    st.dev = dev = resolve_device(env.device)
    modules = _models(env.config, dev)
    _weights(st, env, modules)
    for k, m in modules.items():
        m.load_state_dict(st.weights[k])
    gen, clip = modules["generator"], modules["clip"]
    size = env.config["generator"]["size"]
    mean = gen.mean_latent(4096, torch.Generator(dev).manual_seed(st.mean_seed))
    with torch.no_grad():
        st.bank = clip.encode_text(st.att_tokens)
    trainer = AttentionTrainer(
        _train_config(env), generator=gen, mapper=modules["mapper"],
        clip_loss=CLIPLoss(clip, size), perceptual=PerceptualLoss(modules["vgg"], size),
        mean_latent=mean, span=lambda stage, _t: env.span(f"attn.{stage}"))
    env.phase("weights_s")
    st.trainer, st.draws, st.losses, st.grads = trainer, [], [], {}
    step_with = trainer.step_with

    def recording(draws, step_idx, bank):
        st.draws.append(draws)
        out = step_with(draws, step_idx, bank)
        if step_idx == 0:
            st.grads = {n: float(p.grad.norm()) for n, p in
                        zip(trainer.param_names, trainer.params) if p.grad is not None}
        return out

    trainer.step_with = recording
    for i in range(env.traffic["check_iterations"]):
        aux, _, _ = trainer.step(i, st.bank)
        st.losses.append({k: float(v) for k, v in aux.items() if k != "att_idx"})
        env.phase("first_step_s" if i == 0 else f"step_{i}_s")
    del trainer.step_with
    st.changes = {n: float((p.detach() - st.weights["mapper"][n]).norm())
                  for n, p in zip(trainer.param_names, trainer.params)}
    st.next_step = env.traffic["check_iterations"]
    return st


def window(st, env, seconds: float) -> dict:
    """Time-limited (or, traced, ``trace_iterations`` steps)."""
    tr, trainer = env.traffic, st.trainer
    b = tr["batch"]

    def step():
        trainer.step(st.next_step, st.bank)
        st.next_step += 1

    launches = k1.launches
    n, done, window_s = common.closed_loop(env, step, seconds, tr["trace_iterations"])
    return {"attempted": n * b, "failed": 0, "units": done * b, "steps": done,
            "window_s": window_s,
            "k1_launches_per_step": (k1.launches - launches) / max(done, 1)}


def end_to_end(result: dict) -> dict:
    return {"mapper_samples_per_s": result["units"] / result["window_s"]}


def work(env) -> dict:
    return work_att.per_sample(env.config, env.traffic)


def follow(st, env, draws: list, tf32: bool = False, trainer_cls=ref_att.Trainer) -> dict:
    """The reference through the recorded steps: loss terms, the first
    step's gradient norms, the trained parameters' change."""
    cfg, tr = env.config, env.traffic
    train = dict(cfg["attention_train"])
    out = {"losses": [], "grads": {}}
    with common.precision(tf32):
        gsd = st.weights["generator"]
        rng = torch.Generator(st.dev).manual_seed(st.mean_seed)
        z = torch.randn(4096, cfg["generator"]["style_dim"], generator=rng, device=st.dev)
        with torch.no_grad():
            mean = stylegan2.style_mlp(gsd, z, cfg["generator"]).mean(0, keepdim=True)
            bank = clip_text.encode_text(st.weights["clip"], cfg["clip_text"], st.att_tokens)
        ref = trainer_cls(st.weights, cfg, train, mean)
        for i, d in enumerate(draws[:tr["check_iterations"]]):
            r = ref.step(d, i, bank)
            out["losses"].append(r["losses"])
            if i == 0:
                out["grads"] = {k: float(g.norm()) for k, g in r["grads"].items()}
        with torch.no_grad():
            out["changes"] = {k: float((ref.params[k] - st.weights["mapper"][k]).norm())
                              for k in ref.names}
    return out


def numbers(got: dict, want: dict) -> dict:
    """The numbers held against the reference: ``loss_gap`` (the loss
    terms of every recorded step, relative), ``loss_gap_first`` (the first
    two steps': the lr of Adam's first update is 0, so no weight has moved
    before the third), ``grad_gap`` and ``grad_gap_median`` (the worst and
    the median leaf of the first step's gradient) and ``change_gap`` (the
    worst leaf of the trained parameters' change, leaving out leaves whose
    reference gradient is nought to rounding: the frozen ones)."""
    gaps = [[abs(g[k] - r[k]) / max(abs(r[k]), 1e-30) for k in r]
            for g, r in zip(got["losses"], want["losses"])]
    per = common.leaf_gaps(got["grads"], want["grads"])
    grad_leaf = max(per, key=per.get)
    med = common.median(want["grads"].values())
    keep = [k for k, v in want["grads"].items() if v >= 1e-3 * med]
    change_gap, change_leaf = common.leaf_gap({k: got["changes"][k] for k in keep},
                                              {k: want["changes"][k] for k in keep},
                                              floor_share=0.0)
    return {"loss_gap": max(max(g) for g in gaps), "loss_gap_first": max(max(g) for g in gaps[:2]),
            "grad_gap": per[grad_leaf], "grad_gap_median": common.median(per.values()),
            "change_gap": change_gap, "grad_leaf": grad_leaf, "change_leaf": change_leaf}


def check(st, env, result) -> dict:
    """Free the trainer, then follow the recorded steps with the
    reference; returns the numbers (``numbers``)."""
    st.trainer = None
    if st.dev.type == "cuda":
        torch.cuda.empty_cache()
    want = follow(st, env, st.draws)
    got = {"losses": st.losses, "grads": st.grads, "changes": st.changes}
    return numbers(got, want)


def control(env, trainer_cls=None) -> dict:
    """The control of ``check``: the reference with TF32 on (or, given
    ``trainer_cls``, a reference trainer with a planted fault) in the
    program's place, through steps drawn from this seed, held against the
    fp32 reference."""
    st = State()
    st.dev = resolve_device(env.device)
    _weights(st, env, _models(env.config, "meta"))
    tr, g = env.traffic, env.config["generator"]
    rng = torch.Generator(st.dev).manual_seed(common.derived_seed(env.seed, 11))
    b, k = tr["batch"], len(tr["attention_prompts"])
    draws = [(torch.randn(b, g["style_dim"], generator=rng, device=st.dev),
              torch.randn(b, g["style_dim"], generator=rng, device=st.dev),
              torch.randint(0, k, (b,), generator=rng, device=st.dev))
             for _ in range(tr["check_iterations"])]
    want = follow(st, env, draws)
    if trainer_cls is None:
        return numbers(follow(st, env, draws, tf32=True), want)
    return numbers(follow(st, env, draws, trainer_cls=trainer_cls), want)

"""Driver of the edit traffic: batches of seeded faces, each row with an
edit prompt and an attention prompt drawn from the mix's phrase lists,
through ``EditSession`` (``demo/api.py``) in a closed loop with a fixed
number of batches in flight: the host enqueues batch k+1 before it waits
for batch k.

A batch: ``sample_wplus`` (seeded z, the style MLP, truncation), the
capture (``load_latent``), the text features of both prompts (the
session's CLIP text tower, as ``encode`` runs it, on token ids already on
the device), ``predict`` (the mapper and its map) and ``render`` (the
blended synthesis); the image, as uint8, and the map are then copied to
pinned host memory. An edit is done when its batch's copies have reached
the host; its latency runs from the start of its batch's enqueue.

Correctness: a sample of the window's batches, drawn from the seed
(reservoir sampling), keeps every stage's output on the device; once the
window has closed and the program is freed, ``reference/edit.py`` redoes
each kept batch from the same weights, seeds and token ids.
"""

from __future__ import annotations

import random
import time
from collections import deque

import torch

from port_bench.lib import common, tokens
from port_bench.lib import weights as wlib
from port_bench.reference import edit as ref_edit
from port_bench.work import edit as work_edit
from where2edit_tpu_torch import resolve_device
from where2edit_tpu_torch.demo.api import EditSession
from where2edit_tpu_torch.editing.attention_mappers import FullSpaceMapperFEATClusterLinStyle
from where2edit_tpu_torch.kernels import modconv1x1 as k3
from where2edit_tpu_torch.kernels import modconv3x3 as k1
from where2edit_tpu_torch.models.clip_model import TextTransformer
from where2edit_tpu_torch.models.stylegan2 import Generator

TABLE_BATCHES = 4096  # prompt draws kept on the device; batch k uses row k mod this


class State:
    pass


def _models(cfg: dict, dev):
    g, m, t = cfg["generator"], cfg["mapper"], cfg["clip_text"]
    with torch.device(dev):
        gen = Generator(g["size"], style_dim=g["style_dim"], n_mlp=g["n_mlp"],
                        channel_multiplier=g["channel_multiplier"],
                        blur_kernel=g["blur_kernel"], lr_mlp=g["lr_mlp"])
        mapper = FullSpaceMapperFEATClusterLinStyle(
            layers=gen.n_latent, attention_layer=m["attention_layer"],
            cluster_layer=m["cluster_layer"],
            channel_multiplier=g["channel_multiplier"], clusters=m["clusters"],
            cluster_dim=m["cluster_dim"], coverage_threshold=m["coverage_threshold"],
            generator_size=g["size"])
        text = TextTransformer(context_length=t["context_length"],
                               vocab_size=t["vocab_size"], width=t["width"],
                               layers=t["layers"], heads=t["heads"],
                               output_dim=t["output_dim"])
    return gen.to(dev).eval(), mapper.to(dev).eval(), text.to(dev).eval()


def _weights_and_inputs(st, env, modules: dict) -> None:
    """The seeded weights (drawn on the device in the order of ``modules``)
    and the prompt tables; the same seed gives the same ones."""
    cfg, tr, dev = env.config, env.traffic, st.dev
    rng = torch.Generator(dev).manual_seed(common.derived_seed(env.seed, 1))
    st.weights = {key: wlib.draw(wlib.shapes_of(m), cfg["init"][key], rng, dev)
                  for key, m in modules.items()}
    b = tr["batch"]
    st.prompt_tok = torch.tensor([tokens.tokenize(p) for p in tr["edit_prompts"]], device=dev)
    st.att_tok = torch.tensor([tokens.tokenize(p) for p in tr["attention_prompts"]], device=dev)
    draw = random.Random(common.derived_seed(env.seed, 2))
    st.prompt_idx = torch.tensor([[draw.randrange(len(tr["edit_prompts"])) for _ in range(b)]
                                  for _ in range(TABLE_BATCHES)], device=dev)
    st.att_idx = torch.tensor([[draw.randrange(len(tr["attention_prompts"])) for _ in range(b)]
                               for _ in range(TABLE_BATCHES)], device=dev)


def setup(env) -> State:
    st = State()
    cfg, tr = env.config, env.traffic
    st.dev = dev = resolve_device(env.device)
    gen, mapper, text = _models(cfg, dev)
    modules = {"generator": gen, "mapper": mapper, "clip_text": text}
    _weights_and_inputs(st, env, modules)
    for key, module in modules.items():
        module.load_state_dict(st.weights[key])
    st.session = EditSession(generator=gen, mapper=mapper, clip_encode_text=text,
                             attention_layer=cfg["mapper"]["attention_layer"])
    b = tr["batch"]
    pin = dev.type == "cuda"
    size = cfg["generator"]["size"]
    blend = 4 * 2 ** (cfg["mapper"]["attention_layer"] // 3)
    st.slots = [(torch.empty(b, size, size, 3, dtype=torch.uint8, pin_memory=pin),
                 torch.empty(b, blend, blend, 1, pin_memory=pin))
                for _ in range(tr["in_flight"] + 1)]
    env.phase("weights_s")
    _finish(st, env, _enqueue(st, env, -1))  # builds or loads the kernels
    env.phase("first_batch_s")
    for k in range(-tr["in_flight"] - 1, -1):
        _finish(st, env, _enqueue(st, env, k))
    env.phase("warmup_s")
    return st


def face_seed(seed: int, k: int) -> int:
    return common.derived_seed(seed, 3, k)


@torch.no_grad()
def _enqueue(st, env, k: int) -> tuple:
    tr, sess = env.traffic, st.session
    b = tr["batch"]
    t_enq = time.perf_counter()
    with env.span("edit.sample"):
        wplus = sess.sample_wplus(face_seed(env.seed, k), tr["truncation"], batch=b)
    with env.span("edit.capture"):
        sess.load_latent(wplus)
    with env.span("edit.encode"):
        row = k % TABLE_BATCHES
        both = sess.clip_encode_text(torch.cat([st.prompt_tok[st.prompt_idx[row]],
                                                st.att_tok[st.att_idx[row]]]))
        text, att = both[:b], both[b:]
    with env.span("edit.predict"):
        new_styles, amap = sess.predict(text, att, tr["strength_alpha"], tr["threshold"])
    with env.span("edit.render"):
        img = sess.render(new_styles, amap)
    image, mp = st.slots[k % len(st.slots)]
    u8 = ((img + 1.0) * 0.5).clamp_(0.0, 1.0).mul_(255.0).to(torch.uint8)
    image.copy_(u8, non_blocking=True)
    mp.copy_(amap, non_blocking=True)
    ev = None
    if st.dev.type == "cuda":
        ev = torch.cuda.Event()
        ev.record()
    out = {"text": text, "attention_text": att, "styles": sess.latent,
           "taps": sess.feature_map[:-1], "edited_styles": new_styles, "map": amap,
           "image": img}
    return k, t_enq, ev, out


def _finish(st, env, item) -> float:
    k, t_enq, ev, out = item
    with env.span("bench.wait"):
        if ev is not None:
            ev.synchronize()
    return time.perf_counter()


def window(st, env, seconds: float) -> dict:
    """Time-limited (or, traced, ``trace_batches`` batches) closed loop."""
    tr = env.traffic
    b, in_flight = tr["batch"], tr["in_flight"]
    keep, n_keep = [], tr["check_batches"]
    pick = random.Random(common.derived_seed(env.seed, 4))
    pending, latencies = deque(), []
    launches = (k1.launches, k3.launches)
    t0 = time.perf_counter()
    t_last, k = t0, 0

    def done(item):
        nonlocal t_last
        t_last = _finish(st, env, item)
        latencies.extend([(t_last - item[1]) * 1e3] * b)
        j = item[0] if item[0] < n_keep else pick.randrange(item[0] + 1)
        if j < n_keep:  # reservoir sample of the window's batches
            if len(keep) <= j:
                keep.append((item[0], item[3]))
            else:
                keep[j] = (item[0], item[3])

    while (k < tr["trace_batches"]) if env.trace else (time.perf_counter() - t0 < seconds):
        pending.append(_enqueue(st, env, k))
        while len(pending) >= in_flight:
            done(pending.popleft())
        k += 1
    while pending:
        done(pending.popleft())
    st.kept = keep
    return {"attempted": k * b, "failed": 0, "units": k * b, "steps": k,
            "window_s": t_last - t0, "latencies_ms": latencies,
            "k1_launches_per_step": (k1.launches - launches[0]) / max(k, 1),
            "k3_launches_per_step": (k3.launches - launches[1]) / max(k, 1)}


def end_to_end(result: dict) -> dict:
    return {"edits_per_s": result["units"] / result["window_s"],
            "edit_p95_ms": common.p95(result["latencies_ms"])}


def work(env) -> dict:
    return work_edit.per_edit(env.config, env.traffic)


def compare(got: dict, want: dict) -> dict:
    """The numbers compared for one batch (see ``check``)."""
    rows = [common.rel(got["image"][i], want["image"][i]) for i in range(got["image"].shape[0])]
    return {
        "text_rel": max(common.rel(got["text"], want["text"]),
                        common.rel(got["attention_text"], want["attention_text"])),
        "styles_rel": max(common.rel(a, b) for a, b in zip(got["styles"], want["styles"])),
        "taps_rel": max(common.rel(a, b) for a, b in zip(got["taps"], want["taps"])
                        if b is not None),
        "edited_rel": max(common.rel(a, b) for a, b in
                          zip(got["edited_styles"], want["edited_styles"])),
        "map_abs": float((got["map"].double() - want["map"].double()).abs().max()),
        "image_rows": rows,
    }


def reduce(per_batch: list) -> dict:
    """Worst over the batches; for the image, the median row and the worst
    row."""
    rows = sorted(r for p in per_batch for r in p["image_rows"])
    out = {k: max(p[k] for p in per_batch) for k in per_batch[0] if k != "image_rows"}
    out["image_rel_median"] = rows[len(rows) // 2]
    out["image_rel_max"] = rows[-1]
    return out


def reference_batch(st, env, k: int, mean, tf32: bool = False) -> dict:
    tr = env.traffic
    gcfg = env.config["generator"]
    with common.precision(tf32):
        wplus = ref_edit.seeded_wplus(st.weights["generator"], gcfg, face_seed(env.seed, k),
                                      tr["batch"], tr["truncation"], mean)
        row = k % TABLE_BATCHES
        return ref_edit.edit_batch(st.weights, env.config, wplus,
                                   st.prompt_tok[st.prompt_idx[row]],
                                   st.att_tok[st.att_idx[row]],
                                   strength_alpha=tr["strength_alpha"],
                                   threshold=tr["threshold"])


def check(st, env, result) -> dict:
    """Free the program, then hold every kept batch against the reference;
    returns the numbers (``reduce``)."""
    st.session = None
    if st.dev.type == "cuda":
        torch.cuda.empty_cache()
    with common.precision(False):
        mean = ref_edit.mean_latent(st.weights["generator"], env.config["generator"], st.dev)
    per_batch = [compare(out, reference_batch(st, env, k, mean)) for k, out in st.kept]
    return reduce(per_batch)


def control(env, batches: list) -> dict:
    """The control of ``check``: the reference computed with TF32 on, in
    the program's place, for ``batches`` of this seed, held against the
    fp32 reference. Returns the same numbers as ``check``."""
    st = State()
    st.dev = resolve_device(env.device)
    modules = dict(zip(("generator", "mapper", "clip_text"), _models(env.config, "meta")))
    _weights_and_inputs(st, env, modules)
    with common.precision(False):
        mean = ref_edit.mean_latent(st.weights["generator"], env.config["generator"], st.dev)
    with common.precision(True):
        mean_tf32 = ref_edit.mean_latent(st.weights["generator"], env.config["generator"],
                                         st.dev)
    per_batch = [compare(reference_batch(st, env, k, mean_tf32, tf32=True),
                         reference_batch(st, env, k, mean)) for k in batches]
    return reduce(per_batch)

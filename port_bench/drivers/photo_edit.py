"""Driver of the photo-edit traffic: Where2edit's real-photo path. Each
photo is inverted by the e4e encoder (``PSp.encode``) and the W+ it gives is
edited as the edit traffic edits a seeded face (``drivers/edit.py``), in a
closed loop with a fixed number of batches in flight.

Set-up builds the edit cell's generator, mapper and CLIP text tower with
its seeded weights, and ``PSp`` as ``demo/app.py::load_psp`` builds it
(``PSp.from_state_dict``) from a reference-layout e4e state dict drawn
from the seed by the configuration's ``init.encoder`` rules, with the
generator's mean latent as ``latent_avg``. It renders a bank of photos from
seeded z (truncation) with the plain synthesis of ``reference/stylegan2.py``
on the same weights, so that no kernel of the program prepares an input
that the program and the reference share; it face-pools them to the
encoder's input size, quantises them to 8-bit levels and holds them as
``demo/gallery.py::read_face_images`` returns photos: float32 NHWC in
[-1, 1], in pinned host memory.

A batch: consecutive photos of the bank (wrapping) copied to the device,
``PSp.encode``, ``load_latent``, the text features of both prompts,
``predict`` and ``render``; the image, as uint8, and the map are then copied
to pinned host memory. An edit is done when its batch's copies have
reached the host; its latency runs from the start of its batch's enqueue.

Correctness: a sample of the window's batches (as the edit traffic's)
keeps the W+ and every stage's output on the device; once the window has
closed and the program is freed, ``reference/e4e.py`` encodes the same
photos and ``reference/edit.py`` edits the reference's W+.
"""

from __future__ import annotations

import math
import random
import re
import time
from collections import deque

import torch
import torch.nn.functional as F

from port_bench.drivers import edit as edit_drv
from port_bench.lib import common, faults
from port_bench.lib import weights as wlib
from port_bench.reference import e4e as ref_e4e
from port_bench.reference import edit as ref_edit
from port_bench.reference import stylegan2 as ref_sg
from port_bench.work import e4e as work_e4e
from where2edit_tpu_torch import resolve_device
from where2edit_tpu_torch.demo.api import EditSession
from where2edit_tpu_torch.kernels import modconv1x1 as k3
from where2edit_tpu_torch.kernels import modconv3x3 as k1
from where2edit_tpu_torch.models.encoders import Encoder4Editing
from where2edit_tpu_torch.models.psp import PSp

TABLE_BATCHES = edit_drv.TABLE_BATCHES


class State:
    pass


def encoder_layout(ecfg: dict) -> dict:
    """{key: meta tensor} of the e4e state dict (the reference layout)."""
    with torch.device("meta"):
        enc = Encoder4Editing(ecfg["num_layers"], ecfg["mode"], ecfg["stylegan_size"],
                              ecfg["progressive_stage"])
    return enc.state_dict()


def _rule(rules: list, key: str) -> tuple:
    for pattern, kind, value in rules:
        if re.search(pattern, key):
            return kind, value
    raise KeyError(f"no init rule matches {key!r}")


def draw_encoder(layout: dict, rules: list, generator: torch.Generator, device) -> dict:
    """{key: tensor} on ``device`` by ``rules`` ([pattern, kind, value],
    first match): ``normal`` value·N(0, 1) and ``const`` as
    ``lib/weights.py`` draws them, and two kinds it lacks, ``fan_in``
    value·N(0, 1)/√fan_in and ``uniform`` U(lo, hi) for value [lo, hi];
    integer entries (BN's batch counts) are the const. The normal and fan_in
    entries are slices of ``lib/weights.draw``'s one draw, the uniform ones
    of a second draw, in the order of the keys."""
    plan = [(k, t, *_rule(rules, k)) for k, t in layout.items()]
    floats = [(k, t, kind) for k, t, kind, _ in plan if t.dtype.is_floating_point]
    unit = wlib.draw({k: t.shape for k, t, kind in floats if kind in ("normal", "fan_in")},
                     [[".", "normal", 1.0]], generator, device)
    uniform = torch.rand(sum(t.numel() for _, t, kind in floats if kind == "uniform"),
                         generator=generator, device=device)
    out, at = {}, 0
    for key, t, kind, value in plan:
        shape = tuple(t.shape)
        if not t.dtype.is_floating_point or kind == "const":
            out[key] = torch.full(shape, value, dtype=t.dtype, device=device)
        elif kind == "normal":
            out[key] = unit[key] * float(value)
        elif kind == "fan_in":
            out[key] = unit[key] * (float(value) / math.sqrt(math.prod(shape[1:])))
        elif kind == "uniform":
            lo, hi = value
            out[key] = lo + (hi - lo) * uniform[at:at + t.numel()].view(shape)
            at += t.numel()
        else:
            raise ValueError(f"unknown init kind {kind!r} for {key!r}")
    return out


def _encoder_weights(st, env) -> None:
    rng = torch.Generator(st.dev).manual_seed(common.derived_seed(env.seed, 20))
    st.encoder_weights = draw_encoder(encoder_layout(env.config["encoder"]),
                                      env.config["init"]["encoder"], rng, st.dev)


def photo_seed(seed: int, j: int) -> int:
    return common.derived_seed(seed, 21, j)


@torch.no_grad()
def render_photos(gsd: dict, env, n: int, out: torch.Tensor, mean: torch.Tensor) -> None:
    """Photos 0 … n − 1 of the bank into ``out`` (n, s, s, 3): each batch
    from seeded z at the traffic's truncation towards ``mean``, synthesised
    by ``reference/stylegan2.py`` in fp32 with the generator's fixed noise,
    face-pooled to the encoder's input (pSp's ``AdaptiveAvgPool2d``) and
    quantised to 8-bit levels."""
    b, size = env.traffic["batch"], env.config["encoder"]["input_size"]
    gcfg = env.config["generator"]
    noise = ref_sg.fixed_noise(gsd, gcfg)
    with common.precision(False):
        for j in range(0, n, b):
            w = ref_edit.seeded_wplus(gsd, gcfg, photo_seed(env.seed, j // b), b,
                                      env.traffic["truncation"], mean)
            img, _, _ = ref_sg.synthesis(gsd, gcfg, w, stylespace_input=False, noise=noise)
            face = F.adaptive_avg_pool2d(img, size).permute(0, 2, 3, 1).clamp(-1.0, 1.0)
            out[j:j + b].copy_(((face + 1.0) * 127.5).round() / 127.5 - 1.0)


def reference_mean(st, env) -> torch.Tensor:
    """The reference's mean latent (fp32), as the check and the bank use it."""
    with common.precision(False):
        return ref_edit.mean_latent(st.weights["generator"], env.config["generator"], st.dev)


def latent_avg(mean: torch.Tensor, ecfg: dict) -> torch.Tensor:
    """The mean latent (1, 512) in every W+ row."""
    return mean.reshape(1, -1).expand(ecfg["n_styles"], -1).contiguous()


def setup(env) -> State:
    st = State()
    cfg, tr = env.config, env.traffic
    st.dev = dev = resolve_device(env.device)
    gen, mapper, text = edit_drv._models(cfg, dev)
    modules = {"generator": gen, "mapper": mapper, "clip_text": text}
    edit_drv._weights_and_inputs(st, env, modules)
    for key, module in modules.items():
        module.load_state_dict(st.weights[key])
    _encoder_weights(st, env)
    st.session = EditSession(generator=gen, mapper=mapper, clip_encode_text=text,
                             attention_layer=cfg["mapper"]["attention_layer"])
    with torch.no_grad():
        mean = gen.mean_latent(4096, torch.Generator(dev).manual_seed(0))
    state = {f"encoder.{k}": v for k, v in st.encoder_weights.items()}
    state.update({f"decoder.{k}": v for k, v in st.weights["generator"].items()})
    st.psp = PSp.from_state_dict({"state_dict": state,
                                  "latent_avg": latent_avg(mean, cfg["encoder"])},
                                 stylegan_size=cfg["encoder"]["stylegan_size"], device=dev)
    st.psp.encoder.progressive_stage = cfg["encoder"]["progressive_stage"]
    env.phase("weights_s")
    b, pin, size = tr["batch"], dev.type == "cuda", cfg["encoder"]["input_size"]
    if tr["photos"] % b:
        raise ValueError(f"a bank of {tr['photos']} photos does not split into batches of {b}")
    st.bank = torch.empty(tr["photos"], size, size, 3, pin_memory=pin)
    st.ref_mean = reference_mean(st, env)
    render_photos(st.weights["generator"], env, tr["photos"], st.bank, st.ref_mean)
    env.phase("photos_s")
    g = cfg["generator"]["size"]
    blend = 4 * 2 ** (cfg["mapper"]["attention_layer"] // 3)
    st.slots = [(torch.empty(b, g, g, 3, dtype=torch.uint8, pin_memory=pin),
                 torch.empty(b, blend, blend, 1, pin_memory=pin))
                for _ in range(tr["in_flight"] + 1)]
    _finish(env, _enqueue(st, env, -1))  # the first call builds the kernels
    env.phase("first_batch_s")
    for k in range(-tr["in_flight"] - 1, -1):
        _finish(env, _enqueue(st, env, k))
    env.phase("warmup_s")
    return st


def photo_rows(env, k: int) -> slice:
    """Batch k's photos: the next ``batch`` of the bank, wrapping."""
    b = env.traffic["batch"]
    j = (k * b) % env.traffic["photos"]
    return slice(j, j + b)


@torch.no_grad()
def _enqueue(st, env, k: int) -> tuple:
    tr, sess = env.traffic, st.session
    b = tr["batch"]
    t_enq = time.perf_counter()
    with env.span("edit.invert"):
        photos = st.bank[photo_rows(env, k)].to(st.dev, non_blocking=True)
        wplus = st.psp.encode(photos)
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
    out = {"wplus": wplus, "text": text, "attention_text": att, "styles": sess.latent,
           "taps": sess.feature_map[:-1], "edited_styles": new_styles, "map": amap,
           "image": img}
    return k, t_enq, ev, out


def _finish(env, item) -> float:
    ev = item[2]
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
        t_last = _finish(env, item)
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
    return edit_drv.end_to_end(result)


def work(env) -> dict:
    return work_e4e.per_photo_edit(env.config, env.traffic)


def half_batch_encode(sd: dict, ecfg: dict, photos: torch.Tensor, avg) -> torch.Tensor:
    """A planted fault: half of the batch left out, the first half's W+ in
    every row of the second half too."""
    half = photos.shape[0] // 2
    w = ref_e4e.encode(sd, ecfg, photos[:half], avg)
    return torch.cat([w, w[:photos.shape[0] - half]])


# ``control.py --fault`` finds the fault by the traffic's driver
faults.TRAINERS.setdefault("photo_edit", {"half_batch": half_batch_encode})


def reference_batch(st, env, k: int, photos, mean, tf32: bool = False,
                    encode=ref_e4e.encode) -> dict:
    """The reference's W+ of ``photos`` and its edit (``reference/edit.py``)."""
    cfg, tr = env.config, env.traffic
    row = k % TABLE_BATCHES
    with common.precision(tf32):
        wplus = encode(st.encoder_weights, cfg["encoder"], photos,
                       latent_avg(mean, cfg["encoder"]))
        out = ref_edit.edit_batch(st.weights, cfg, wplus, st.prompt_tok[st.prompt_idx[row]],
                                  st.att_tok[st.att_idx[row]],
                                  strength_alpha=tr["strength_alpha"], threshold=tr["threshold"])
    out["wplus"] = wplus
    return out


def compare(got: dict, want: dict) -> dict:
    """The edit traffic's numbers, and ``wplus_rel``: max |Δ| / max |ref|
    of the W+."""
    return dict(edit_drv.compare(got, want), wplus_rel=common.rel(got["wplus"], want["wplus"]))


def check(st, env, result) -> dict:
    """Free the program, then hold every kept batch against the
    reference; returns the numbers (``edit_drv.reduce``)."""
    st.session = st.psp = None
    if st.dev.type == "cuda":
        torch.cuda.empty_cache()
    per_batch = []
    for k, out in st.kept:
        photos = st.bank[photo_rows(env, k)].to(st.dev)
        per_batch.append(compare(out, reference_batch(st, env, k, photos, st.ref_mean)))
    return edit_drv.reduce(per_batch)


def control(env, fault=None) -> dict:
    """The control of ``check``: the reference with TF32 on (or, given
    ``fault``, an encoder with a planted fault) in the program's place, on
    the first ``check_batches`` batches of this seed's bank, held against
    the fp32 reference. Returns the same numbers as ``check``."""
    st = State()
    cfg, tr = env.config, env.traffic
    st.dev = dev = resolve_device(env.device)
    gen, mapper, text = edit_drv._models(cfg, dev)
    modules = {"generator": gen, "mapper": mapper, "clip_text": text}
    edit_drv._weights_and_inputs(st, env, modules)
    del gen, mapper, text, modules
    _encoder_weights(st, env)
    n = tr["check_batches"] * tr["batch"]
    bank = torch.empty(n, cfg["encoder"]["input_size"], cfg["encoder"]["input_size"], 3,
                       device=dev)
    mean = reference_mean(st, env)
    render_photos(st.weights["generator"], env, n, bank, mean)
    with common.precision(True):
        mean_tf32 = ref_edit.mean_latent(st.weights["generator"], cfg["generator"], dev)
    per_batch = []
    for k in range(tr["check_batches"]):
        photos = bank[photo_rows(env, k)]
        want = reference_batch(st, env, k, photos, mean)
        got = (reference_batch(st, env, k, photos, mean_tf32, tf32=True) if fault is None
               else reference_batch(st, env, k, photos, mean, encode=fault))
        per_batch.append(compare(got, want))
    return edit_drv.reduce(per_batch)

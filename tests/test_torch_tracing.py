"""The port's tracer (``utils/profiling.py``): spans at the session,
trainer, modulated up-conv and ``upfirdn2d`` boundaries, their backward
spans, and what ``totals()`` sums.

Off (no profiler running): ``span`` is one shared null context, nothing is
recorded, and no profiler range, CUDA event, identity view or autograd hook
is made. On (``torch.profiler`` on the CPU): the spans nest with their
parent and root ids, sit on the profiler's clock around their own ``aten::``
operators, the layers' backward spans open during ``backward()`` with their
forward span as the cause, and images and gradients are bitwise those of an
untraced run, a ``create_graph`` double backward (as R1's) included. The
trainers', the session's and the evaluator's default stage hooks record
their ``trainer.*``, ``session.*`` and ``eval.*`` spans."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from where2edit_tpu_torch.demo.api import EditSession
from where2edit_tpu_torch.editing.attention_mappers import FullSpaceMapperFEATClusterLinStyle
from where2edit_tpu_torch.models.stylegan2 import Discriminator, Generator
from where2edit_tpu_torch.utils import profiling

SIZE = 16


@pytest.fixture(autouse=True)
def _fresh_tracer():
    profiling.reset()
    yield
    profiling.reset()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _models():
    rng = torch.Generator().manual_seed(0)
    g = Generator(SIZE, style_dim=32, n_mlp=2, channel_multiplier=1, rng=rng)
    d = Discriminator(SIZE, channel_multiplier=1)
    return g, d


def _names() -> list:
    return [r.name for r in profiling.TRACER.records]


def _graph_nodes(t: torch.Tensor) -> list:
    seen, todo = {}, [t.grad_fn]
    while todo:
        n = todo.pop()
        if n is None or id(n) in seen:
            continue
        seen[id(n)] = n
        todo += [f for f, _ in n.next_functions]
    return list(seen.values())


def test_torch_tracing_off_makes_nothing(monkeypatch):
    assert not profiling.enabled()
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a") as rec:
        assert rec is None

    def refuse(*a, **k):
        raise AssertionError("made while tracing is off")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.ops.aten, "alias", refuse)
    g, d = _models()
    w = torch.randn(2, 32, requires_grad=True)
    img = g([w], randomize_noise=False).image
    score = d(img).sum()
    assert not any(type(n).__name__ == "AliasBackward0" for n in _graph_nodes(score))
    monkeypatch.undo()
    with _profiled():  # a graph made while off has no hook that would record now
        score.backward()
    assert profiling.TRACER.records == [] and profiling.totals() == {}


def test_torch_tracing_spans_nest_on_the_profiler_clock():
    g, _ = _models()
    with _profiled() as prof:
        with profiling.span("outer") as outer:
            with torch.no_grad():
                g([torch.randn(2, 32)], randomize_noise=False)
    recs = {r.id: r for r in profiling.TRACER.records}
    by_name = {}
    for r in recs.values():
        by_name.setdefault(r.name, []).append(r)
    n_up = len(g.convs) // 2  # one up-conv per octave above 4x4
    assert len(by_name["layers.upconv"]) == n_up
    assert len(by_name["ops.upfirdn2d"]) == 2 * n_up  # the up-conv's blur, the skip's
    assert outer.parent is None and outer.root == outer.id
    for r in recs.values():
        if r is not outer:
            assert r.root == outer.id and r.cause is None
    for r in by_name["layers.upconv"]:
        assert r.parent == outer.id
    inner = [r for r in by_name["ops.upfirdn2d"] if r.parent != outer.id]
    assert len(inner) == n_up and all(recs[r.parent].name == "layers.upconv" for r in inner)
    for r in recs.values():
        assert r.host_start <= r.host_end and r.start is None

    events = [e for e in prof.events() if e.name in ("layers.upconv", "ops.upfirdn2d")]
    assert len(events) == 3 * n_up
    for e in events:
        ops = [c.name for c in e.cpu_children]
        assert any(n.startswith("aten::") for n in ops), (e.name, ops)
        if e.name == "ops.upfirdn2d":
            assert any("conv" in n.lower() for n in ops), ops
    ups = [e for e in events if e.name == "layers.upconv"]
    for e in events:
        if e.name == "ops.upfirdn2d" and e.cpu_parent is not None \
                and e.cpu_parent.name == "layers.upconv":
            assert any(u.time_range.start <= e.time_range.start
                       and e.time_range.end <= u.time_range.end for u in ups)


def test_torch_tracing_backward_spans():
    g, d = _models()
    w = torch.randn(2, 32, requires_grad=True)
    with _profiled() as prof:
        img = g([w], randomize_noise=False).image
        forward = {r.id: r for r in profiling.TRACER.records}
        d(img).sum().backward()
    recs = profiling.TRACER.records
    back = [r for r in recs if r.name.endswith(".backward")]
    names = {r.name for r in back}
    assert names == {"layers.upconv.backward", "ops.upfirdn2d.backward"}
    fwd_all = {r.id: r for r in recs if not r.name.endswith(".backward")}
    for r in back:
        cause = fwd_all[r.cause]
        assert r.name == cause.name + ".backward" and r.root == cause.root
    # every up-conv of G and every blur of G and D has exactly one backward
    assert sum(r.name == "layers.upconv.backward" for r in back) == \
        sum(r.name == "layers.upconv" for r in fwd_all.values())
    assert sum(r.name == "ops.upfirdn2d.backward" for r in back) == \
        sum(r.name == "ops.upfirdn2d" for r in fwd_all.values())
    assert all(r.name in ("layers.upconv", "ops.upfirdn2d") for r in forward.values())
    # an up-conv's backward holds the backward of its own blur
    ids = {r.id: r for r in back}
    nested = [r for r in back if r.parent in ids]
    assert nested and all(ids[r.parent].name == "layers.upconv.backward" for r in nested)
    assert {e.name for e in prof.events()} >= names


def test_torch_tracing_totals_counts_and_self_time(monkeypatch):
    class Ev:
        def __init__(self, t):
            self.t = t

        def elapsed_time(self, other):
            return other.t - self.t

    def rec(i, name, parent, t0, t1, stream=7):
        r = profiling.Record()
        r.id, r.name, r.parent, r.root, r.cause = i, name, parent, 0, None
        r.host_start, r.host_end = t0 * 1_000_000, t1 * 1_000_000
        r.stream, r.start, r.end = stream, Ev(t0), Ev(t1)
        return r

    profiling.TRACER.records = [
        rec(1, "child", 0, 2.0, 4.0), rec(2, "child", 0, 3.0, 6.0),
        rec(3, "other", 0, 5.0, 9.0, stream=8), rec(0, "outer", None, 0.0, 10.0)]
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    t = profiling.totals()
    assert t["child"]["count"] == 2 and t["outer"]["count"] == 1
    assert t["outer"]["device_s"] == pytest.approx(10e-3)
    assert t["outer"]["device_self_s"] == pytest.approx(6e-3)  # less [2, 6]; not stream 8's
    assert t["child"]["device_s"] == pytest.approx(5e-3)
    assert t["outer"]["host_s"] == pytest.approx(10e-3)
    for v in t.values():
        assert v["device_self_s"] <= v["device_s"]

    profiling.reset()
    g, _ = _models()
    with _profiled():
        with torch.no_grad():
            for _ in range(2):
                g([torch.randn(1, 32)], randomize_noise=False)
    t = profiling.totals()
    assert t["layers.upconv"]["count"] == 2 * (len(g.convs) // 2)
    assert t["layers.upconv"]["host_s"] > 0 and t["layers.upconv"]["device_s"] is None


def _synthesis_grads(g, d, w, create_graph: bool):
    g.zero_grad(set_to_none=True)
    d.zero_grad(set_to_none=True)
    w = w.clone().requires_grad_(True)
    img = g([w], randomize_noise=False).image
    score = d(img).sum()
    if create_graph:  # as R1 and the path penalty: a gradient, then its gradient
        (gw,) = torch.autograd.grad(score, w, create_graph=True)
        score = score + gw.square().sum()
    score.backward()
    grads = [p.grad.clone() for p in (*g.parameters(), *d.parameters()) if p.grad is not None]
    return img.detach(), grads


@pytest.mark.parametrize("create_graph", [False, True])
def test_torch_tracing_is_bitwise(create_graph):
    g, d = _models()
    w = torch.randn(2, 32, generator=torch.Generator().manual_seed(3))
    img0, grads0 = _synthesis_grads(g, d, w, create_graph)
    with _profiled():
        img1, grads1 = _synthesis_grads(g, d, w, create_graph)
    assert profiling.totals()["layers.upconv.backward"]["count"] >= len(g.convs) // 2
    assert torch.equal(img0, img1)
    assert len(grads0) == len(grads1) and len(grads0) > 10
    assert all(torch.equal(a, b) for a, b in zip(grads0, grads1))


def test_torch_tracing_gan_trainer_default_hooks():
    from where2edit_tpu_torch.train.gan_trainer import GANTrainConfig, GANTrainer  # noqa: PLC0415

    tr = GANTrainer(GANTrainConfig(size=SIZE, batch_size=2, channel_multiplier=1),
                    device="cpu")
    real = torch.rand(2, SIZE, SIZE, 3) * 2 - 1
    with _profiled():
        tr.step(real)  # iteration 0: d, r1, g, path, ema
    names = set(_names())
    assert {"trainer.gan.step", "trainer.gan.d", "trainer.gan.r1", "trainer.gan.g",
            "trainer.gan.path", "trainer.gan.ema"} <= names
    assert {"layers.upconv.backward", "ops.upfirdn2d.backward"} <= names
    step = next(r for r in profiling.TRACER.records if r.name == "trainer.gan.step")
    assert all(r.root == step.id for r in profiling.TRACER.records)
    profiling.reset()
    with _profiled():  # a caller's hook replaces the default
        tr.step(real, span=lambda program, trainer: profiling.span(f"mine.{program}"))
    names = set(_names())
    assert "mine.d" in names and not any(n.startswith("trainer.gan.d") for n in names)


def test_torch_tracing_session_default_spans():
    rng = torch.Generator().manual_seed(0)
    gen = Generator(32, rng=rng).eval()
    mapper = FullSpaceMapperFEATClusterLinStyle(layers=gen.n_latent, attention_layer=7,
                                                cluster_layer=7, generator_size=32,
                                                rng=rng).eval()
    table = torch.randn(4, 512, generator=rng)
    session = EditSession(generator=gen, mapper=mapper,
                          clip_encode_text=lambda tok: table[tok[:, 0]], attention_layer=7)
    with _profiled():
        session.load_latent(session.sample_wplus(5, batch=2))
        session.edit(np.array([[0], [1]]), np.array([[2], [3]]))
    names = _names()
    for name in ("session.sample", "session.capture", "session.encode", "session.predict",
                 "session.render", "predict.mapper", "predict.map", "ops.gaussian_blur"):
        assert name in names, name
    recs = {r.id: r for r in profiling.TRACER.records}
    for r in recs.values():
        if r.name in ("predict.mapper", "predict.map"):
            assert recs[r.parent].name == "session.predict"
        if r.name == "ops.gaussian_blur":
            assert recs[r.parent].name == "predict.map"


def test_torch_tracing_attention_trainer_default_hooks():
    from where2edit_tpu_torch.losses.clip_loss import CLIPLoss  # noqa: PLC0415
    from where2edit_tpu_torch.losses.perceptual import PerceptualLoss  # noqa: PLC0415
    from where2edit_tpu_torch.models.clip_model import CLIP  # noqa: PLC0415
    from where2edit_tpu_torch.models.vgg import VggFeatures  # noqa: PLC0415
    from where2edit_tpu_torch.train.attention_trainer import (  # noqa: PLC0415
        AttentionTrainConfig,
        AttentionTrainer,
    )

    class Pooled(torch.nn.Module):  # a cheap stand-in for VGG16's relu2_2
        def forward(self, x, last="relu4_3"):
            p = torch.nn.functional.avg_pool2d(x.permute(0, 3, 1, 2), 8)
            return VggFeatures(relu2_2=p.permute(0, 2, 3, 1))

    rng = torch.Generator().manual_seed(0)
    gen = Generator(32, rng=rng)
    mapper = FullSpaceMapperFEATClusterLinStyle(layers=gen.n_latent, attention_layer=7,
                                                cluster_layer=7, generator_size=32, rng=rng)
    clip = CLIP(embed_dim=512, image_resolution=224, vision_width=64, vision_layers=1,
                vision_patch_size=32, text_width=64, text_heads=1, text_layers=1,
                vision_heads=1).eval()
    cfg = AttentionTrainConfig(stylegan_size=32, attention_layer=7, cluster_layer=7,
                               batch_size=2, work_in_stylespace=True)
    tr = AttentionTrainer(cfg, generator=gen, mapper=mapper, clip_loss=CLIPLoss(clip, 32),
                          perceptual=PerceptualLoss(Pooled(), 32),
                          mean_latent=gen.mean_latent(64, rng))
    with _profiled():
        tr.step(0, torch.randn(3, 512, generator=rng))
    names = set(_names())
    assert {"trainer.attention.step", "trainer.attention.synthesis",
            "trainer.attention.cond_clip", "trainer.attention.mapper",
            "trainer.attention.edit", "trainer.attention.losses",
            "trainer.attention.backward", "trainer.attention.adam"} <= names
    assert "layers.upconv.backward" in names  # the edit synthesis' backward to the styles
    t = profiling.totals()
    assert t["trainer.attention.step"]["count"] == 1
    assert t["trainer.attention.step"]["host_s"] >= t["trainer.attention.backward"]["host_s"]


def test_torch_tracing_evaluator_default_hooks():
    from where2edit_tpu_torch.eval.metrics import EditEvaluator  # noqa: PLC0415

    def edit_fn(seed, text):
        return torch.zeros(text.shape[0], 8, 8, 3), torch.ones(text.shape[0], 8, 8, 3)

    ev = EditEvaluator(edit_fn=edit_fn,
                       encode_image=lambda x: x.reshape(x.shape[0], -1)[:, :4] + 1.0,
                       encode_text=lambda tok: torch.ones(tok.shape[0], 4))
    with _profiled():
        ev.run([0, 1], [torch.zeros(2, 3, dtype=torch.long)] * 2)
    assert {"eval.text", "eval.clip_image", "eval.inception"} <= set(_names())

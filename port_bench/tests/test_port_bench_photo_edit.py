"""The photo-edit cell (``drivers/photo_edit.py``) on the CPU at a tiny size
(64² generator, IR-SE 50 widths at 64² photos), its operation counts, and
its per-layer readers on stub contexts: None without spans or without a
device operation, never 0."""

from __future__ import annotations

import pytest
import torch

from port_bench import run
from port_bench.lib import spec
from port_bench.work import e4e as work_e4e
from where2edit_tpu_torch.models.encoders import Encoder4Editing
from where2edit_tpu_torch.nn.layers import EqualLinear

PHOTO_CPU = {"traffic_overrides": {"batch": 2, "photos": 4, "trace_batches": 2,
                                   "check_batches": 2},
             "config_overrides": {"generator": {"size": 64},
                                  "encoder": {"stylegan_size": 64, "n_styles": 10,
                                              "input_size": 64}}}
CTX = {"busy_s": 2.0, "window_s": 2.5, "units": 16, "steps": 2}


def _run(trace: int, seed: int = 3000000017) -> dict:
    return run.run(["--workload", "photo-edit-b8", "--seed", str(seed), "--seconds", "0.5",
                    "--trace", str(trace)], device="cpu", **PHOTO_CPU)


def test_port_bench_photo_edit_equals_reference():
    out = _run(0)
    values = {k: c["value"] for k, c in out["checks"].items()}
    # fp32 on both sides, sums in another order
    assert set(values) >= {"wplus_rel", "image_rel_max"} and max(values.values()) < 1e-4
    assert out["correct"] and out["attempted"] >= 2
    assert set(out["metrics"]) == {"edits_per_s", "edit_p95_ms", "setup_s"}


def test_port_bench_photo_edit_traced_reads_no_device_metric_on_the_cpu():
    out = _run(1)
    assert out["device"]["window_s"] > 0 and out["device"]["busy_s"] == 0
    assert out["metrics"] == {} and out["correct"]


def test_port_bench_e4e_counts_cover_its_convs_and_linears():
    """The count's convs and linears (2 per multiply-add) against forward
    hooks on the port's encoder at a small size; the rest of the count (BN,
    PReLU, SE, the adds, biases) adds a few per cent."""
    ecfg = dict(spec.Cell("photo-edit-b8").config["encoder"], stylegan_size=32, n_styles=8,
                input_size=64)
    enc = Encoder4Editing(stylegan_size=32, rng=torch.Generator().manual_seed(0)).eval()
    hooked = 0

    def conv(m, _, out):
        nonlocal hooked
        hooked += 2 * out.numel() // out.shape[0] * m.in_channels * m.kernel_size[0] ** 2

    def linear(m, inp, _):
        nonlocal hooked
        hooked += 2 * inp[0].shape[1] * m.weight.shape[0]

    for m in enc.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(conv)
        elif isinstance(m, EqualLinear):
            m.register_forward_hook(linear)
    with torch.no_grad():
        enc(torch.zeros(1, 64, 64, 3))
    counted = work_e4e.counts(ecfg, batch=8)["flops"]
    assert hooked < counted < 1.05 * hooked


def test_port_bench_e4e_counts_at_the_published_widths():
    cell = spec.Cell("photo-edit-b8")
    w = cell.driver().work(type("E", (), {"config": cell.config, "traffic": cell.traffic}))
    assert 140e9 < w["e4e_flops_per_unit"] < 150e9  # ~145 GFLOP a photo
    bound = w["kernel_bound_s_per_unit"]["e4e"]
    assert bound == pytest.approx(w["e4e_flops_per_unit"] / 164.9e12)  # compute-bound
    assert w["flops_per_unit"] > w["e4e_flops_per_unit"]


EDIT_PATH_METRICS = ["edit.capture_ms", "edit.render_ms", "k1_roofline.edit",
                     "idle_share.edit", "upconv_ms.edit", "upfirdn_ms.edit"]


def test_port_bench_photo_edit_reads_the_edit_paths_metrics():
    """The edit after the inversion is edit-b8's, so its per-layer metrics
    list the photo cell too, and K1's bound per edit is the edit's."""
    listed = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for name in EDIT_PATH_METRICS:
        assert listed[name]["workloads"] == ["edit-b8", "photo-edit-b8"]
    photo, edit = spec.Cell("photo-edit-b8"), spec.Cell("edit-b8")
    bounds = [c.driver().work(type("E", (), {"config": c.config, "traffic": c.traffic}))
              ["kernel_bound_s_per_unit"] for c in (photo, edit)]
    assert bounds[0]["k1"] == bounds[1]["k1"] > 0 and bounds[0]["e4e"] > 0


def test_port_bench_encoder_draw_slices_one_normal_draw_in_key_order():
    from port_bench.drivers import photo_edit  # noqa: PLC0415

    with torch.device("meta"):
        layout = {"a.weight": torch.empty(2, 3, 3, 3), "a.running_var": torch.empty(4),
                  "a.bias": torch.empty(2),
                  "a.num_batches_tracked": torch.empty((), dtype=torch.long),
                  "b.weight": torch.empty(5, 2)}
    rules = [["num_batches_tracked$", "const", 0.0], ["running_var$", "uniform", [0.5, 1.5]],
             ["bias$", "normal", 0.1], ["weight$", "fan_in", 1.0]]
    got = photo_edit.draw_encoder(layout, rules, torch.Generator().manual_seed(7), "cpu")
    rng = torch.Generator().manual_seed(7)
    normal = torch.randn(54 + 2 + 10, generator=rng)
    uniform = torch.rand(4, generator=rng)
    assert torch.equal(got["a.weight"], normal[:54].view(2, 3, 3, 3) * (1.0 / 27 ** 0.5))
    assert torch.equal(got["a.bias"], normal[54:56] * 0.1)
    assert torch.equal(got["b.weight"], normal[56:].view(5, 2) * (1.0 / 2 ** 0.5))
    assert torch.equal(got["a.running_var"], 0.5 + uniform)
    assert got["a.num_batches_tracked"].dtype == torch.long


def _reader(name):
    return spec.load_module(spec.BENCH_DIR / "metrics" / f"{name}.py",
                            "port_bench_metric_" + name.replace(".", "_"))


@pytest.mark.parametrize("name,span", [("e4e_ms.photo", "psp.encode"),
                                       ("e4e_trunk_ms.photo", "encoder.trunk"),
                                       ("e4e_roofline.photo", "psp.encode")])
def test_port_bench_photo_span_readers(name, span, monkeypatch):
    from where2edit_tpu_torch.utils import profiling  # noqa: PLC0415

    listed = {m["name"]: m for m in spec.benchmark()["per_layer"]}[name]
    assert listed["workloads"] == ["photo-edit-b8"] and listed["moves"] == "edits_per_s"
    read = _reader(name).read
    ctx = dict(CTX, work={"kernel_bound_s_per_unit": {"e4e": 0.88e-3}})
    fed = {span: {"count": 32, "host_s": 1.0, "device_s": 0.128, "device_self_s": 0.0}}
    monkeypatch.setattr(profiling, "totals", lambda: fed)
    want = 8.0 if name.endswith("_ms.photo") else 100.0 * 0.88 / 8.0
    assert read(ctx) == pytest.approx(want)
    assert read(dict(ctx, busy_s=0.0)) is None  # a CPU run
    fed[span]["device_s"] = 0.0
    assert read(ctx) is None  # never 0
    monkeypatch.setattr(profiling, "totals", lambda: {})
    assert read(ctx) is None  # a program without the span (the parent commit)
    monkeypatch.delattr(profiling, "totals")
    assert read(ctx) is None


def test_port_bench_mfu_photo_reader():
    read = _reader("mfu.photo").read
    ctx = dict(CTX, work={"flops_per_unit": 1e12},
               config={"precision": {"peak_flop_per_s": 164.9e12}})
    assert read(ctx) == pytest.approx(100.0 * 16e12 / 2.5 / 164.9e12)
    assert read(dict(ctx, busy_s=0.0)) is None

"""The readers of the program's own spans (``lib/program_spans.py``): None
on a CPU run, None on a program without the tracer (the import fails, or
the module has no ``totals``), None when the tracer fails, and the per-unit
or per-step number from the tracer's totals."""

from __future__ import annotations

import sys

import pytest

from port_bench.lib import spec

# metric: (span, per "units" or "steps", device or host seconds)
READERS = {
    "upconv_ms.edit": ("layers.upconv", "units", "device_s"),
    "upconv_ms.train": ("layers.upconv", "units", "device_s"),
    "upconv_ms.mapper": ("layers.upconv", "units", "device_s"),
    "upfirdn_ms.edit": ("ops.upfirdn2d", "units", "device_s"),
    "upfirdn_ms.train": ("ops.upfirdn2d", "units", "device_s"),
    "upfirdn_ms.mapper": ("ops.upfirdn2d", "units", "device_s"),
    "host_ms.mapper": ("trainer.attention.step", "steps", "host_s"),
}
CTX = {"busy_s": 2.0, "window_s": 2.5, "units": 16, "steps": 2}


def _reader(name):
    return spec.load_module(spec.BENCH_DIR / "metrics" / f"{name}.py",
                            "port_bench_metric_" + name.replace(".", "_"))


def _fed(span: str, key: str) -> dict:
    other = "host_s" if key == "device_s" else "device_s"
    totals = {span: {"count": 4, key: 0.8, other: 99.0, "device_self_s": 0.1},
              "unrelated": {"count": 1, "host_s": 5.0, "device_s": 5.0, "device_self_s": 5.0}}
    if key == "device_s":
        totals[span + ".backward"] = {"count": 4, "host_s": 9.0, "device_s": 0.4,
                                      "device_self_s": 0.1}
    return totals


@pytest.mark.parametrize("name", sorted(READERS))
def test_port_bench_program_span_reader(name, monkeypatch):
    from where2edit_tpu_torch.utils import profiling  # noqa: PLC0415

    listed = {m["name"]: m for m in spec.benchmark()["per_layer"]}[name]
    assert listed["source"] == "program_span" and len(listed["workloads"]) == 1
    span, per, key = READERS[name]
    read = _reader(name).read
    monkeypatch.setattr(profiling, "totals", lambda: _fed(span, key))
    assert read(dict(CTX, busy_s=0.0)) is None  # a CPU run: no device operation
    want = (0.8 + (0.4 if key == "device_s" else 0.0)) * 1e3 / CTX[per]
    assert read(CTX) == pytest.approx(want)
    monkeypatch.setattr(profiling, "totals", lambda: {})
    assert read(CTX) is None

    def failing():
        raise RuntimeError("an event was never recorded")

    monkeypatch.setattr(profiling, "totals", failing)
    assert read(CTX) is None
    monkeypatch.delattr(profiling, "totals")  # the parent commit's module
    assert read(CTX) is None
    monkeypatch.delattr(sys.modules["where2edit_tpu_torch.utils"], "profiling")
    monkeypatch.setitem(sys.modules, "where2edit_tpu_torch.utils.profiling", None)
    assert read(CTX) is None  # the import fails

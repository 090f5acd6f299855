"""Every file the benchmark names exists and loads, and files added by a
later change are found by name without an edit to the harness."""

from __future__ import annotations

import json
import shutil

from port_bench.lib import spec


def test_port_bench_every_named_file_loads():
    bench = spec.benchmark()
    configs = {c["name"]: c for c in bench["configs"]}
    names = [w["name"] for w in bench["workloads"]]
    assert len(set(names)) == len(names)
    for w in bench["workloads"]:
        cell = spec.Cell(w["name"])
        assert cell.config["name"] == w["config"] and cell.config["reduced"] == []
        assert cell.config_entry["reduced"] == cell.config["reduced"]
        assert callable(cell.driver().window)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]))
    for c in configs.values():
        assert spec.load_json(spec.ROOT / c["file"])["name"] == c["name"]
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", names)) <= set(names)
    cats = spec.categories()
    assert [c for c, _ in cats][:2] == ["k1-modconv3x3", "k2-conv3x3"]
    assert all(p for _, p in cats)


def test_port_bench_added_files_are_found(tmp_path):
    shutil.copytree(spec.BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.benchmark()
    bench["workloads"].append({"name": "dummy-b2", "config": "w2e-sspace-ffhq1024",
                               "traffic": "dummy-mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy.metric_ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "session",
                               "moves": "edits_per_s", "workloads": ["dummy-b2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = spec.load_json(spec.BENCH_DIR / "traffic" / "edits-b8.json")
    (tmp_path / "port_bench/traffic/dummy-mix.json").write_text(json.dumps(dict(mix, batch=2)))
    (tmp_path / "port_bench/metrics/dummy.metric_ms.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    (tmp_path / "port_bench/categories/dummy-kernels.json").write_text(
        json.dumps({"rank": 99, "patterns": ["dummy_kernel"]}))
    cell = spec.Cell("dummy-b2", root=tmp_path)
    assert cell.traffic["batch"] == 2
    assert [m["name"] for m in cell.per_layer] == ["dummy.metric_ms"]
    assert cell.reader("dummy.metric_ms")({}) == 42.0
    assert ("dummy-kernels", ["dummy_kernel"]) in cell.categories()
    assert cell.driver().__name__.endswith("edit")

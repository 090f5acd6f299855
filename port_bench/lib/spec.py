"""Finding a cell's files by name.

``BENCHMARK.json`` (at the root of the checkout) lists the cells, the
configurations and the metrics. Everything else is a file of its own under
``port_bench/``: ``configs/<file>`` (named by the configuration's ``file``),
``traffic/<traffic>.json`` (a mix's parameters and the driver that runs
it), ``drivers/<driver>.py``, ``metrics/<metric>.py`` (one reader per
per-layer metric) and ``categories/<category>.json`` (kernel-name
patterns).
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root=None) -> dict:
    return load_json(pathlib.Path(root or ROOT) / "BENCHMARK.json")


def load_module(path: pathlib.Path, name: str):
    """Import a source file under ``name`` (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def categories(bench_dir=None) -> list:
    """[(name, patterns)] in matching order (``rank``, then name)."""
    d = pathlib.Path(bench_dir or BENCH_DIR) / "categories"
    rows = [(load_json(p), p.stem) for p in sorted(d.glob("*.json"))]
    rows.sort(key=lambda r: (r[0]["rank"], r[1]))
    return [(name, [s.lower() for s in c["patterns"]]) for c, name in rows]


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, its
    traffic mix, its driver and its metrics."""

    def __init__(self, name: str, root=None, bench_dir=None):
        self.root = pathlib.Path(root or ROOT)
        self.bench_dir = pathlib.Path(bench_dir or self.root / "port_bench")
        bench = benchmark(self.root)
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r}; known: {sorted(by_name)}")
        self.name = name
        self.workload = by_name[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(self.root / self.config_entry["file"])
        self.traffic = load_json(self.bench_dir / "traffic" / f"{self.workload['traffic']}.json")
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if self._reports(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._reports(m)]

    def _reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def driver(self):
        name = self.traffic["driver"]
        return load_module(self.bench_dir / "drivers" / f"{name}.py",
                           f"port_bench_driver_{name}")

    def reader(self, metric: str):
        mod = load_module(self.bench_dir / "metrics" / f"{metric}.py",
                          "port_bench_metric_" + metric.replace(".", "_").replace("-", "_"))
        return mod.read

    def categories(self) -> list:
        return categories(self.bench_dir)

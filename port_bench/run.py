#!/usr/bin/env python3
"""The benchmark of the PyTorch + CUDA port (``where2edit_tpu_torch``) on
NVIDIA GPUs.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run is one process: it finds the cell's configuration, traffic mix and
driver by name (``lib/spec.py``), sets the program up from the seed, warms
up the cell's own shapes, measures for ``--seconds`` (with ``--trace 1``: a
fixed number of steps under ``torch.profiler``), checks what the timed path
produced against the plain reference in ``port_bench/reference/``, and
prints one JSON line as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` when
traced), then ``checks``, each number compared with its limit. The same
numbers are the last lines of standard error. Without a CUDA device, or with
fewer than the cell asks for, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench.lib import guard, spec  # noqa: E402
from port_bench.lib import trace as tracing  # noqa: E402


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)


T0 = time.perf_counter() - process_age_s()


def cache_dirs(root: pathlib.Path) -> None:
    """Fixed cache directories inside the checkout, so only a checkout's
    first run builds."""
    cache = root / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(cache / sub)


class Env:
    """What a driver gets: the seed, the device, the cell's configuration
    and traffic, whether the run is traced, the set-up clock and the
    spans."""

    def __init__(self, cell, seed: int, device, trace: bool):
        self.cell, self.seed, self.device, self.trace = cell, seed, device, trace
        self.config, self.traffic = cell.config, dict(cell.traffic)
        self.span_events = []  # (name, start event, end event) of traced spans
        self.setup = {}
        self._mark = time.perf_counter()
        self.setup["import_s"] = self._mark - T0

    def phase(self, name: str) -> None:
        """Close the set-up phase ``name`` (timed from the previous mark)."""
        self.sync()
        now = time.perf_counter()
        self.setup[name] = now - self._mark
        self._mark = now

    def sync(self) -> None:
        import torch  # noqa: PLC0415
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def span(self, name: str):
        """A span of a traced run: a profiler range and, on a card, a pair
        of CUDA events on the current stream around everything the block
        enqueues (the autograd engine's backward included), except for the
        benchmark's own ``bench.*`` spans. Off when not traced."""
        if not self.trace:
            return contextlib.nullcontext()
        return self._span(name)

    @contextlib.contextmanager
    def _span(self, name: str):
        import torch  # noqa: PLC0415
        from torch.profiler import record_function  # noqa: PLC0415
        timed = self.device.type == "cuda" and not name.startswith("bench.")
        with record_function(name):
            if timed:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            yield
            if timed:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self.span_events.append((name, start, end))

    def span_times(self) -> tuple:
        """({name: device seconds between its events, summed}, {name:
        count}); call after the device has finished."""
        secs, counts = {}, {}
        for name, start, end in self.span_events:
            secs[name] = secs.get(name, 0.0) + start.elapsed_time(end) / 1e3
            counts[name] = counts.get(name, 0) + 1
        return secs, counts


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_or_exit(chips: int):
    import torch  # noqa: PLC0415
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: the cell needs {chips} CUDA device(s), found {n}",
              file=sys.stderr)
        raise SystemExit(2)
    return torch.device("cuda")


def run(argv=None, *, device=None, traffic_overrides=None, config_overrides=None) -> dict:
    """One run; returns the result line's object. ``device`` and the
    overrides are for the CPU tests only (a tiny cell on the CPU); without
    them the run needs the cell's CUDA devices."""
    args = parse(argv)
    cell = spec.Cell(args.workload)
    cache_dirs(cell.root)
    guard.check_loaded("start")
    import torch  # noqa: PLC0415

    dev = device_or_exit(cell.chips) if device is None else torch.device(device)
    driver = cell.driver()
    guard.check_loaded("after loading the driver")
    env = Env(cell, args.seed, dev, bool(args.trace))
    env.traffic.update(traffic_overrides or {})
    if config_overrides:
        env.config = {k: (dict(v, **config_overrides[k]) if k in config_overrides else v)
                      for k, v in env.config.items()}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    state = driver.setup(env)
    env.sync()
    setup_s = time.perf_counter() - T0
    print(json.dumps({"setup": {k: round(v, 4) for k, v in env.setup.items()},
                      "setup_s": setup_s}), flush=True)

    summary = None
    env.span_events.clear()  # the set-up's spans are not the window's
    if env.trace:
        from torch.profiler import ProfilerActivity, profile, record_function  # noqa: PLC0415
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            with record_function(tracing.WINDOW_SPAN):
                result = driver.window(state, env, args.seconds)
        t = time.perf_counter()
        summary = tracing.summarize(prof, cell.categories())
        del prof
        summary["spans_s"], summary["span_counts"] = env.span_times()
        print(json.dumps({"trace_read_s": time.perf_counter() - t,
                          "categories_s": summary["categories_s"],
                          "spans_s": summary["spans_s"]}), flush=True)
    else:
        result = driver.window(state, env, args.seconds)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    guard.check_loaded("after the window")
    print(json.dumps({"window": {k: v for k, v in result.items() if k != "latencies_ms"}}),
          flush=True)

    t = time.perf_counter()
    values = driver.check(state, env, result)
    del state
    print(json.dumps({"check_s": time.perf_counter() - t, "readings": values}), flush=True)
    limits = env.traffic["limits"]
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    if env.trace:
        ctx = dict(result, **summary, work=driver.work(env), config=env.config,
                   traffic=env.traffic)
        for m in cell.per_layer:
            value = cell.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(driver.end_to_end(result), setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    dev_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
               "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": result["attempted"],
           "failed": result["failed"], "metrics": metrics, "device": dev_rec}
    if summary is not None:
        dev_rec.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        out["breakdown"] = summary["breakdown"]
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    out = run(argv)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

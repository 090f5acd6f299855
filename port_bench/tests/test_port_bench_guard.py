"""The import guard compares top-level module names whole."""

from __future__ import annotations

import json
import subprocess
import sys

from port_bench.lib import guard, spec


def test_port_bench_guard_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "where2edit_tpu",
             "where2edit_tpu.models", "where2edit_tpu_torch", "where2edit_tpu_torch.ops",
             "jaxtyping", "flaxen"]
    assert guard.loaded_forbidden(names) == ["flax.linen", "jax", "jax.numpy",
                                             "jaxlib.xla_client", "where2edit_tpu",
                                             "where2edit_tpu.models"]


def test_port_bench_reference_imports_no_program():
    refused = guard.JAX_NAMES | {guard.PORT_NAME}
    for path in sorted((spec.BENCH_DIR / "reference").glob("*.py")):
        assert not guard.imported_names(path) & refused, path.name


def _modules_after(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=spec.ROOT, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_bench_run_and_drivers_load_no_jax():
    code = ("import json, sys; sys.path.insert(0, '.')\n"
            "from port_bench import run, control\n"
            "from port_bench.lib import guard, spec\n"
            "for w in spec.benchmark()['workloads']: spec.Cell(w['name']).driver()\n"
            "print(json.dumps(guard.loaded_forbidden()))")
    assert _modules_after(code) == []


def test_port_bench_reference_loads_no_port():
    code = ("import json, sys; sys.path.insert(0, '.')\n"
            "from port_bench.reference import clip_text, edit, gan, mapper, ops, stylegan2\n"
            "from port_bench.lib import guard\n"
            "print(json.dumps(guard.loaded_forbidden(forbidden=guard.JAX_NAMES"
            " | {guard.PORT_NAME})))")
    assert _modules_after(code) == []

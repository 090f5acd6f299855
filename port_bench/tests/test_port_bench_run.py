"""run.py refuses to run without the cell's CUDA devices and without the
program."""

from __future__ import annotations

import shutil
import subprocess
import sys

import pytest

from port_bench.lib import spec

ARGS = ["--workload", "edit-b8", "--seed", "5", "--seconds", "1", "--trace", "0"]


def test_port_bench_run_refuses_without_a_card():
    import torch  # noqa: PLC0415
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "port_bench/run.py", *ARGS], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_port_bench_run_refuses_without_the_program(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "port_bench/run.py", *ARGS], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""

"""The controls at the cells' own sizes, on the card: the reference in TF32
in the program's place, and a planted fault, must each come out as not
correct on three seeds. Run on the card with
``python -m pytest -m cuda port_bench/tests/test_port_bench_control.py``."""

from __future__ import annotations

import pytest

from port_bench import control

SEEDS = (2400000011, 2400000012, 2400000013)


@pytest.mark.cuda
@pytest.mark.parametrize("workload,fault", [
    ("edit-b8", None), ("gan-train-b8", None), ("gan-train-b8", "half_batch"),
    ("mapper-train-b8", None), ("mapper-train-b8", "half_batch")])
def test_port_bench_control_is_not_correct(cuda, workload, fault):
    for seed in SEEDS:
        assert not control.control(workload, seed, fault)["correct"]

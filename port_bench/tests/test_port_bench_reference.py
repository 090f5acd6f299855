"""The frozen reference against the port's plain path on the CPU, through
each driver's own run at a tiny size: the edit at 64², one GAN iteration at
16², two mapper steps at 64²."""

from __future__ import annotations

from port_bench import run
from port_bench.tests.conftest import ATT_CPU, EDIT_CPU, GAN_CPU


def _run(workload, trace, sizes, seed=3000000017):
    return run.run(["--workload", workload, "--seed", str(seed), "--seconds", "0.5",
                    "--trace", str(trace)], device="cpu", **sizes)


def test_port_bench_reference_edit_equals_port():
    out = _run("edit-b8", 0, EDIT_CPU)
    values = {k: c["value"] for k, c in out["checks"].items()}
    # fp32 on both sides, sums in another order
    assert max(values.values()) < 1e-4
    assert out["correct"] and out["attempted"] >= 2
    assert set(out["metrics"]) == {"edits_per_s", "edit_p95_ms", "setup_s"}


def test_port_bench_reference_gan_iteration_equals_port():
    out = _run("gan-train-b8", 0, GAN_CPU)
    values = {k: c["value"] for k, c in out["checks"].items()}
    assert values["d0_loss_gap"] < 1e-5 and values["d0_grad_median"] < 1e-4
    # a bias's gradient sums every pixel of a small batch with cancellation
    assert values["d0_grad_gap"] < 1e-2 and out["correct"]
    assert set(out["metrics"]) == {"train_samples_per_s", "setup_s"}


def test_port_bench_reference_mapper_steps_equal_port():
    out = _run("mapper-train-b8", 0, ATT_CPU)
    values = {k: c["value"] for k, c in out["checks"].items()}
    assert max(values.values()) < 1e-3 and out["correct"]


def test_port_bench_traced_edit_reads_no_device_metric_on_the_cpu():
    out = _run("edit-b8", 1, EDIT_CPU)
    assert out["device"]["window_s"] > 0 and out["device"]["busy_s"] == 0
    assert out["metrics"] == {} and out["correct"]

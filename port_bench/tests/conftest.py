"""Fixtures of the benchmark's own tests (CPU unless marked ``cuda``)."""

from __future__ import annotations

import pytest

# tiny sizes at which a cell's timed path runs on the CPU in seconds
EDIT_CPU = {"traffic_overrides": {"batch": 2, "trace_batches": 2, "check_batches": 2},
            "config_overrides": {"generator": {"size": 64}}}
ATT_CPU = {"traffic_overrides": {"batch": 2, "trace_iterations": 2, "check_iterations": 2},
           "config_overrides": {"generator": {"size": 64}}}
GAN_CPU = {"traffic_overrides": {"batch": 4, "trace_iterations": 2, "check_iterations": 1},
           "config_overrides": {"generator": {"size": 16}, "discriminator": {"size": 16}}}


@pytest.fixture
def cuda():
    """Skip unless a CUDA device is present (decided here, never at import)."""
    import torch  # noqa: PLC0415
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")

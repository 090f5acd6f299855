"""Run logging (counterpart of where2edit_tpu/utils/logging.py): a stdout
tee into ``run.log`` and scalar metrics as JSON lines (plus TensorBoard
when importable)."""

from __future__ import annotations

import json
import os
import time


class Logger:
    """Tee stdout to a log file."""

    def __init__(self, stdout, filename: str):
        self.terminal = stdout
        self.logfile = filename

    def write(self, message):
        self.terminal.write(message)
        if self.logfile:
            try:
                with open(self.logfile, "a") as f:
                    f.write(message)
            except OSError:
                pass

    def flush(self):
        self.terminal.flush()


class MetricsWriter:
    """Scalar metrics → ``metrics.jsonl`` (+ TensorBoard when importable)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        try:
            from torch.utils.tensorboard import SummaryWriter  # noqa: PLC0415

            self._tb = SummaryWriter(log_dir=log_dir)
        except Exception:
            self._tb = None

    def add_scalar(self, tag: str, value, step: int):
        with open(self.path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value),
                                "step": int(step), "t": time.time()}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def close(self):
        if self._tb is not None:
            self._tb.close()


def read_scalars(log_dir: str) -> list:
    """The rows a ``MetricsWriter`` wrote."""
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]

"""Run logging (counterpart of where2edit_tpu/utils/logging.py): a stdout
tee into ``run.log`` and scalar metrics as JSON lines (plus TensorBoard
when importable). In a data-parallel group only rank 0 writes metrics."""

from __future__ import annotations

import json
import os
import time

from where2edit_tpu_torch.parallel.dist import is_main


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
    """Scalar metrics → ``metrics.jsonl`` (+ TensorBoard when importable);
    on a rank other than 0 of a data-parallel group it writes nothing."""

    def __init__(self, log_dir: str):
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._tb = None
        self._on = is_main()
        if not self._on:
            return
        os.makedirs(log_dir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter  # noqa: PLC0415

            self._tb = SummaryWriter(log_dir=log_dir)
        except Exception:
            self._tb = None

    def add_scalar(self, tag: str, value, step: int):
        if not self._on:
            return
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

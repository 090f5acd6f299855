"""Asynchronous real-image pipeline for adversarial training (counterpart
of where2edit_tpu/train/loader.py).

A producer thread keeps ``prefetch`` batches in flight: the images of a
batch are decoded on a pool of ``workers`` threads (PIL's decode releases
the GIL), stacked, flipped where a coin says so, and copied to the
trainer's device, so the next batch is ready while the card runs the
current step.

Determinism: the producer draws the sample indices from the numpy
Generator it is handed, in batch order, so with ``hflip`` off the stream is
bit for bit ``bank.sample(rng, batch)`` called in a loop on the same
Generator. The flip coins come from a Generator of their own, so turning
flips on does not move the index stream.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch


class PrefetchLoader:
    """Background-producer iterator over an ``ImageBank``: float32 (batch,
    size, size, 3) tensors in [-1, 1] on ``device`` (pinned and copied
    without blocking where the device is a card). Use it as a context
    manager, or call ``close()``, which stops the producer and joins it."""

    def __init__(self, bank, batch: int, *, rng: np.random.Generator,
                 workers: int = 4, prefetch: int = 3, hflip: bool = False,
                 flip_seed=0, device=None):
        if batch <= 0 or workers <= 0 or prefetch <= 0:
            raise ValueError("batch, workers, prefetch must be positive")
        self.bank = bank
        self.batch = batch
        self.rng = rng
        self.hflip = hflip
        # an int seed, or a Generator already positioned (a resumed run
        # continues its flip stream)
        self.flip_rng = (flip_seed if isinstance(flip_seed, np.random.Generator)
                         else np.random.default_rng(flip_seed))
        self.device = torch.device("cpu" if device is None else device)
        self._stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                        else None)
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="w2e-decode")
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._producer = threading.Thread(target=self._produce, daemon=True,
                                          name="w2e-prefetch")
        self._producer.start()

    # ----------------------------------------------------------- producer
    def _make_batch(self) -> np.ndarray:
        idx = self.rng.integers(0, len(self.bank), size=self.batch)
        out = np.stack(list(self._pool.map(self.bank._load_one,
                                           [int(i) for i in idx])))
        if self.hflip:
            coins = self.flip_rng.random(self.batch) < 0.5
            if coins.any():
                out = out.copy()
                out[coins] = out[coins][:, :, ::-1, :]
        return out

    def _to_device(self, arr: np.ndarray) -> tuple:
        """(the batch on the device, the event its copy ends at, or None)."""
        t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
        if self._stream is None:
            return t.to(self.device), None
        # the copy runs on the loader's stream; the consumer's stream waits
        # for its event (record_stream keeps the memory from being reused
        # early)
        with torch.cuda.stream(self._stream):
            out = t.pin_memory().to(self.device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(self._stream)
        return out, event

    def _produce(self):
        try:
            while not self._stop.is_set():
                item = self._to_device(self._make_batch())
                # a bounded put that stays responsive to close()
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced on the consumer side
            self._error = e
            self._stop.set()

    # ----------------------------------------------------------- consumer
    def __iter__(self):
        return self

    def _ready(self, item) -> torch.Tensor:
        out, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            out.record_stream(stream)
        return out

    def __next__(self) -> torch.Tensor:
        while True:
            # batches produced before a failure drain before it surfaces
            try:
                return self._ready(self._queue.get_nowait())
            except queue.Empty:
                pass
            if self._error is not None:
                raise RuntimeError(
                    f"PrefetchLoader producer failed: "
                    f"{type(self._error).__name__}: {self._error}") from self._error
            try:
                return self._ready(self._queue.get(timeout=0.1))
            except queue.Empty:
                if self._stop.is_set() and self._error is None:
                    raise StopIteration from None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self):
        """Stop the producer, drain the queue (so a blocked put sees the
        stop) and join the thread."""
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._producer.join(timeout=5.0)
        self._pool.shutdown(wait=False)

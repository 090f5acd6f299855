"""Tracing and timing helpers (counterpart of where2edit_tpu/utils/profiling.py).

- ``trace(logdir)``: ``torch.profiler`` around the block (the CPU, and the
  card when there is one), written to ``logdir`` as a gzipped Chrome trace
  that holds the program's spans beside its operators and kernels; after
  the block, ``totals()`` gives each span's time.
- The tracer: ``span(name)`` (a context manager), ``spanned(name)`` (a
  decorator) and ``spanned_layer(name)`` (a decorator that also spans the
  layer's backward) mark the program's layer boundaries. They record only
  while a ``torch.profiler`` runs (``torch.autograd.profiler``'s
  ``_is_profiler_enabled``); otherwise a boundary costs one attribute read.
  ``totals()`` sums the records per span name; ``reset()`` clears them.
- ``sync_fetch(res)``: wait for the card, then copy one element of the first
  and the last tensor of ``res`` to the host; returns ``res``.
- ``StageTimer``: named wall-clock stages, each fenced by
  ``torch.cuda.synchronize`` on both sides when a card is in use.
"""

from __future__ import annotations

import contextlib
import functools
import gzip
import itertools
import os
import shutil
import socket
import tempfile
import threading
import time

import torch
from torch.autograd import profiler as autograd_profiler

_OFF = contextlib.nullcontext()


def _tensors(res) -> list:
    if isinstance(res, torch.Tensor):
        return [res]
    if isinstance(res, dict):
        res = list(res.values())
    if isinstance(res, (list, tuple)):
        return [t for r in res for t in _tensors(r)]
    return []


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def sync_fetch(res):
    """``res`` unchanged, once the card has finished it: a
    ``torch.cuda.synchronize`` and a host copy of one element of its first
    and last tensors (nested lists, tuples and dicts are searched)."""
    _sync()
    leaves = _tensors(res)
    for leaf in ({id(leaves[0]): leaves[0], id(leaves[-1]): leaves[-1]}.values()
                 if leaves else ()):
        if leaf.numel():
            leaf.reshape(-1)[0].item()
    return res


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; the Chrome trace lands in ``logdir`` as
    ``<host>.<pid>.<ns>.trace.json.gz``, with the program's spans on the
    same clock as its operators and kernels. The tracer's records are
    cleared on entry, so ``totals()`` after the block reads the block."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    name = f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}.trace.json"
    with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, name)
        prof.export_chrome_trace(raw)
        with open(raw, "rb") as src, gzip.open(os.path.join(logdir, name + ".gz"),
                                               "wb") as dst:
            shutil.copyfileobj(src, dst)


# ------------------------------------------------------------------ tracer
def enabled() -> bool:
    """Whether a ``torch.profiler`` runs, and so the tracer records."""
    return autograd_profiler._is_profiler_enabled


class Record:
    """One span: ``name``; ``id``; ``parent``, the id of the innermost span
    open on the same thread when it opened; ``root``, the id of the
    outermost one (a backward span takes its cause's); ``cause``, the id of
    the forward span of a ``.backward`` span; host ``perf_counter_ns`` at
    entry and exit; on a card, the CUDA stream current at entry and two
    timing events recorded on it."""

    __slots__ = ("id", "name", "parent", "root", "cause", "host_start", "host_end",
                 "stream", "start", "end", "_handle", "_stack")


class Tracer:
    """The records of closed spans, in the order they closed, and a stack of
    open spans per thread (the autograd engine runs a card's backward on a
    thread of its own).

    Under a profiler that traces the card, each torch call on the host costs
    microseconds, so a span keeps to the cheap ones: the profiler's
    fast range (``_RecordFunctionFast``, the range ``record_function``
    opens, without its two dispatched operators) and one ``Stream`` object
    per raw stream, cached (``torch.cuda.current_stream()`` builds a new
    one on each call)."""

    def __init__(self):
        self.records: list[Record] = []
        self._ids = itertools.count()
        self._local = threading.local()
        self._streams = {}  # (device, raw stream) -> torch.cuda.Stream

    def _current_stream(self):
        dev = torch.cuda.current_device()
        key = (dev, torch._C._cuda_getCurrentRawStream(dev))
        stream = self._streams.get(key)
        if stream is None:
            stream = self._streams[key] = torch.cuda.current_stream(dev)
        return stream

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, name: str, cause: Record | None = None) -> Record:
        stack = self._stack()
        parent = stack[-1] if stack else None
        rec = Record()
        rec.id, rec.name, rec._stack = next(self._ids), name, stack
        rec.parent = None if parent is None else parent.id
        rec.cause = None if cause is None else cause.id
        rec.root = (cause.root if cause is not None
                    else rec.id if parent is None else parent.root)
        rec._handle = torch._C._profiler._RecordFunctionFast(name)
        rec._handle.__enter__()
        rec.stream = rec.start = rec.end = None
        if torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
            rec.stream = self._current_stream()
            rec.start = torch.cuda.Event(enable_timing=True)
            rec.start.record(rec.stream)
        stack.append(rec)
        rec.host_start = time.perf_counter_ns()
        return rec

    def close(self, rec: Record) -> None:
        rec.host_end = time.perf_counter_ns()
        if rec.start is not None:
            rec.end = torch.cuda.Event(enable_timing=True)
            rec.end.record(rec.stream)
        rec._handle.__exit__(None, None, None)
        stack = rec._stack
        for i in range(len(stack) - 1, -1, -1):  # a backward span may close out of order
            if stack[i] is rec:
                del stack[i]
                break
        rec._handle = rec._stack = None
        self.records.append(rec)

    def hook_backward(self, cause: Record, out_node, in_nodes: list) -> None:
        """Span ``<cause.name>.backward`` from the pre-hook of ``out_node``
        (the layer's output's ``grad_fn``) to the pre-hooks of ``in_nodes``
        (the ``grad_fn`` of each input's identity view), which run once
        every node of the layer's backward has. The hooks return None, so
        the gradients are untouched; each backward pass through the nodes
        gives a span, and the span waits only for the inputs that pass needs
        (``torch.autograd.grad(inputs=...)`` may skip some)."""
        name = cause.name + ".backward"
        pending = []  # [record, inputs still to come] per open pass

        def opening(grad_outputs):
            if not enabled():
                return
            waits = sum(torch._C._will_engine_execute_node(n) for n in in_nodes)
            if waits:
                pending.append([self.open(name, cause), waits])

        def closing(grad_outputs):
            if pending:
                entry = pending[-1]
                entry[1] -= 1
                if not entry[1]:
                    pending.pop()
                    self.close(entry[0])

        out_node.register_prehook(opening)
        for node in in_nodes:
            node.register_prehook(closing)

    def totals(self) -> dict:
        """{span name: {count, host_s, device_s, device_self_s}}; a span's
        device self time is its device time less what the spans that opened
        inside it on the same stream and thread cover. Device times wait for
        the card and are None without one."""
        recs = self.records
        timed = [r for r in recs if r.start is not None]
        at = {}
        if timed:
            torch.cuda.synchronize()
            ref = min(timed, key=lambda r: r.host_start).start
            at = {r.id: (ref.elapsed_time(r.start), ref.elapsed_time(r.end)) for r in timed}
        children = {}
        for r in timed:
            if r.parent is not None:
                children.setdefault(r.parent, []).append(r)
        out = {}
        for r in recs:
            t = out.setdefault(r.name, {"count": 0, "host_s": 0.0, "device_s": None,
                                        "device_self_s": None})
            t["count"] += 1
            t["host_s"] += (r.host_end - r.host_start) / 1e9
            if r.id not in at:
                continue
            t0, t1 = at[r.id]
            inner = [(max(at[c.id][0], t0), min(at[c.id][1], t1))
                     for c in children.get(r.id, ()) if c.stream == r.stream]
            t["device_s"] = (t["device_s"] or 0.0) + (t1 - t0) / 1e3
            t["device_self_s"] = ((t["device_self_s"] or 0.0)
                                  + max(t1 - t0 - _covered(inner), 0.0) / 1e3)
        return out

    def reset(self) -> None:
        self.records = []


def _covered(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, edge = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > edge:
            total += e - max(s, edge)
            edge = e
    return total


TRACER = Tracer()


class _Span:
    __slots__ = ("name", "record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> Record:
        self.record = TRACER.open(self.name)
        return self.record

    def __exit__(self, *exc) -> None:
        TRACER.close(self.record)


def span(name: str):
    """A context manager that records the span ``name`` while a profiler
    runs, and one shared ``nullcontext`` otherwise."""
    if not autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def stage_spans(prefix: str):
    """The default of a ``span=`` stage hook: ``hook(stage, *owner)`` is
    ``span(f"{prefix}.{stage}")``."""
    return lambda stage, *_: span(f"{prefix}.{stage}")


def spanned(name: str):
    """Decorate a function to run inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def spanned_layer(name: str):
    """``spanned(name)`` for a layer whose backward gets the span
    ``<name>.backward`` too: when autograd records the call, each
    positional tensor argument that needs a gradient passes through one
    identity view (``aten.alias``: strides kept, gradient passed as it is)
    whose ``grad_fn`` closes that span, and the output tensor's
    ``grad_fn`` opens it (``Tracer.hook_backward``). Nothing of this runs
    without a profiler."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            nodes = []
            if torch.is_grad_enabled():
                args = tuple(torch.ops.aten.alias(a) if isinstance(a, torch.Tensor)
                             and a.requires_grad else a for a in args)
                nodes = [a.grad_fn for a in args
                         if isinstance(a, torch.Tensor) and a.grad_fn is not None]
            with _Span(name) as rec:
                out = fn(*args, **kwargs)
            if nodes and isinstance(out, torch.Tensor) and out.grad_fn is not None:
                TRACER.hook_backward(rec, out.grad_fn, nodes)
            return out
        return inner
    return wrap


def totals() -> dict:
    """``TRACER.totals()``: per span name, the count, host seconds, device
    seconds and device self seconds."""
    return TRACER.totals()


def reset() -> None:
    """Clear the tracer's records."""
    TRACER.reset()


class StageTimer:
    """Wall-clock seconds per named stage, summed over its runs."""

    def __init__(self):
        self.stages: dict[str, float] = {}

    def _add(self, name: str, dt: float) -> None:
        self.stages[name] = self.stages.get(name, 0.0) + dt

    @contextlib.contextmanager
    def stage(self, name: str):
        _sync()
        t0 = time.perf_counter()
        yield
        _sync()
        self._add(name, time.perf_counter() - t0)

    def time_fn(self, name: str, fn, *args, **kwargs):
        _sync()
        t0 = time.perf_counter()
        out = sync_fetch(fn(*args, **kwargs))
        self._add(name, time.perf_counter() - t0)
        return out

    def ms(self) -> dict:
        return {k: v * 1e3 for k, v in self.stages.items()}

    def report(self) -> str:
        total = sum(self.stages.values()) or 1.0
        lines = [f"{name:32s} {dt * 1000:9.2f} ms  {dt / total * 100:5.1f}%"
                 for name, dt in sorted(self.stages.items(),
                                        key=lambda kv: -kv[1])]
        return "\n".join(lines)

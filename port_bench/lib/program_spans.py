"""What the readers of the program's own spans share. The port's tracer
(``where2edit_tpu_torch.utils.profiling``) records only while a profiler
runs, so in a traced run its totals are the traced window's. A reader
returns None on a run with no device operation (the CPU tests'), on a
program that has no tracer, and when the tracer fails; it never raises."""

from __future__ import annotations

import sys


def totals(ctx: dict):
    """The tracer's ``totals()``, or None (see the module's docstring)."""
    if not ctx.get("busy_s"):
        return None
    try:
        from where2edit_tpu_torch.utils import profiling  # noqa: PLC0415
    except ImportError:
        return None
    read = getattr(profiling, "totals", None)
    if read is None:  # a program without the tracer
        return None
    try:
        return read()
    except Exception as e:  # noqa: BLE001 -- a reader must not end the run
        print(f"port_bench: the program's tracer failed: {e!r}", file=sys.stderr)
        return None


def device_ms_per_unit(ctx: dict, span: str):
    """Device ms inside ``span`` and its backward span per unit (edit or
    sample) of the traced window."""
    t = totals(ctx)
    if t is None or not ctx["units"]:
        return None
    s = sum(t[n]["device_s"] or 0.0 for n in (span, span + ".backward") if n in t)
    return s * 1e3 / ctx["units"] if s else None


def host_ms_per_step(ctx: dict, span: str):
    """Host ms inside ``span`` per step of the traced window."""
    t = totals(ctx)
    if t is None or span not in t or not ctx["steps"]:
        return None
    return t[span]["host_s"] * 1e3 / ctx["steps"]

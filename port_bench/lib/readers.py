"""What the per-layer metric readers share. A reader takes the traced
run's context (``run.py``: the trace summary, the units and steps of the
traced window and the configuration's work counts) and returns a number,
or None when the trace holds nothing for it (a run with no device
operation, such as the CPU tests', reads None everywhere); it never
returns 0 for a share of a roofline or of a peak."""

from __future__ import annotations


def span_ms_per_step(ctx: dict, span: str):
    """Device busy ms inside ``span`` per step (batch or iteration) of the
    traced window."""
    s = ctx["spans_s"].get(span)
    if not s or not ctx["steps"]:
        return None
    return s * 1e3 / ctx["steps"]


def category_ms_per_unit(ctx: dict, category: str):
    s = ctx["categories_s"].get(category)
    if not s or not ctx["units"]:
        return None
    return s * 1e3 / ctx["units"]


def roofline_pct(ctx: dict, kernel: str, category: str):
    """The least time the work of ``kernel`` per unit needs, over the
    device time of its category per unit, in %."""
    s = ctx["categories_s"].get(category)
    bound = ctx["work"]["kernel_bound_s_per_unit"].get(kernel)
    if not s or not bound or not ctx["units"]:
        return None
    return 100.0 * bound * ctx["units"] / s


def mfu_pct(ctx: dict):
    """Model operations per unit over the traced window, as a share of the
    configuration's peak rate."""
    if not ctx["units"] or not ctx["busy_s"]:
        return None
    rate = ctx["work"]["flops_per_unit"] * ctx["units"] / ctx["window_s"]
    return 100.0 * rate / ctx["config"]["precision"]["peak_flop_per_s"]


def idle_pct(ctx: dict):
    """None where the trace holds no device operation (a CPU run)."""
    if not ctx["busy_s"]:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])

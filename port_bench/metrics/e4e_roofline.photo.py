"""e4e's least time per photo (work/e4e.py: max(bytes / HBM bandwidth, FLOP / peak rate)) over its device time per photo in PSp.encode, in %."""

from port_bench.lib.program_spans import device_ms_per_unit


def read(ctx):
    ms = device_ms_per_unit(ctx, "psp.encode")
    bound = ctx["work"]["kernel_bound_s_per_unit"].get("e4e")
    if ms is None or not bound:
        return None
    return 100.0 * bound * 1e3 / ms

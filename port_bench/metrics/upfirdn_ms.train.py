"""Device ms per trained sample in the FIR blurs of G and D, forward (ops.upfirdn2d) and backward (ops.upfirdn2d.backward)."""

from port_bench.lib.program_spans import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, "ops.upfirdn2d")

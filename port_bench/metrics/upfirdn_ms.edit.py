"""Device ms per edit in the FIR blurs (span ops.upfirdn2d: the up-convs' blur and the ToRGB skips' upsampling)."""

from port_bench.lib.program_spans import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, "ops.upfirdn2d")

"""Device ms per edit in the blurs category (the FIR blurs of ops/upfirdn2d.py and the map's Gaussian blur)."""

from port_bench.lib.readers import category_ms_per_unit


def read(ctx):
    return category_ms_per_unit(ctx, "blurs")

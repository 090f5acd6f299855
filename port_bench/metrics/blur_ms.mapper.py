"""Device ms per mapper training sample in the blurs category."""

from port_bench.lib.readers import category_ms_per_unit


def read(ctx):
    return category_ms_per_unit(ctx, "blurs")

"""Device ms per photo inside PSp.encode (span psp.encode: the e4e inversion, trunk and style blocks)."""

from port_bench.lib.program_spans import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, "psp.encode")

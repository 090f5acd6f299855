"""Device ms per photo inside e4e's IR-SE 50 trunk (span encoder.trunk)."""

from port_bench.lib.program_spans import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, "encoder.trunk")

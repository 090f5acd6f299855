"""Device ms per edit in the modulated up-convs (span layers.upconv: transposed conv, demod, blur, epilogue)."""

from port_bench.lib.program_spans import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, "layers.upconv")

"""Device ms per mapper sample in the modulated up-convs, forward (layers.upconv) and backward (layers.upconv.backward)."""

from port_bench.lib.program_spans import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, "layers.upconv")

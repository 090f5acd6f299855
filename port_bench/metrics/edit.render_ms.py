"""Device ms per batch inside EditSession.render (the blended synthesis)."""

from port_bench.lib.readers import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, "edit.render")

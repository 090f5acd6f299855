"""Device ms per batch inside EditSession.load_latent (the capture synthesis)."""

from port_bench.lib.readers import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, "edit.capture")

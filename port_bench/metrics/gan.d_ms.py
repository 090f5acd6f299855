"""Device ms per iteration inside GANTrainer program d."""

from port_bench.lib.readers import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, "gan.d")

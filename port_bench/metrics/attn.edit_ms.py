"""Device ms per step inside AttentionTrainer stage edit (the blended synthesis)."""

from port_bench.lib.readers import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, "attn.edit")

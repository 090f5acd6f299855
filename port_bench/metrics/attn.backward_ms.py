"""Device ms per step inside AttentionTrainer stage backward."""

from port_bench.lib.readers import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, "attn.backward")

"""Host ms per mapper training step inside AttentionTrainer.step (span trainer.attention.step): the host's own time per step."""

from port_bench.lib.program_spans import host_ms_per_step


def read(ctx):
    return host_ms_per_step(ctx, "trainer.attention.step")

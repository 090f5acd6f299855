"""Share of the traced window with no operation on the device, in %."""

from port_bench.lib.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)

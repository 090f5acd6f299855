"""The whole photo edit's model operations (e4e, then the edit) as a share of the configuration's peak rate, in %."""

from port_bench.lib.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx)

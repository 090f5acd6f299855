"""K2's share of its roofline over a trained sample's K2 calls, in %."""

from port_bench.lib.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "k2", "k2-conv3x3")

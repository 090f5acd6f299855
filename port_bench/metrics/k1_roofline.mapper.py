"""K1's share of its roofline over a mapper training sample's K1 calls (forward and input gradients), in %."""

from port_bench.lib.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "k1", "k1-modconv3x3")

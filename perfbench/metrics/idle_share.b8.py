"""The share of the traced window in which the device ran no kernel, copy
or fill: 1 - (the union of their intervals) / (the window)."""

from perfbench.harness.readers import idle_share


def read(ctx):
    return idle_share(ctx)

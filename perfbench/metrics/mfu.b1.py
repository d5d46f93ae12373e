"""The whole request's share of the chip's bf16 peak: the request's FLOPs
(counted on the reference) times the requests in the traced window, over
its wall time."""

from perfbench.harness.readers import mfu


def read(ctx):
    return mfu(ctx)

"""The micro-step's share of the chip's bf16 peak: its FLOPs (forward and
the backward the trainable leaves need, counted on the reference) times
the micro-steps in the traced window, over its wall time."""

from perfbench.harness.readers import mfu


def read(ctx):
    return mfu(ctx)

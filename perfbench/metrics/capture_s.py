"""Seconds the program spent capturing the cell's signatures as CUDA graphs
at set-up: the sum of ``Captured.capture_s`` over ``pipe.programs``."""


def read(ctx):
    return ctx.get("capture_s") or None

"""Share of the roofline of the GroupNorm(+SiLU) kernels: each call's input
read once and output written once in the served type (counted on the
reference) over the device time of the kernels below, in the traced
window; bandwidth-bound."""

from perfbench.harness.readers import kernel_roofline

PATTERNS = (r"group_?norm",)


def read(ctx):
    return kernel_roofline(ctx, "gn_flops", "gn_bytes", PATTERNS)

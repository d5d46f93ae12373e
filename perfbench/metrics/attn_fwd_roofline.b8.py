"""Share of the roofline of the attention-forward kernels: the long
self-attentions' operations and bytes (counted on the reference, see
``harness/work.py``) over the device time of the kernels below, which
include PyTorch's SDPA kernels, in the traced window."""

from perfbench.harness.readers import kernel_roofline

PATTERNS = (r"flash_fwd", r"fmha_cutlassF", r"efficient_attention_forward",
            r"sdpa.*fprop", r"fprop.*sdpa", r"flash_attn.*fwd", r"fmha.*fwd")


def read(ctx):
    return kernel_roofline(ctx, "attn_fwd_flops", "attn_fwd_bytes", PATTERNS)

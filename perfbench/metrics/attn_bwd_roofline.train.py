"""Share of the roofline of the attention-backward kernels in stage-2
training: the long self-attentions' backward operations and bytes
(counted on the reference, see ``harness/work.py``) over the device time
of the kernels below, which include PyTorch's SDPA backward kernels."""

from perfbench.harness.readers import kernel_roofline

PATTERNS = (r"flash_bwd", r"bwd_delta", r"fmha_cutlassB", r"efficient_attention_backward",
            r"sdpa.*bprop", r"bprop.*sdpa", r"flash_attn.*bwd", r"fmha.*bwd")


def read(ctx):
    return kernel_roofline(ctx, "attn_bwd_flops", "attn_bwd_bytes", PATTERNS)

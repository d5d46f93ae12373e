"""Device seconds a request spends in its sampler loop, the UNet's steps
(the program's ``stage_mark`` launches 2 to 3), the mean over the traced
window's requests."""

from perfbench.harness.program_spans import mean_device_s


def read(ctx):
    return mean_device_s(ctx, ("unet_loop",))

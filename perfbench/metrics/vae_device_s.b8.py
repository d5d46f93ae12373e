"""Device seconds a request spends in its VAE decode and uint8 cast (the
program's ``stage_mark`` launches 3 to 4), the mean over the traced
window's requests."""

from perfbench.harness.program_spans import mean_device_s


def read(ctx):
    return mean_device_s(ctx, ("vae",))

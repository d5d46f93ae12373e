"""Device seconds a request spends in its audio conditioning and CLIP text
(the program's ``stage_mark`` launches 0 to 2), the mean over the traced
window's requests."""

from perfbench.harness.program_spans import mean_device_s


def read(ctx):
    return mean_device_s(ctx, ("condition_audio", "text"))

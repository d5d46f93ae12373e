"""Images per coalesced batch in the window, from the service's own
counters (``InferenceService.metrics()["coalesce"]``): images / batches."""


def read(ctx):
    batches = ctx.get("coalesce_batches", 0)
    return ctx["coalesce_images"] / batches if batches else None

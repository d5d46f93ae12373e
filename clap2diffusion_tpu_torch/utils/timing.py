"""Device time of one call on the card, free of the host's pace.

``graph_ms(fn)`` captures ``n`` calls of ``fn`` in one CUDA graph, replays
it, and times the replays with CUDA events: the launches cost the host one
graph launch, so the time is the device's, back to back. A call that cannot
be captured (a synchronising call, a launch that CUDA refuses to capture)
raises here, which also shows whether a kernel can go into a CUDA graph of
the UNet step.
"""

from __future__ import annotations

import torch


def graph_ms(fn, n: int = 20, replays: int = 5) -> float:
    """Mean ms of one call of ``fn`` from a CUDA graph of ``n`` calls."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # warm-up off the default stream, as capture wants
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * n)
    del graph
    return ms

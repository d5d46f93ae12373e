"""Device time of one call on the card, free of the host's pace.

``graph_ms(fn)`` captures ``n`` calls of ``fn`` in one CUDA graph, replays
it, and times the replays with CUDA events: the launches cost the host one
graph launch, so the time is the device's, back to back. A call that cannot
be captured (a synchronising call, a launch that CUDA refuses to capture)
raises here, which also shows whether a kernel can go into a CUDA graph of
the UNet step. ``sdpa_backward_device_ms`` times autograd through
``scaled_dot_product_attention`` the same way, the yardstick of the flash
backward kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def graph_ms(fn, n: int = 20, replays: int = 5, stream=None) -> float:
    """Mean ms of one call of ``fn`` from a CUDA graph of ``n`` calls,
    captured on ``stream`` (a side stream of its own by default; autograd
    runs a backward on the stream its forward ran on, so a backward is
    captured on that one)."""
    stream = stream if stream is not None else torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # warm-up off the default stream, as capture wants
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
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


def sdpa_backward_device_ms(q, k, v, do, scale: float) -> float:
    """Device ms of autograd through ``scaled_dot_product_attention`` (the
    backward alone, for the upstream gradient ``do``): a CUDA graph of
    ``torch.autograd.grad`` on an output computed on the capture stream."""
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
    torch.cuda.synchronize()
    return graph_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True),
                    stream=stream)

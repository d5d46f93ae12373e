"""Shared arithmetic of the per-layer readers in ``metrics/``. Each
returns None when its window has nothing to read (no trace, no kernel
matched, no peak known for the device): the metric is then left out."""

from __future__ import annotations

from typing import Dict, Iterable, Optional

from perfbench.harness.reduce import roofline


def units(ctx: Dict) -> int:
    """Requests (serving) or micro-steps (training) in the traced window."""
    return ctx.get("requests", ctx.get("micro_steps", 0))


def kernel_roofline(ctx: Dict, flops_key: str, bytes_key: str,
                    patterns: Iterable[str]) -> Optional[float]:
    trace, peaks = ctx.get("trace"), ctx.get("peaks")
    if trace is None or peaks is None:
        return None
    seconds, launches = trace.kernel_seconds(patterns)
    if launches == 0:
        return None
    n = units(ctx)
    return roofline(n * ctx["work"][flops_key], n * ctx["work"][bytes_key], seconds, peaks)


def mfu(ctx: Dict) -> Optional[float]:
    """The window's model FLOPs (counted on the reference) over its wall
    time and the chip's bf16 peak, in %."""
    trace, peaks = ctx.get("trace"), ctx.get("peaks")
    if trace is None or peaks is None or trace.window_s <= 0:
        return None
    return 100.0 * units(ctx) * ctx["work"]["flops"] / (trace.window_s * peaks["flops_bf16"])


def idle_share(ctx: Dict) -> Optional[float]:
    trace = ctx.get("trace")
    if trace is None or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)

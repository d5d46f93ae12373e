"""The kernels' launch counters, in one registry.

Each kernel wrapper counts where it launches its kernel: ``launches``, and
the shapes it launched at, ``shapes`` (a ``Counter``); ``quant.int8_gemm``
counts the int8 products in ``calls``. A wrapper joins the registry where
it defines its counters (``kernel``, ``register``), and whoever reads,
resets or adds to the counts reads the registry: ``diffusion/program.py``
adds a captured program's counts at every replay, ``chip_smoke.py`` checks
them.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, Optional, Tuple

# "holder.attribute" -> (holder, attribute), in the order the wrappers join
COUNTERS: Dict[str, Tuple[object, str]] = {}


def register(holder: object, attr: str, name: Optional[str] = None) -> None:
    """``holder.attr`` (an int or a ``Counter``) joins the registry as
    ``name.attr`` (``name``: the holder's ``__name__`` by default)."""
    COUNTERS[f"{name or holder.__name__}.{attr}"] = (holder, attr)


def kernel(fn: Callable) -> Callable:
    """A kernel wrapper's counters, at zero: ``fn.launches`` and
    ``fn.shapes``."""
    fn.launches = 0
    fn.shapes = collections.Counter()
    register(fn, "launches")
    register(fn, "shapes")
    return fn


def kernels() -> Tuple[Callable, ...]:
    """The kernel wrappers, as they joined."""
    return tuple(h for h, a in COUNTERS.values() if a == "launches")

"""The benchmark's own spans: named host intervals around its calls into
the program, each a ``torch.profiler.record_function`` that a traced run's
trace shows (``bench/<name>``), where it names the device's idle gaps."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def span(name: str):
    with torch.profiler.record_function("bench/" + name):
        yield


def wrap(obj, attr: str, name: str) -> None:
    """Open span ``name`` around every call of ``obj.attr`` (an instance's
    method), so that a trace can say when the program was in it."""
    fn = getattr(obj, attr)

    def spanned(*a, **kw):
        with span(name):
            return fn(*a, **kw)

    setattr(obj, attr, spanned)

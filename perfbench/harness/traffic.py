"""The one traffic generator: every mix is a data file of parameters
(``traffic/<name>.json``) that this module reads. All draws come from the
run's ``--seed`` through ``numpy.random.default_rng``, so a seed gives the
same inputs on every machine.

A mix names its ``driver`` (``serve_closed``, ``serve_open`` or ``train``)
and the inputs' parameters:

- ``audio``: ``seconds``, ``rate`` (Hz), ``pool`` (distinct waveforms drawn
  at set-up), ``tones`` [lo, hi] sine components (log-uniform 50 Hz-8 kHz)
  under a random envelope, ``noise`` [lo, hi] white-noise level, and
  ``pcm16`` (whether a waveform is sent as 16-bit PCM);
- ``prompts``: ``words`` (a vocabulary), ``length`` [lo, hi] words and
  ``pool`` (distinct prompts); the negative prompt is empty;
- the driver's own keys (``batch``, ``rate_per_s``, ``coalesce_ms``, ...).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

SEED_RANGE = 2**31 - 1  # per-request seeds fit the program's int32 seed arrays


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one stream of the run's draws; further keys (such as
    a request's index) give each request a stream of its own."""
    return np.random.default_rng([int(seed) & (2**64 - 1), *(int(k) for k in stream)])


def waveforms(spec: Dict, seed: int) -> np.ndarray:
    """[pool, seconds * rate] waveforms: int16 PCM (peak near full scale)
    when ``spec["pcm16"]``, else float32 in [-1, 1]."""
    g = rng(seed, 1)
    n = int(round(spec["seconds"] * spec["rate"]))
    t = np.arange(n, dtype=np.float32) / np.float32(spec["rate"])
    out = np.empty((spec["pool"], n), np.int16 if spec.get("pcm16") else np.float32)
    for i in range(spec["pool"]):
        x = np.zeros(n, np.float32)
        for _ in range(int(g.integers(spec["tones"][0], spec["tones"][1] + 1))):
            f = np.float32(np.exp(g.uniform(np.log(50.0), np.log(8000.0))))
            x += np.float32(g.uniform(0.1, 1.0)) * np.sin(
                np.float32(2 * np.pi) * f * t + np.float32(g.uniform(0, 2 * np.pi)))
        x += np.float32(g.uniform(*spec["noise"])) * g.standard_normal(n, dtype=np.float32)
        env = np.interp(np.arange(n), np.linspace(0, n, 11), g.uniform(0.2, 1.0, 11))
        x *= env.astype(np.float32)
        x /= max(float(np.abs(x).max()), 1e-6)
        out[i] = np.round(x * 32000).astype(np.int16) if spec.get("pcm16") else x * 0.9
    return out


def prompts(spec: Dict, seed: int) -> List[str]:
    g = rng(seed, 2)
    words = spec["words"]
    return [" ".join(g.choice(words, size=int(g.integers(spec["length"][0],
                                                            spec["length"][1] + 1))))
            for _ in range(spec["pool"])]


def request_seeds(seed: int, i: int, per: int) -> np.ndarray:
    """Request ``i``'s ``per`` lane seeds, drawn from a stream of its own:
    any number of requests, each the same in every run of the seed."""
    return rng(seed, 3, i).integers(0, SEED_RANGE, size=per)


def lane_rows(perm: np.ndarray, i: int, per: int) -> np.ndarray:
    """Request ``i``'s ``per`` pool indices: the seeded permutation ``perm``
    of the pool walked in order, so that a request's lanes, and requests
    that arrive close together, never share a row."""
    return perm[(i * per + np.arange(per)) % len(perm)]


def due_times(rate: float, seconds: float, trace_seed: int = 1) -> np.ndarray:
    """An open loop's schedule, seconds from the window's start: exactly
    ``round(rate * seconds)`` arrivals inside the window, from one fixed
    trace (the exponential distribution's quantiles at (k + 1/2) / n, in
    the order that ``trace_seed`` draws, scaled to fill the window). It is
    the same in every run, whatever the run's seed, which draws only what
    each request carries: the tail measures the system, not where a seed
    put the bursts."""
    n = int(round(rate * seconds))
    gaps = -np.log(1.0 - (np.arange(n) + 0.5) / n)
    gaps = np.random.default_rng(trace_seed).permutation(gaps)
    gaps = gaps * (seconds / gaps.sum())
    return np.cumsum(gaps) - gaps[0] * 0.5


def latents(seed: int, count: int, shape) -> np.ndarray:
    """[count, *shape] float32 standard normals: a training pool's latents."""
    return rng(seed, 6).standard_normal((count, *shape), dtype=np.float32)

"""Serving throughput under concurrent load on one card: pipelined dispatch
against micro-batching; the counterpart of the JAX package's
``tools/bench_serving.py``.

    python -m clap2diffusion_tpu_torch.tools.bench_serving [--n 8] [--waves 1]
        [--steps 50] [--window-ms 300] [--max-batch 8]

Drives the port's ``apps/server.py::InferenceService`` (the HTTP handler's
service layer: the same base64 WAV decode, tokenizer, dispatch and PNG
encoding; the socket adds nothing measurable) with ``--n`` client threads,
each sending ``--waves`` requests back to back (a closed loop), first with
one-at-a-time dispatch (``coalesce_ms=0``, pipelined: a request's fetch and
encoding overlap the next one's compute), then through the coalescer
(``--window-ms``, at most ``--max-batch`` a group). Each mode serves one
warm-up round first (one request pipelined, ``--n`` coalesced), whose
images are kept for the repeat check. Both modes share one pipeline
(weights from ``cached_init_params(seed 0)``, bf16).

One JSON line per mode on stdout: img/s, ``service.metrics()["coalesce"]``,
requests asked for and answered, the decoded PNG shapes, the largest
coalesced group, the number of distinct images, and whether every (padded
group size, lane) gave the same bits in the warm-up round and the timed
one (a coalesced lane's conditioning may depend on its batch on the card,
so images are compared across repeats, not against batch 1); then a
``speedup`` line (pipelined wall / coalesced wall).
"""

from __future__ import annotations

import base64
import hashlib
import io
import threading
import time
from typing import List, Tuple

import numpy as np
import torch

from clap2diffusion_tpu_torch.tools import bench_common as B

PROMPT = "thunder rolls over a beach"


def build_request(cfg) -> dict:
    """The JAX tool's request: a float WAV of ``normal * 0.1``
    (``default_rng(0)``) at the CLAP rate, its prompt and seed 0."""
    from clap2diffusion_tpu_torch.utils.audio_io import write_wav

    rng = np.random.default_rng(0)
    wav = (rng.normal(size=(cfg.clap.frontend.num_samples,)) * 0.1).astype(np.float32)
    buf = io.BytesIO()
    write_wav(buf, wav, cfg.clap.frontend.sample_rate)
    return {"audio_b64": base64.b64encode(buf.getvalue()).decode(), "text": PROMPT, "seed": 0}


def run_mode(service, req: dict, n: int, steps: int, waves: int = 1) -> Tuple[float, list]:
    """``n`` concurrent clients each send ``waves`` requests back to back;
    (wall seconds until every response arrived, the responses)."""
    body = dict(req, steps=steps)
    errors: list = []
    out: List[dict] = []
    lock = threading.Lock()

    def client():
        try:
            for _ in range(waves):
                res = service.generate(dict(body))
                with lock:
                    out.append(res)
        except Exception as e:  # raised on the caller's thread below
            errors.append(e)

    threads = [threading.Thread(target=client) for _ in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return wall, out


def _served(responses: list) -> Tuple[list, dict]:
    """(decoded PNG shapes, {(padded group size, lane): {image digests}})."""
    from clap2diffusion_tpu_torch.utils.png import decode_png

    shapes, lanes = set(), {}
    for res in responses:
        img = decode_png(base64.b64decode(res["image_b64"]))
        shapes.add(tuple(img.shape))
        m = res["info"].get("coalesced_batch", 1)
        key = (1 << (m - 1).bit_length(), res["info"].get("coalesced_lane", 0))
        lanes.setdefault(key, set()).add(hashlib.sha256(img.tobytes()).hexdigest())
    return sorted(shapes), lanes


def run(cfg=None, device=None, steps: int = 50, n: int = 8, waves: int = 1,
        window_ms: float = 300.0, max_batch: int = 8,
        cache_dir: str = B.PARAM_CACHE) -> List[dict]:
    """Both modes; prints and returns their lines and the speedup line."""
    from clap2diffusion_tpu_torch.apps.server import InferenceService
    from clap2diffusion_tpu_torch.core.config import Config
    from clap2diffusion_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    cfg = cfg or Config()
    head = {"device": str(dev), **B.card(dev), "dtype": "bfloat16"}
    B.build_kernels(dev)
    pipe, _ = B.bench_pipeline(cfg, dev, torch.bfloat16, cache_dir)
    req = build_request(cfg)
    lines, walls = [], {}
    for mode, ms in (("pipelined", 0.0), ("coalesced", window_ms)):
        service = InferenceService(pipe=pipe, coalesce_ms=ms, coalesce_max_batch=max_batch)
        _, warm = run_mode(service, req, n if ms else 1, steps)
        wall, responses = run_mode(service, req, n, steps, waves)
        walls[mode] = wall
        shapes, lanes = _served(responses)
        _, warm_lanes = _served(warm)
        both = {k: lanes[k] | warm_lanes[k] for k in lanes.keys() & warm_lanes.keys()}
        line = {
            "mode": mode, "n": n, "waves": waves, "steps": steps, "wall_s": wall,
            "img_s": n * waves / wall, "coalesce": service.metrics()["coalesce"],
            "requested": n * waves, "served": len(responses),
            "png_shapes": [list(s) for s in shapes],
            "max_coalesced_batch": max(r["info"].get("coalesced_batch", 1) for r in responses),
            "distinct_images": len(set().union(*lanes.values())),
            "repeat_equal": bool(both) and all(len(s) == 1 for s in both.values()), **head,
        }
        lines.append(line)
        B.emit(line)
    speedup = {"speedup": walls["pipelined"] / walls["coalesced"], **head}
    lines.append(speedup)
    B.emit(speedup)
    return lines


def main(argv=None) -> int:
    ap = B.parser(__doc__)
    ap.add_argument("--n", type=int, default=8, help="concurrent clients")
    ap.add_argument("--waves", type=int, default=1,
                    help="back-to-back requests per client (sustained load)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--window-ms", type=float, default=300.0)
    ap.add_argument("--max-batch", type=int, default=8)
    args = ap.parse_args(argv)
    run(device=args.device, steps=args.steps, n=args.n, waves=args.waves,
        window_ms=args.window_ms, max_batch=args.max_batch)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

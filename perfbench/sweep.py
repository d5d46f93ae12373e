"""The open-loop cell's sweep for the knee, in one process:

    python3 perfbench/sweep.py --workload serve-open --rates 1.5,1.75,2 \
        --seeds 11,12 [--seconds 51]

Runs the cell's own traffic (its fixed trace of arrivals, rate x seconds
of them, rotated by each seed) at each rate and seed, without the output
check, and prints one JSON line per run: the tail, the requests still
open when the window closed, how long the drain took, and the mean
latency of the first and the last third of the arrivals. The knee is the
highest rate at which no run closes its window with a grown backlog (more
requests open, and a longer drain, than the lowest rates leave); the
thirds follow where the rotation puts the trace's bursts, at every rate.
The cell's traffic file fixes its rate at four fifths of the knee.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["USE_FLAX"] = "0"
os.environ["C2D_SILENCE_TOKENIZER_WARNING"] = "1"

from perfbench.harness import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="serve-open")
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--seeds", default="2800000003,2800000004")
    a = ap.parse_args(argv)
    import torch

    from perfbench.harness import check, serve

    check.serving = lambda cfg, seed, jobs, dev: []
    # one pipeline (the first seed's weights), its graphs captured once, serves every run
    build, pipes = serve.build_pipeline, []

    def build_once(*args, **kw):
        if not pipes:
            pipes.append(build(*args, **kw))
            pipes[0].programs.clear = lambda: None
        return pipes[0]

    serve.build_pipeline = build_once
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for rate, seed in ((float(r), int(s)) for r in a.rates.split(",")
                       for s in a.seeds.split(",")):
        cell = common.cell(common.load_benchmark(), a.workload)
        cell["traffic"].update(rate_per_s=rate)
        args = common.parse_args(["--workload", a.workload, "--seed", str(seed),
                                  "--seconds", str(a.seconds), "--trace", "0"])
        res = serve.open_loop(cell, args, device, time.perf_counter(), False)
        ctx = res["ctx"]
        print(json.dumps({"rate_per_s": rate, "seed": seed, "requests": res["attempted"],
                          "failed": res["failed"], "p90_s": res["e2e"]["latency_p90_s"],
                          "p50_s": ctx["latency_p50_s"],
                          "mean_batch": ctx["coalesce_images"] / max(ctx["coalesce_batches"], 1),
                          **ctx["backlog"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

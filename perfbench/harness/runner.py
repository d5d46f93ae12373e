"""One run of one cell, once the device is known: the traffic's driver,
then the per-layer readers (``--trace 1``), the JAX guard and the result
line."""

from __future__ import annotations

import json
import math
import os
import sys
import time
from typing import Dict, Optional

from perfbench.harness import common

PEAKS = os.path.join(common.BENCH, "peaks.json")


def drivers():
    from perfbench.harness import serve, train

    return {"serve_closed": serve.closed, "serve_open": serve.open_loop,
            "train": train.stage2}


def peaks(kind: str) -> Optional[Dict]:
    with open(PEAKS) as f:
        return json.load(f).get(kind)


def work(cell: Dict) -> Dict:
    """The work of one request (serving) or micro-step (training), counted
    by the cell's model family on its reference from the cell's shapes."""
    from perfbench.harness.work import itemsize

    cfg, spec, fam = cell["config"], cell["traffic"], common.family(cell)
    ns = common.namespace(cfg["model"])
    if spec["driver"] == "train":
        return fam.micro_step_work(ns, ns.train.stage2, spec["batch"],
                                   itemsize(ns.train.compute_dtype))
    serve = cfg["serve"]
    return fam.request_work(ns, spec.get("batch", 1), serve["steps"], itemsize(serve["dtype"]))


def per_layer(cell: Dict, res: Dict, device) -> Dict:
    from perfbench.harness.reduce import Trace, chrome_events

    ctx = dict(res["ctx"])
    prof = ctx.pop("prof", None)
    t0 = time.perf_counter()
    ctx["trace"] = (Trace(chrome_events(prof), ctx.get("host_spans", ()), ctx.get("host_t0"))
                    if prof is not None else None)
    common.log(phase="trace_read", seconds=time.perf_counter() - t0)
    ctx["work"] = work(cell)
    ctx["peaks"] = peaks(res["device"]["kind"])
    ctx["device"] = device
    metrics = {}
    for m in cell["per_layer"]:
        value = common.metric_reader(m["name"], cell["root"]).read(ctx)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return metrics, ctx["trace"]


def run_cell(cell: Dict, args, device, t_process: float) -> Optional[Dict]:
    driver = drivers()[cell["traffic"]["driver"]]
    if device.type == "cuda":  # every number of a run beside the card's power limit
        import torch

        common.log(phase="device", kind=torch.cuda.get_device_name(device),
                   power_limit=common.power_limit())
    res = driver(cell, args, device, t_process, bool(args.trace))
    breakdown = None
    dev = dict(res["device"])
    if args.trace:
        metrics, trace = per_layer(cell, res, device)
        if trace is not None:
            dev["busy_s"] = trace.busy_s
            dev["window_s"] = trace.window_s
            breakdown = trace.breakdown()
            common.log(phase="trace", by_category_s=trace.by_category(),
                       busy_s=trace.busy_s, window_s=trace.window_s)
    else:
        metrics = {m["name"]: {"value": float(res["e2e"][m["name"]]), "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    bad = common.forbidden_modules()
    if bad:
        print("modules of JAX or of the JAX package were loaded: " + ", ".join(bad),
              file=sys.stderr)
        return None
    checks = res["checks"]
    correct = all(c["ok"] for c in checks) and res["failed"] == 0
    return common.finish(correct, res["attempted"], res["failed"], metrics, dev, checks,
                         breakdown)

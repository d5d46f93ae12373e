"""What every cell shares: finding a cell's files by name, the run's
arguments, the device's description, the JAX guard and the result line."""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import types
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "perfbench")
# top-level module names that may never be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "clap2diffusion_tpu")
RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, name: str, root: str = ROOT) -> dict:
    """The cell ``name`` with its configuration and traffic files read:
    ``{"workload", "config", "traffic", "end_to_end", "per_layer", "root"}``.
    The traffic mix is ``perfbench/traffic/<traffic>.json``; the
    configuration is the file its entry names."""
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(os.path.join(root, c["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "perfbench", "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in reported and mine(m)]
    return {"workload": w, "config": config, "config_entry": c, "traffic": traffic,
            "end_to_end": e2e, "per_layer": per_layer, "root": root}


def metric_reader(name: str, root: str = ROOT):
    """The reader of per-layer metric ``name``: ``perfbench/metrics/<name>.py``
    under ``root``, loaded by path (the name may hold dots)."""
    path = os.path.join(root, "perfbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def namespace(d):
    """A JSON object as nested attribute access (the reference models read
    their configuration so); lists become tuples."""
    if isinstance(d, dict):
        return types.SimpleNamespace(**{k: namespace(v) for k, v in d.items()})
    if isinstance(d, list):
        return tuple(namespace(v) for v in d)
    return d


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN})


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
        return out[0].rsplit(",", 1)[1].strip() if out else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def device_info(torch, device, count: int = 1) -> Dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}


def log(**kv) -> None:
    print(json.dumps(kv, default=str), file=sys.stderr, flush=True)


def finish(correct: bool, attempted: int, failed: int, metrics: Dict, device: Dict,
           checks: List[Dict], breakdown: Optional[Dict] = None) -> dict:
    """Print each compared number beside its limit as the last lines of
    standard error, then the result line as the last line of standard
    output, its ``checks`` key last."""
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr, flush=True)
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    print(json.dumps(out), flush=True)
    return out

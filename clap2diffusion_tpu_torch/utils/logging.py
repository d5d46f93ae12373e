"""Metric logging to JSONL (port of ``clap2diffusion_tpu/utils/logging.py``,
without the optional wandb sink)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricLogger:
    def __init__(self, log_dir: str, run_name: str = "run"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{run_name}.jsonl")
        self._fh = open(self.path, "a")
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3),
               **{k: float(v) for k, v in metrics.items()}}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

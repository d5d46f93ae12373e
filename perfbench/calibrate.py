"""Readings that the limits of ``correct`` are set from, in one process:

    python3 perfbench/calibrate.py --workload <cell> --seeds 12 --control 3 [--seconds 2]

For each of ``--seeds`` seeds it runs the cell as ``run.py`` does, with a
short window, and keeps the numbers its check compares (the program's
readings, the lower end of each limit). On the first ``--control`` seeds it
also puts the reference in the program's place at the precision below the
configuration's (float8 e4m3 for bf16: ``reference/plain.py``) and reads the
same numbers against the float32 reference (the control's readings, the
upper end). For a training cell it reads the faults that the control does
not stand for: each micro-step on half of its batch (the mean over the
rest), and a state left unchanged (which reads 1 by construction). Prints
one JSON line per reading and a summary line last.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_PROCESS = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["USE_FLAX"] = "0"
os.environ["C2D_SILENCE_TOKENIZER_WARNING"] = "1"

import numpy as np  # noqa: E402

from perfbench.harness import common  # noqa: E402


def serving_control(cell, seed, jobs, device):
    from perfbench.harness import check

    refs = check.reference_images(cell, seed, jobs, device)
    ctrl = check.reference_images(cell, seed, jobs, device, precision="fp8")
    gaps = [check.image_gaps(np.floor(c).astype(np.uint8), r) for c, r in zip(ctrl, refs)]
    return {"image_mae_levels": max(g["mae"] for g in gaps), "gaps": gaps}


def training_control(cell, seed, device):
    from perfbench.harness import train as TR

    spec = cell["traffic"]
    ns = common.namespace(cell["config"]["model"])
    feed = TR.Feed(spec, common.family(cell).latent_shape(ns), seed)
    k = spec["checked_steps"]
    ref = TR.reference_run(cell, seed, feed, k, device)
    ctrl = TR.reference_run(cell, seed, feed, k, device, precision="fp8")

    class Half(TR.Feed):
        def batch(self, i):
            b = feed.batch(i)
            h = feed.b // 2
            return {"audio": b["audio"][:h], "caption": b["caption"][:h],
                    "latent": b["latent"][:h]}

    half = Half.__new__(Half)
    half.__dict__.update(feed.__dict__)
    fault = TR.reference_run(cell, seed, half, k, device)
    return {"control": TR.readings(ctrl, ref), "half_batch": TR.readings(fault, ref)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=2_900_000_001)
    a = ap.parse_args(argv)
    import torch

    from perfbench.harness import check, runner

    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    cell = common.cell(common.load_benchmark(), a.workload)
    program, control, faults = [], [], []
    serving = check.serving
    for j in range(a.seeds):
        seed = a.first_seed + 7919 * j

        def spy(c, s, jobs, dev, j=j, seed=seed):
            out = serving(c, s, jobs, dev)
            if j < a.control:
                r = serving_control(cell, seed, jobs, dev)
                control.append(r["image_mae_levels"])
                print(json.dumps({"seed": seed, "control": r}), flush=True)
            return out

        check.serving = spy
        args = common.parse_args(["--workload", a.workload, "--seed", str(seed),
                                  "--seconds", str(a.seconds), "--trace", "0"])
        t0 = time.perf_counter()
        out = runner.run_cell(cell, args, device, t0)
        program.append({k: v["value"] for k, v in out["checks"].items()})
        print(json.dumps({"seed": seed, "program": program[-1], "correct": out["correct"]}),
              flush=True)
        if cell["traffic"]["driver"] == "train" and j < a.control:
            r = training_control(cell, seed, device)
            control.append(r["control"])
            faults.append(r["half_batch"])
            print(json.dumps({"seed": seed, "control": r["control"],
                              "half_batch": r["half_batch"]}, default=str), flush=True)
    check.serving = serving
    names = list(program[0])
    summary = {"program_max": {n: max(p[n] for p in program) for n in names},
               "program_median": {n: float(np.median([p[n] for p in program])) for n in names}}
    if cell["traffic"]["driver"] == "train":
        summary["control_min"] = {n: min(c[n] for c in control) for n in names}
        summary["half_batch_min"] = {n: min(c[n] for c in faults) for n in names}
    else:
        summary["control_min"] = {"image_mae_levels": min(control)} if control else {}
    print(json.dumps({"summary": summary, "workload": a.workload, "seeds": a.seeds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of BENCHMARK.json once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: its configuration file (the
entry's ``file``), its traffic mix (``traffic/<name>.json``, whose
``driver`` picks the serving or training loop) and, with ``--trace 1``,
one reader per per-layer metric (``metrics/<name>.py``). With ``--trace 0``
the line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, from a shorter traced window, and the trace's
``breakdown``. Every run checks its answers against the plain reference
and prints each compared number beside its limit.

It needs as many CUDA devices as the cell asks for, and exits with an
error, printing no result, without them, or when a module of JAX or of the
JAX package was loaded.
"""

from __future__ import annotations

import os
import sys
import time

T_PROCESS = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# fixed cache directories inside the checkout, and no Flax behind transformers
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
os.environ["USE_FLAX"] = "0"
os.environ["C2D_SILENCE_TOKENIZER_WARNING"] = "1"
for flag in ("C2D_INT8", "C2D_INT8_CONV", "C2D_FUSED_QKV", "C2D_INT8_WIRE",
             "C2D_PACKED_FLASH", "C2D_WINOGRAD"):
    os.environ.pop(flag, None)  # the configurations run the default path

from perfbench.harness import common  # noqa: E402
from perfbench.harness.runner import run_cell  # noqa: E402


def main() -> int:
    args = common.parse_args()
    bench = common.load_benchmark()
    cell = common.cell(bench, args.workload)
    import torch

    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args, torch.device("cuda"), T_PROCESS)
    return 0 if out is not None else 3


if __name__ == "__main__":
    sys.exit(main())

"""The multi-process runtime (port of
``clap2diffusion_tpu/parallel/distributed.py``).

The JAX package runs one process per host and a GSPMD mesh over all the
chips. PyTorch runs one process per card: ``initialize_distributed`` joins
this process to the job's process group over TCP (NCCL for CUDA, Gloo for
the CPU) and makes ``cuda:<local rank>`` its device. Launch one process
per card with the same command:

    C2D_COORDINATOR=10.0.0.1:8476 C2D_NUM_PROCESSES=8 C2D_PROCESS_ID=$RANK \\
        python -m clap2diffusion_tpu_torch.apps.main train --stage 2 ...

(or ``train --coordinator 10.0.0.1:8476 --num-processes 8 --process-id
$RANK``). ``C2D_AUTO_DIST=1`` reads torchrun's variables instead
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``: ``init_method="env://"``). With none of them set the call
is a no-op (one process), and a second call is a no-op too. The local rank
is ``LOCAL_RANK`` where torchrun sets it, else the process id modulo the
node's card count.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from clap2diffusion_tpu_torch.core.mesh import world

_INITIALIZED = False


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device=None) -> bool:
    """Join the job's process group; True when there is more than one
    process. Arguments fall back to ``C2D_COORDINATOR`` /
    ``C2D_NUM_PROCESSES`` / ``C2D_PROCESS_ID``; ``C2D_AUTO_DIST=1`` reads
    torchrun's variables. ``device`` (CUDA unless ``"cpu"``) picks the
    backend: NCCL for CUDA, Gloo for the CPU. Call it before anything
    touches the card: it sets this rank's CUDA device."""
    global _INITIALIZED
    if _INITIALIZED or (dist.is_available() and dist.is_initialized()):
        _INITIALIZED = True
        return world()[0] > 1
    coordinator = coordinator or os.environ.get("C2D_COORDINATOR")
    env_n, env_i = os.environ.get("C2D_NUM_PROCESSES"), os.environ.get("C2D_PROCESS_ID")
    num_processes = num_processes if num_processes is not None else (
        int(env_n) if env_n else None)
    process_id = process_id if process_id is not None else (int(env_i) if env_i else None)
    auto = coordinator is None and num_processes is None
    if auto and os.environ.get("C2D_AUTO_DIST") != "1":
        return False  # one process: the runtime is never touched
    cuda = torch.device("cuda" if device is None else device).type == "cuda"
    if auto:
        init_method, num_processes = "env://", int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    else:
        if coordinator is None or num_processes is None or process_id is None:
            raise ValueError("a multi-process launch needs the coordinator address, the "
                             "number of processes and this process's id")
        init_method = f"tcp://{coordinator}"
    if cuda:
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else process_id % torch.cuda.device_count())
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init_method, world_size=num_processes,
                            rank=process_id)
    _INITIALIZED = True
    return num_processes > 1


def is_coordinator() -> bool:
    """True on the process that logs, emits metrics and writes files."""
    return world()[1] == 0


def process_count() -> int:
    return world()[0]


def shard_host_batch(mesh, batch: Dict, axis: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """Place this process's slice of a global batch on its device. Each
    data rank feeds only its own slice (dimension ``axis`` is the global
    batch over the data axis's size); the model ranks of one data index
    feed the same slice. Host arrays become tensors on ``device`` (CUDA
    unless ``"cpu"``); the slices' sizes must agree across the data axis."""
    from clap2diffusion_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    out = {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in batch.items()}
    g = mesh.group("data")
    if g is not None:
        sizes = torch.tensor([t.shape[axis] for t in out.values()], dtype=torch.int64,
                             device=_collective_device(g, dev))
        top = sizes.clone()
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=g)
        if not torch.equal(sizes, top):
            raise ValueError(f"data rank {mesh.coord('data')}: local batch sizes "
                             f"{sizes.tolist()} differ from another rank's {top.tolist()}")
    return out


def _collective_device(group, device: torch.device) -> torch.device:
    """Where a collective's tensors live: the CPU for Gloo, else ``device``."""
    return torch.device("cpu") if dist.get_backend(group) == "gloo" else device

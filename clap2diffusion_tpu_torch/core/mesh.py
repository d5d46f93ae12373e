"""The device mesh (port of ``clap2diffusion_tpu/core/mesh.py``).

The JAX package runs one process per host and a GSPMD ``Mesh`` over every
chip. PyTorch runs one process per card, so here a mesh is a grid of
ranks with named axes, ``("data", "model")`` for training: rank
``d * model + m`` is data index ``d`` and model index ``m``, the JAX
package's row-major device layout. Each axis has one process group per
line of the grid (``torch.distributed.new_group``; every rank creates every
group, in the same order), which the collectives of ``parallel/`` run on.
An axis of size 1 has no group: its collectives are the identity. Without
a process group the mesh is one rank.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch.distributed as dist


@dataclass
class Mesh:
    """Named axes (``shape``, in order), this process's rank and its index
    and process group on each axis."""

    shape: Dict[str, int]
    rank: int = 0
    index: Dict[str, int] = field(default_factory=dict)
    groups: Dict[str, Optional[dist.ProcessGroup]] = field(default_factory=dict)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.index.get(axis, 0)

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.groups.get(axis)

    @property
    def devices(self) -> int:
        return int(np.prod(list(self.shape.values()))) if self.shape else 1


def world() -> tuple:
    """(world size, rank): (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(shape: Optional[Dict[str, int]] = None) -> Mesh:
    """A named mesh over all of the job's ranks. ``-1`` in ``shape`` means
    every remaining rank; the default is a 1-D ``data`` mesh. The mesh
    covers every rank, since a rank outside it could not take part in its
    collectives."""
    n, rank = world()
    shape = dict(shape or {"data": -1})
    names, sizes = list(shape), list(shape.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1])) or 1
        sizes[sizes.index(-1)] = max(1, n // known)
    total = int(np.prod(sizes))
    if total != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} processes, have {n}")
    shape = dict(zip(names, sizes))
    strides = [int(np.prod(sizes[i + 1:])) for i in range(len(sizes))]
    index = {a: (rank // st) % sz for a, sz, st in zip(names, sizes, strides)}
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    for ax, (a, sz) in enumerate(zip(names, sizes)):
        groups[a] = None
        if sz == 1 or n == 1:
            continue
        others = [range(s) for i, s in enumerate(sizes) if i != ax]
        for rest in itertools.product(*others):  # one group per line along axis a
            ranks = []
            for k in range(sz):
                coords = list(rest)
                coords.insert(ax, k)
                ranks.append(sum(c * st for c, st in zip(coords, strides)))
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[a] = g
    return Mesh(shape=shape, rank=rank, index=index, groups=groups)

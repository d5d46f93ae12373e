"""Data and tensor parallelism over ``torch.distributed`` (port of
``clap2diffusion_tpu/parallel/sharding.py``).

The JAX package places a ``(data, model)`` mesh's shardings and lets GSPMD
insert the collectives. Here they are explicit, on plain tensors (the
kernels' ``autograd.Function``\\ s take plain tensors, so there is no
DTensor):

- **data**: each data rank takes its slice of the global batch
  (``shard_batch``); a training step's gradients are averaged over the
  data axis (``make_sharded_step``), which is the JAX loss's mean over the
  global batch. A rank's random draws are its rows of the draws for the
  global batch (``models/layers.py::DataSlice``), so a step gives the
  numbers of one process on the whole batch.
- **model**: the wide Dense layers (``param_spec``: a kernel whose last
  axis *in the JAX layout* is at least ``TP_MIN_WIDTH`` wide and even; for
  an ``nn.Linear`` that is its output features, torch's dim 0) are
  column-parallel (``ColumnParallelLinear``): each model rank holds its
  rows of the weight and of its bias, the forward all-gathers the output
  columns over the model group, and the backward all-reduces the input's
  gradient over it, as Megatron's column-parallel linear with a gathered
  output does. Everything after the gather is replicated over the group,
  so the other leaves' gradients agree there. AdamW and the EMA are
  elementwise and update the shards in place; the global-norm clip sums
  the sharded leaves' squares over the model group (``train/optim.py``).

A single-rank axis is the identity throughout.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch
import torch.distributed as dist
from torch import nn

from clap2diffusion_tpu_torch.core.mesh import Mesh, make_mesh, world

# Dense kernels at least this wide on their (JAX-layout) last axis are model-sharded.
TP_MIN_WIDTH = 2048


def make_train_mesh(n_devices: Optional[int] = None, model_parallel: int = 1) -> Mesh:
    """The ``(data, model)`` mesh over the job's ranks (``n_devices``, when
    given, must be their number)."""
    n = world()[0]
    if n_devices not in (None, n):
        raise ValueError(f"a mesh of {n_devices} devices in a job of {n} processes")
    return make_mesh({"data": max(1, n // model_parallel), "model": model_parallel})


def param_spec(module: nn.Module, leaf: str) -> Optional[int]:
    """The dimension of ``module``'s parameter ``leaf`` to shard over the
    model axis, or None (replicated). The JAX rule shards a kernel's last
    axis when it is at least ``TP_MIN_WIDTH`` wide and even; biases and
    norms replicate. The last axis of a Flax Dense or Conv kernel is its
    output, which is dim 0 of the torch ``nn.Linear`` / ``nn.Conv2d``
    weight; an embedding table keeps Flax's layout."""
    t = getattr(module, leaf)
    if t is None or t.dim() < 2:
        return None
    dim = 0 if isinstance(module, (nn.Linear, nn.Conv2d)) else t.dim() - 1
    width = t.shape[dim]
    return dim if width >= TP_MIN_WIDTH and width % 2 == 0 else None


def sharded_leaves(module: nn.Module) -> Dict[str, int]:
    """Every parameter of ``module`` that ``param_spec`` shards: name ->
    dimension."""
    out = {}
    for mname, m in module.named_modules():
        for leaf, _ in m.named_parameters(recurse=False):
            dim = param_spec(m, leaf)
            if dim is not None:
                out[f"{mname}.{leaf}" if mname else leaf] = dim
    return out


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over the
    model group (each rank holds its columns' share of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherColumns(torch.autograd.Function):
    """All-gather the last dimension over the model group; the backward
    keeps this rank's columns of the gradient."""

    @staticmethod
    def forward(ctx, y, group, index, count):
        ctx.index, ctx.width = index, y.shape[-1]
        dev = y.device
        if dist.get_backend(group) == "gloo":  # Gloo gathers CPU tensors only
            y = y.cpu()
        parts = [torch.empty_like(y) for _ in range(count)]
        dist.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts, dim=-1).to(dev)

    @staticmethod
    def backward(ctx, g):
        w = ctx.width
        return g[..., ctx.index * w:(ctx.index + 1) * w].contiguous(), None, None, None


class ColumnParallelLinear(nn.Module):
    """An ``nn.Linear`` whose output features are split over the model
    group: ``weight`` [out / M, in] and ``bias`` [out / M] are this rank's
    rows; the output is gathered to [..., out] on every rank."""

    def __init__(self, linear: nn.Linear, mesh: Mesh):
        super().__init__()
        self.group, self.index, self.count = (mesh.group("model"), mesh.coord("model"),
                                              mesh.size("model"))
        rows = linear.out_features // self.count
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self.weight = nn.Parameter(linear.weight.new_empty(rows, linear.in_features),
                                   requires_grad=linear.weight.requires_grad)
        self.bias = None if linear.bias is None else nn.Parameter(
            linear.bias.new_empty(rows), requires_grad=linear.bias.requires_grad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = nn.functional.linear(_CopyToModel.apply(x, self.group), self.weight, self.bias)
        return _GatherColumns.apply(y, self.group, self.index, self.count)


def local_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This model rank's rows (dim 0) of a tensor of a sharded layer."""
    rows = t.shape[0] // mesh.size("model")
    i = mesh.coord("model")
    return t[i * rows:(i + 1) * rows]


def shard_params(module: nn.Module, params: Dict[str, torch.Tensor],
                 mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Make ``module`` model-parallel on ``mesh`` and return ``params`` (its
    state dict) with this rank's slices: each ``nn.Linear`` that
    ``param_spec`` shards becomes a ``ColumnParallelLinear`` (in place, on
    whatever device the module is, meta included), and its weight and bias
    in ``params`` become this rank's rows (copies). The identity on a mesh
    without a model axis. Only Dense layers are sharded: a wide convolution
    or embedding raises, as none of the package's models has one."""
    if mesh.size("model") == 1:
        return params
    out = dict(params)
    for name, dim in sharded_leaves(module).items():
        mname = name.rsplit(".", 1)[0]
        parent_name, _, child = mname.rpartition(".")
        parent = module.get_submodule(parent_name)
        layer = getattr(parent, child) if not child.isdigit() else parent[int(child)]
        if not isinstance(layer, nn.Linear) or dim != 0:
            raise NotImplementedError(f"{name}: model parallelism is implemented for "
                                      f"nn.Linear only, not {type(layer).__name__}")
        if layer.out_features % mesh.size("model"):
            raise ValueError(f"{name}: {layer.out_features} output features over "
                             f"{mesh.size('model')} model ranks")
        cpl = ColumnParallelLinear(layer, mesh)
        if child.isdigit():
            parent[int(child)] = cpl
        else:
            setattr(parent, child, cpl)
        for leaf in ("weight", "bias"):
            key = f"{mname}.{leaf}"
            if key in out:
                out[key] = local_rows(out[key].detach(), mesh).clone()
    return out


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole tensor of a model-sharded leaf from every rank's rows."""
    g = mesh.group("model")
    dev = t.device
    x = t.detach().cpu() if dist.get_backend(g) == "gloo" else t.detach()
    parts = [torch.empty_like(x) for _ in range(mesh.size("model"))]
    dist.all_gather(parts, x.contiguous(), group=g)
    return torch.cat(parts, dim=0).to(dev)


def batch_spec(mesh: Mesh, n: int) -> slice:
    """This data rank's rows of a global batch of ``n``."""
    d = mesh.size("data")
    if n % d:
        raise ValueError(f"global batch {n} is not divisible by the data axis {d}")
    b = n // d
    return slice(mesh.coord("data") * b, (mesh.coord("data") + 1) * b)


def shard_batch(batch, mesh: Mesh):
    """This data rank's slice of every array or tensor of a global batch
    (leading dimension); the model ranks of one data index take the same."""
    return {k: v[batch_spec(mesh, len(v))] for k, v in batch.items()}


def replicate(tree: Dict, mesh: Mesh) -> Dict:
    """Every tensor of ``tree`` (nested dicts) made equal to rank 0's, in
    place (a broadcast over the job); the identity in one process."""
    if world()[0] == 1:
        return tree
    for v in tree.values():
        if isinstance(v, dict):
            replicate(v, mesh)
        else:
            with torch.no_grad():
                dist.broadcast(v, src=0)
    return tree


def all_mean(tensors: Iterable[torch.Tensor], group) -> None:
    """In place: each tensor averaged over ``group`` (one flat all-reduce, on
    the card when any of them is there); nothing without a group."""
    tensors = list(tensors)
    if group is None or not tensors:
        return
    n = dist.get_world_size(group)
    dev = next((t.device for t in tensors if t.is_cuda), tensors[0].device)
    flat = torch.cat([t.reshape(-1).float().to(dev) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= n
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def make_sharded_step(step_fn: Callable, mesh: Mesh) -> Callable:
    """``step_fn(stage, state, batch, generator, mesh=...)`` bound to
    ``mesh``: the step averages its gradients and metrics over the data
    axis (``train/stages.py::train_step``)."""
    def step(stage, state, batch, generator):
        return step_fn(stage, state, batch, generator, mesh=mesh)
    return step

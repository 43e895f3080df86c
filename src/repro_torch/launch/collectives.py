"""Collectives across ranks, counted by kind and result bytes.

The port's counterpart of ``repro/launch/hlo.py``, whose one job is to
sum the collective traffic of a compiled step by kind. The port has no
compiled program to parse: its collectives are called one by one, so
each one is counted where it is called. Every collective of the port
goes through this module. The kinds are ``hlo.COLLECTIVES``'s names, and
a collective counts its RESULT bytes as ``hlo.py`` does: the whole
gathered tensor of an all-gather, the reduced tile of an all-reduce, the
one shard each rank keeps of a reduce-scatter. The counts are this
rank's; each process keeps its own.

A collective over an axis of one rank moves nothing: it hands its input
back and counts nothing. With no mesh nothing is called, so nothing is
counted.

The differentiable forms carry the transpose that the meaning of their
operands asks for:

* ``gather_replicated``: an all-gather whose consumers are replicated
  along the axis (every rank there computes the same loss, counted
  once); its gradient is this rank's slice, not a sum.
* ``gather_zero``: the all-gather of a ZeRO shard, used by ranks whose
  losses differ and are summed into the global loss; its gradient is the
  reduce-scatter (the sum) of theirs.
* ``take_slice``: this rank's slice of a tensor replicated along the
  axis; its gradient is the all-gather of the slices' gradients, so that
  what lies below it receives the whole gradient on every rank.

Only list-form ``all_gather``, list-form ``reduce_scatter`` and
``all_reduce`` are called. gloo takes the first and the last on CUDA
tensors too (staged through host memory), NCCL takes all three.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_bytes: Dict[str, int] = defaultdict(int)
_calls: Dict[str, int] = defaultdict(int)


def reset() -> None:
    """Set every count to 0."""
    _bytes.clear()
    _calls.clear()


def collective_bytes() -> Dict[str, int]:
    """Result bytes per kind since the last ``reset`` (the shape of
    ``hlo.collective_bytes``: only the kinds called appear)."""
    return dict(_bytes)


def collective_calls() -> Dict[str, int]:
    """Collectives called per kind since the last ``reset``."""
    return dict(_calls)


def _record(kind: str, result: torch.Tensor) -> None:
    _bytes[kind] += result.numel() * result.element_size()
    _calls[kind] += 1


def _size(mesh, axis: str) -> int:
    return mesh.axis_sizes[axis]


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' ``x`` along ``axis`` concatenated on ``dim``, in the
    order of their coordinates."""
    import torch.distributed as dist
    n = _size(mesh, axis)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=mesh.group(axis))
    out = torch.cat(parts, dim)
    _record("all-gather", out)
    return out


def reduce_scatter(x: torch.Tensor, mesh, axis: str,
                   dim: int) -> torch.Tensor:
    """The sum of the ranks' ``x`` along ``axis``, of which this rank
    keeps the chunk on ``dim`` at its coordinate."""
    import torch.distributed as dist
    n = _size(mesh, axis)
    if n == 1:
        return x
    chunks = [c.contiguous() for c in x.chunk(n, dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=mesh.group(axis))
    _record("reduce-scatter", out)
    return out


def all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of the ranks' ``x`` along ``axis`` (a new tensor)."""
    import torch.distributed as dist
    if _size(mesh, axis) == 1:
        return x
    out = x.clone()
    dist.all_reduce(out, group=mesh.group(axis))
    _record("all-reduce", out)
    return out


def _own(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = _size(mesh, axis)
    step = x.shape[dim] // n
    return x.narrow(dim, mesh.coordinate(axis) * step, step)


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _own(g, *ctx.args).contiguous(), None, None, None


class _GatherZero(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, *ctx.args), None, None, None


class _TakeSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _own(x, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, *ctx.args), None, None, None


def gather_replicated(x, mesh, axis: str, dim: int) -> torch.Tensor:
    if _size(mesh, axis) == 1:
        return x
    return _GatherReplicated.apply(x, mesh, axis, dim)


def gather_zero(x, mesh, axis: str, dim: int) -> torch.Tensor:
    if _size(mesh, axis) == 1:
        return x
    return _GatherZero.apply(x, mesh, axis, dim)


def take_slice(x, mesh, axis: str, dim: int) -> torch.Tensor:
    if _size(mesh, axis) == 1:
        return x
    return _TakeSlice.apply(x, mesh, axis, dim)

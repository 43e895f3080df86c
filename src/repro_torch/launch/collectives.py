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
counted. On the ``meta`` device a collective communicates nothing: it
counts its kind and result bytes as a rank would and returns a ``meta``
result of the right shape (the dry-run's collective term, run on one
rank's block under a ``launch/mesh.py`` ``CountingMesh``).

The differentiable forms carry the transpose that the meaning of their
operands asks for. The convention: a tensor replicated along an axis
carries its whole gradient on every rank there (every rank computes the
same loss from it, counted once); a tensor cut along it carries, on each
rank, the gradient of its block.

* ``gather_replicated``: an all-gather whose consumers are replicated
  along the axis; its gradient is this rank's slice, not a sum.
* ``gather_zero``: an all-gather whose consumers differ from rank to
  rank (a ZeRO shard, or K/V columns read by each rank's own q heads),
  so that each rank's gradient is a partial sum; its gradient is the
  reduce-scatter (the sum) of theirs.
* ``take_slice``: this rank's slice of a tensor replicated along the
  axis; its gradient is the all-gather of the slices' gradients, so that
  what lies below it receives the whole gradient on every rank.
* ``tp_enter`` (Megatron's "f"): a replicated tensor entering products
  with this rank's cut weights; identity in the forward, the all-reduce
  of the ranks' partial gradients in the backward.
* ``tp_all_reduce``: the sum of the ranks' partial results, whose
  consumers are replicated; its gradient passes through.

``serving_only`` runs a collective of the sequence-cut decode combine
(``models/layers.py``), which no gradient may pass: it raises
``NotImplementedError`` when one reaches it.

Only list-form ``all_gather``, list-form ``reduce_scatter`` and
``all_reduce`` are called. NCCL takes all three, and so does gloo, on
CUDA tensors too (staged through host memory; its reduce-scatter on CUDA
tensors was checked on an H100 with torch 2.11).

``all_reduce`` also takes a tuple of axes (the batch axes of the data-
parallel reduction, "pod" and "data"); the others one axis each.
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


def _axes(mesh, axis) -> tuple:
    """The mesh axes ``axis`` names (one name or a tuple of names) that
    hold more than one rank."""
    names = axis if isinstance(axis, tuple) else (axis,)
    return tuple(a for a in names if mesh.axis_sizes[a] > 1)


def _size(mesh, axis) -> int:
    n = 1
    for a in _axes(mesh, axis):
        n *= mesh.axis_sizes[a]
    return n


def _group(mesh, axis):
    axes = _axes(mesh, axis)
    return mesh.group(axes[0] if len(axes) == 1 else axes)


def _meta(x: torch.Tensor) -> bool:
    return x.device.type == "meta"


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' ``x`` along ``axis`` concatenated on ``dim``, in the
    order of their coordinates."""
    import torch.distributed as dist
    n = _size(mesh, axis)
    if n == 1:
        return x
    if _meta(x):
        out = torch.cat([x] * n, dim)
    else:
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
    if not _meta(x):
        dist.reduce_scatter(out, chunks, group=mesh.group(axis))
    _record("reduce-scatter", out)
    return out


def all_reduce(x: torch.Tensor, mesh, axis,
               op: str = "sum") -> torch.Tensor:
    """The sum (``op`` "sum") or the maximum ("max") of the ranks' ``x``
    along ``axis`` (a name, or a tuple of names: the ranks that differ
    from this one only along those axes), a new tensor."""
    import torch.distributed as dist
    if _size(mesh, axis) == 1:
        return x
    # NCCL takes only contiguous tensors (an einsum's output may be a
    # permuted view, and ``clone`` keeps its strides)
    out = x.clone(memory_format=torch.contiguous_format)
    if not _meta(x):
        dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                                 "max": dist.ReduceOp.MAX}[op],
                        group=_group(mesh, axis))
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


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, *ctx.args), None, None


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


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


def tp_enter(x, mesh, axis: str) -> torch.Tensor:
    """``x`` (replicated along ``axis``) as the input of products with
    this rank's cut weights: itself, whose gradient is the sum over the
    ranks of theirs."""
    if _size(mesh, axis) == 1:
        return x
    return _Enter.apply(x, mesh, axis)


def tp_all_reduce(x, mesh, axis) -> torch.Tensor:
    """The sum over the ranks along ``axis`` (a name or a tuple) of their
    ``x``, a result every rank there consumes alike: its gradient passes
    through to each rank's ``x``."""
    if _size(mesh, axis) == 1:
        return x
    return _SumReplicated.apply(x, mesh, axis)


class _Inference(torch.autograd.Function):
    """A collective of the sequence-cut decode combine, which no gradient
    may pass."""

    @staticmethod
    def forward(ctx, x, fn, args):
        return fn(x, *args)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "a gradient through the sequence-cut decode combine: it serves "
            "decode steps only (a train step has no cache to cut)")


def serving_only(fn, x, *args) -> torch.Tensor:
    """``fn(x, *args)`` (a collective of this module) for the sequence-cut
    decode combine: a gradient that reaches it raises."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Inference.apply(x, fn, args)
    return fn(x, *args)

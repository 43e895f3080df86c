"""Logical-axis partitioning (MaxText-style, lightweight).

Same rules as ``repro/models/partitioning.py``. Model code names tensor
dims with *logical* axes ('batch', 'embed', 'q', 'ff', 'expert', ...).
A ``ShardingRules`` maps logical names to mesh axes. Outside a rules
context everything is a no-op, so the same model code runs on one
device and under the dry-run's production meshes.

A partition spec is a ``PartitionSpec``: a tuple with one entry per
tensor dim, each None, a mesh-axis name or a tuple of names, normalised
as ``jax.sharding.PartitionSpec`` normalises its entries (a one-name
tuple becomes the name, an empty one None). ``placement`` is the one
rule of where a tensor lies: the rules' entry of each dim, dropped where
its mesh axes do not divide the dim (the dry-run's ``sanitize``).

``shard`` hands the placement it computes to ``_constrain``, which stays
an annotation: it returns the tensor as it is, in one process and on a
rank alike. Across ranks the placement is carried out where it changes
what a rank computes, at the shard points of the attention, MLP, MoE
and SSM blocks, by ``TensorParallel`` (``tensor_parallel()`` gives this
rank's, under the
baseline rules with a rank mesh in ``rules.mesh``): a rank holds each
leaf cut as its placement says, and the blocks call its helpers to
gather columns that the activation wants whole, to all-reduce a
contraction over cut rows, to look up embedding rows cut over 'vocab',
and to let a replicated input into products with cut weights
(``enter``); each carries its transpose, so that a train step's
gradients are right on every rank (``launch/collectives.py`` issues and
counts the collectives). ``data_ranks`` names the ranks over which the
batch is split: a train step's loss and gradients are summed over them.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.launch import collectives

MeshAxes = Union[None, str, Tuple[str, ...]]


def _canonical(entry) -> MeshAxes:
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if not entry:
            return None
        return entry[0] if len(entry) == 1 else entry
    return entry


class PartitionSpec(tuple):
    """Mesh axes of each dim of a tensor (``jax.sharding.PartitionSpec``'s
    counterpart): a tuple of normalised entries, and a leaf of the
    parameter and cache trees (``params.map_tree`` does not descend into
    it)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canonical(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class ShardingRules:
    """logical axis -> mesh axis (or tuple of mesh axes)."""

    rules: Dict[str, MeshAxes] = field(default_factory=dict)
    axis_sizes: Dict[str, int] = field(default_factory=dict)
    # the mesh of ranks (launch/mesh.py: a ProcessMesh, or a CountingMesh
    # on the meta device) — set only to run across ranks: the explicit
    # expert-parallel branch (models/moe.py) or tensor parallelism
    # (``tensor_parallel``); None elsewhere
    mesh: object = None

    def spec(self, axes: Tuple[Optional[str], ...]) -> PartitionSpec:
        return P(*(self.rules.get(a) if a is not None else None
                   for a in axes))

    def size(self, logical: str) -> int:
        """Number of shards the mapping of `logical` implies (1 if unknown)."""
        m = self.rules.get(logical)
        if m is None:
            return 1
        axes = m if isinstance(m, tuple) else (m,)
        n = 1
        for a in axes:
            n *= self.axis_sizes.get(a, 1)
        return n


# Baseline (paper-faithful megatron-style TP + DP) rule sets -----------------

def tp_rules(*, multi_pod: bool = False, expert_parallel: bool = False,
             decode_kv: str = "heads", fsdp: bool = False,
             axis_sizes: Optional[Dict[str, int]] = None,
             mesh=None) -> ShardingRules:
    """Sharding rules over the production mesh.

    Baseline (paper-faithful analogue): megatron-style TP over 'model',
    data parallel over 'data' (x 'pod').

    expert_parallel: shard the expert axis over 'model' (all-to-all MoE)
      instead of sharding every expert's d_ff (megatron MoE-TP).
    decode_kv: 'heads' shards the decode KV cache over kv-heads (classic
      TP), 'seq' shards it over sequence (flash-decode style).
    fsdp: training mode — batch over BOTH mesh axes (pure data
      parallel), weights/optimizer ZeRO-3 sharded over ('data' x
      'model') via their two named dims.

    Weight dims and activation dims use distinct logical names
    ('embed' vs 'act_embed', ...) so FSDP can shard parameters along
    dims whose activation counterparts stay replicated.
    """
    batch = ("pod", "data") if multi_pod else ("data",)
    if fsdp:
        # Dense FSDP: batch over BOTH axes (pure DP, global_batch=256 ==
        #   data x model), weights ZeRO-3 sharded 256-way via two dims.
        # MoE hybrid (fsdp+expert_parallel): batch over 'data' only so the
        #   'model' axis can carry the EXPERT dim. Weights still ZeRO-3
        #   over 'data'. Under multi-pod the pod axis replicates.
        batch = ("data",) if expert_parallel else ("data", "model")
        rules: Dict[str, MeshAxes] = {
            "batch": batch,
            "seq": None,
            # weights: ZeRO-3 sharded over both axes via two dims
            "embed": "data",
            "vocab": "model",
            "q": "model",
            "kv": "model",
            "heads": None,
            # expert-parallel: the expert dim takes 'model'; the per-expert
            # d_ff stays whole (gathered per use like other ZeRO weights)
            "ff": None if expert_parallel else "model",
            "expert": "model" if expert_parallel else None,
            "inner": "model",
            "state": None,
            "layers": None,
            # activations: replicated along feature dims (pure DP), except
            # the expert dim in the MoE hybrid (drives the all-to-all)
            "act_embed": None,
            "act_ff": None,
            "act_inner": None,
            "act_vocab": None,
            "act_heads": None,
            "act_kv_heads": None,
            "act_expert": "model" if expert_parallel else None,
            "kv_seq": None,
            "kv_heads": None,
        }
        return ShardingRules(rules, axis_sizes or {}, mesh)
    rules = {
        "batch": batch,
        "seq": None,
        "embed": None,
        "vocab": "model",
        "q": "model",            # q_dim = n_heads * head_dim
        "kv": "model",           # kv_dim = n_kv_heads * head_dim
        "heads": "model",
        "ff": None if expert_parallel else "model",
        "expert": "model" if expert_parallel else None,
        "inner": "model",        # ssm inner dim
        "state": None,
        "layers": None,
        "act_embed": None,
        "act_ff": None if expert_parallel else "model",
        "act_inner": "model",
        "act_vocab": "model",
        "act_heads": "model",
        "act_kv_heads": "model",
        "act_expert": "model" if expert_parallel else None,
        "kv_seq": "model" if decode_kv == "seq" else None,
        "kv_heads": "model" if decode_kv == "heads" else None,
    }
    return ShardingRules(rules, axis_sizes or {}, mesh)


_tls = threading.local()


def current_rules() -> Optional[ShardingRules]:
    return getattr(_tls, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev = current_rules()
    _tls.rules = rules
    try:
        yield
    finally:
        _tls.rules = prev


def _constrain(x, spec: PartitionSpec):
    """The annotation of ``x``'s placement: ``x`` comes back as it is. In
    one process every tensor is whole; across ranks the dense path's
    blocks carry out their placements through ``TensorParallel``."""
    return x


def placement(rules: ShardingRules, axes: Tuple[Optional[str], ...],
              shape) -> PartitionSpec:
    """The mesh axes of each dim of a tensor of ``shape`` named ``axes``:
    the rules' entry, dropped where the product of its mesh-axis sizes
    does not divide the dim (forcing e.g. 8 whisper heads onto a 16-way
    model axis would replicate the whole tensor). The dry-run's
    ``sanitize`` rule, for activations and leaves alike."""
    entries = []
    for dim, a in zip(shape, axes):
        m = rules.rules.get(a) if a is not None else None
        if m is None:
            entries.append(None)
            continue
        n = rules.size(a)
        entries.append(m if n <= 1 or dim % n == 0 else None)
    return P(*entries)


def shard(x, *axes: Optional[str]):
    """Constrain ``x`` to the sharding implied by logical ``axes``.

    No-op when no rules are active (``x`` itself comes back); else the
    placement (a dim the mapped mesh axes do not divide stays whole) goes
    to ``_constrain``.
    """
    rules = current_rules()
    if rules is None:
        return x
    return _constrain(x, placement(rules, axes, x.shape))


def mesh_axes(entry) -> Tuple[str, ...]:
    """The mesh-axis names of one entry of a spec."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def block_index(shape, entries, sizes: Dict[str, int],
                coords: Dict[str, int]) -> Tuple[slice, ...]:
    """The slices of a tensor of ``shape`` that the rank at ``coords``
    holds when dim i is cut over the mesh axes of ``entries[i]`` (row-
    major over several axes); a dim those axes do not divide stays
    whole."""
    idx = []
    for dim, entry in zip(shape, tuple(entries) + (None,) * len(shape)):
        axes = mesh_axes(entry)
        n = math.prod(sizes[a] for a in axes)
        if n == 1 or dim % n:
            idx.append(slice(None))
            continue
        pos = 0
        for a in axes:
            pos = pos * sizes[a] + coords[a]
        step = dim // n
        idx.append(slice(pos * step, (pos + 1) * step))
    return tuple(idx)


def kv_heads_cut(rules: Optional[ShardingRules], n_kv_heads: int) -> bool:
    """Whether the KV caches are cut over their heads (classic TP): the
    'kv_heads' mapping splits more than one way and divides the kv heads.
    Else a dense cache is cut over its sequence on the same mesh axis
    (flash-decode style) and a paged pool stays whole."""
    return (rules is not None and rules.size("kv_heads") > 1
            and n_kv_heads % rules.size("kv_heads") == 0)


# ---------------------------------------------------------------------------
# Tensor parallelism across ranks (the baseline rules over a rank mesh)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TensorParallel:
    """This rank's share of the baseline rules' tensor-parallel axis:
    ``ways`` ranks along mesh axis ``axis`` (what 'q', 'kv', 'ff' and
    'vocab' map to), this one at ``coord``. A leaf or activation dim is
    cut when its logical axis maps to ``axis`` and ``ways`` divides it
    (``placement``'s rule); a rank holds block ``coord`` of a cut dim."""

    rules: ShardingRules
    mesh: Any
    axis: str
    ways: int
    coord: int

    def cut(self, logical: str, dim: int) -> bool:
        return (self.rules.rules.get(logical) == self.axis
                and dim % self.ways == 0)

    def block(self, dim: int) -> Tuple[int, int]:
        """(start, size) of this rank's block of a cut dim."""
        n = dim // self.ways
        return self.coord * n, n

    def enter(self, h):
        """``h`` (replicated along the axis) as the input of products with
        this rank's cut weights (Megatron's "f"): itself in the forward;
        in the backward the ranks' partial gradients of it are summed."""
        return collectives.tp_enter(h, self.mesh, self.axis)

    def heads(self, y, n_heads: int, head_dim: int, w_logical: str,
              act_logical: str, own: bool = False):
        """``y = x @ w``, w's columns (``w_logical``, n_heads x head_dim
        whole) this rank's block where they are cut. Returns (y split into
        heads, its first head): this rank's heads where the activation's
        heads (``act_logical``) are cut, else every head, gathered over
        the axis where only the weight's columns are (a head count the
        axis does not divide, or a block that splits a head). ``own``:
        the gathered heads feed this rank's own q heads (its gradient the
        reduce-scatter of the ranks'), else every rank alike (its
        gradient this rank's slice)."""
        act_cut = self.cut(act_logical, n_heads)
        if self.cut(w_logical, n_heads * head_dim) and not act_cut:
            gather = (collectives.gather_zero if own else
                      collectives.gather_replicated)
            y = gather(y, self.mesh, self.axis, dim=-1)
        first = self.block(n_heads)[0] if act_cut else 0
        return y.reshape(y.shape[:-1] + (-1, head_dim)), first

    def contract(self, x, w, w_logical: str, rows: int):
        """``x @ w`` summed over the ranks where w's ``rows`` (named
        ``w_logical``) are cut: a whole ``x`` gives its columns of this
        rank's block first (``take_slice``: its gradient gathered). With
        w whole it is the plain product. The partial products are summed
        in x's dtype, as the reference's program sums them (bf16
        partials: one rounding each, then the sum's); the sum's gradient
        passes through."""
        if not self.cut(w_logical, rows):
            return x @ w
        if x.shape[-1] == rows:
            x = collectives.take_slice(x, self.mesh, self.axis, dim=-1)
        return collectives.tp_all_reduce(x @ w, self.mesh, self.axis)

    def embed(self, table, tokens, vocab: int):
        """Rows ``tokens`` of the embedding ``table`` (vocab whole rows):
        where its rows are cut over 'vocab', each rank looks up the tokens
        of its block (0 elsewhere) and the sum over the ranks is the
        lookup (its gradient passes through to each rank's rows)."""
        if not self.cut("vocab", vocab):
            return table[tokens]
        start, n = self.block(vocab)
        local = tokens - start
        mine = (local >= 0) & (local < n)
        x = table[local.clamp(0, n - 1)]
        x = torch.where(mine[..., None], x, torch.zeros(
            (), dtype=x.dtype, device=x.device))
        return collectives.tp_all_reduce(x, self.mesh, self.axis)


def tensor_parallel(rules: Optional[ShardingRules] = None
                    ) -> Optional[TensorParallel]:
    """This rank's ``TensorParallel`` under ``rules`` (the current ones by
    default), or None where each rank holds its dense leaves whole: in
    one process (no rank mesh in the rules), under the expert-parallel
    rules (their branch cuts the experts only) or fsdp's (ZeRO over
    'data'), and where the tensor-parallel axis has one rank."""
    rules = current_rules() if rules is None else rules
    mesh = getattr(rules, "mesh", None)
    if mesh is None or not hasattr(mesh, "coordinate"):
        return None
    r = rules.rules
    if r.get("expert") is not None or r.get("embed") is not None:
        return None
    axis = r.get("q")
    ways = rules.axis_sizes.get(axis, 1) if isinstance(axis, str) else 1
    if ways == 1:
        return None
    if r.get("kv_seq") is not None:
        raise NotImplementedError(
            "tensor parallelism across ranks runs the baseline rules with "
            "decode_kv='heads'; decode_kv='seq' (the paged pool cut over "
            "its pages) is not ported (ROADMAP.md Queue 1 item 4.2)")
    return TensorParallel(rules, mesh, axis, ways, mesh.coordinate(axis))


def data_ranks(rules: Optional[ShardingRules] = None):
    """(rank mesh, the batch's mesh axes) where a rank mesh in ``rules``
    (the current ones by default) splits the batch over more than one
    rank, else None: the ranks whose losses make up one global loss."""
    rules = current_rules() if rules is None else rules
    mesh = getattr(rules, "mesh", None)
    if mesh is None or not hasattr(mesh, "coordinate") or \
            rules.size("batch") == 1:
        return None
    return mesh, rules.rules["batch"]


def refuse_cut(what: str, specs, slice_note: str) -> None:
    """Raise ``NotImplementedError`` where tensor parallelism across ranks
    is live and its axis would cut one of ``specs()`` (a block's
    ``ParamSpec``s by name, built only then): ``what`` runs only with
    whole leaves on every rank; ``slice_note`` names the work that ports
    it."""
    tp = tensor_parallel()
    if tp is None:
        return
    for name, spec in specs().items():
        if any(tp.axis in mesh_axes(e)
               for e in placement(tp.rules, spec.axes, spec.shape)):
            raise NotImplementedError(
                f"{what}: tensor parallelism across ranks would cut "
                f"{name} {tuple(spec.shape)} over '{tp.axis}' "
                f"({tp.ways} ways); {slice_note} is not ported "
                f"(ROADMAP.md Queue 1)")


def logical_to_pspec(axes: Tuple[Optional[str], ...],
                     rules: Optional[ShardingRules]) -> PartitionSpec:
    if rules is None:
        return P()
    return rules.spec(axes)

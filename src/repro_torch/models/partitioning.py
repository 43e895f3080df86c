"""Logical-axis partitioning (MaxText-style, lightweight).

Same rules as ``repro/models/partitioning.py``. Model code names tensor
dims with *logical* axes ('batch', 'embed', 'q', 'ff', 'expert', ...).
A ``ShardingRules`` maps logical names to mesh axes. Outside a rules
context everything is a no-op, so the same model code runs on one
device and under the dry-run's production meshes.

A partition spec is a ``PartitionSpec``: a tuple with one entry per
tensor dim, each None, a mesh-axis name or a tuple of names, normalised
as ``jax.sharding.PartitionSpec`` normalises its entries (a one-name
tuple becomes the name, an empty one None). ``shard`` hands the entries
it computes to ``_constrain``, the one place where a constraint would
take effect: in one process every tensor is whole, so it returns the
tensor as it is. Tensor- or expert-parallel work across processes
replaces that function.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple, Union

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
    # the mesh of devices (launch/mesh.py) — required only for the
    # explicit expert-parallel path (models/moe.py); None elsewhere
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
    """Place ``x`` as ``spec`` says. One process holds every tensor whole,
    so ``x`` comes back as it is."""
    return x


def shard(x, *axes: Optional[str]):
    """Constrain ``x`` to the sharding implied by logical ``axes``.

    No-op when no rules are active (``x`` itself comes back). Dims whose
    size is not divisible by the mapped mesh-axis product are left
    unsharded: forcing e.g. 8 whisper heads onto a 16-way model axis
    would replicate the whole tensor.
    """
    rules = current_rules()
    if rules is None:
        return x
    entries = []
    for dim, a in zip(x.shape, axes):
        m = rules.rules.get(a) if a is not None else None
        if m is None:
            entries.append(None)
            continue
        n = rules.size(a)
        entries.append(m if n <= 1 or dim % n == 0 else None)
    return _constrain(x, P(*entries))


def logical_to_pspec(axes: Tuple[Optional[str], ...],
                     rules: Optional[ShardingRules]) -> PartitionSpec:
    if rules is None:
        return P()
    return rules.spec(axes)

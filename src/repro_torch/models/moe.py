"""Top-k MoE feed-forward with sort-based capacity dispatch (dropped-token,
GShard-style capacity, without materialising the (T, E, C) one-hot).

Same function as the single-device branch of ``repro/models/moe.py``.
Dispatch is per batch row: each row's S * k selections are sorted by
expert (stably, as ``jnp.argsort`` sorts), the first C of each expert
keep a slot in its buffer, the rest are dropped. C depends only on S
(``capacity``), so the step's shapes are fixed by its input's shape.

Every op stays on the device and syncs nothing with the host (counts by
``scatter_add_``, positions by ``arange`` on the device), so the block
runs inside a captured CUDA graph (``serving/graphs.py``). The expert
buffers are filled by a gather (each slot reads the selection that
owns it), and the combine puts the slots back in token order (a scatter
of a permutation) and adds each token's k contributions in a fixed
order: no atomics, so a replay is bitwise equal to the eager step.

The reference's three sharding modes (see partitioning.tp_rules):

* MoE-TP and the expert-sharded SPMD mode run the experts here in one
  process, their constraints going through ``shard``. MoE-TP across
  ranks (the baseline rules over a rank mesh: ``partitioning.
  tensor_parallel``) cuts each expert's ``ff`` over 'model', as
  ``layers.mlp_block`` cuts the MLP's: routing, the aux loss and the
  dispatch stay replicated on every rank of a model line, the expert
  buffers enter the products with the rank's ``ff`` columns of ``wi``
  and ``wg`` (``TensorParallel.enter``), and the partial products of
  ``wo``'s rows are summed over 'model' in the activations' dtype on the
  buffers (B, E, C, d), before the combine, where the reference's
  program sums them (its ``out`` is constrained with ``d`` whole);
* the explicit expert-parallel branch (``rules.mesh`` set and the expert
  axis split, the reference's ``shard_map``) runs across ranks over
  ``torch.distributed``: ``rules.mesh`` is then a ``launch/mesh.py``
  ``ProcessMesh``, each rank holds its batch rows (the same on every
  rank of one expert line) and only its E / ep experts of ``wi``, ``wg``
  and ``wo`` (under the fsdp rules also only its d / z slice along
  ``embed``), and computes only those experts; its collectives go
  through ``launch/collectives.py``. Over data ranks, where a gradient
  flows, the aux loss's means are global (all-reduced over the batch
  axes), as the reference's are under GSPMD.
"""
from __future__ import annotations

import contextlib
from math import ceil
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import collectives
from repro_torch.models.layers import rms_norm
from repro_torch.models.partitioning import (current_rules, data_ranks,
                                             shard, tensor_parallel)


def capacity(cfg: ModelConfig, seq: int) -> int:
    moe = cfg.moe
    c = ceil(seq * moe.top_k / moe.n_experts * moe.capacity_factor)
    return max(1, min(c, seq * moe.top_k))


# the router's choices of every ``moe_block`` call made inside
# ``recording_routes()``, in call order; None outside it
_ROUTES: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def recording_routes():
    """Collect the expert indices (B, S, k) that each ``moe_block`` call
    routes its tokens to, one tensor a call in call order (the list
    yielded): what tells two runs whose outputs part whether they sent a
    token to other experts."""
    global _ROUTES
    prev, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = prev


def route(p, h, cfg: ModelConfig):
    """Router of ``moe_block`` on the normed input ``h`` (B, S, d):
    (probs (B, S, E) f32, gates (B, S, k) f32 renormalised over the k,
    expert indices (B, S, k) int64)."""
    logits = h.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, eidx


def dispatch(eidx, n_experts: int):
    """Position-in-expert of each selection, per row. eidx: (B, S, k).

    Returns (sort_idx (B, T): the stable sort of the T = S * k selections
    by expert; sorted_e (B, T): their experts; pos (B, T): each one's rank
    within its expert; starts (B, E): the sorted index of each expert's
    first selection; counts (B, E): selections per expert)."""
    B = eidx.shape[0]
    fe = eidx.reshape(B, -1)                                   # (B, T)
    sort_idx = torch.argsort(fe, dim=1, stable=True)
    sorted_e = torch.gather(fe, 1, sort_idx)
    counts = torch.zeros((B, n_experts), dtype=torch.int64,
                         device=fe.device).scatter_add_(
                             1, fe, torch.ones_like(fe))
    starts = torch.cumsum(counts, dim=1) - counts
    pos = (torch.arange(fe.shape[1], device=fe.device)[None]
           - torch.gather(starts, 1, sorted_e))
    return sort_idx, sorted_e, pos, starts, counts


def moe_block(p, x, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x + moe_out, aux_load_balance_loss f32 scalar)."""
    moe = cfg.moe
    B, S, d = x.shape
    E, k = moe.n_experts, moe.top_k
    C = capacity(cfg, S)
    T = S * k

    h = rms_norm(x, p["norm"], cfg.norm_eps)
    probs, gates, eidx = route(p, h, cfg)
    if _ROUTES is not None:
        _ROUTES.append(eidx)

    # ---- aux load-balance loss (Switch-style) ----
    top1 = torch.zeros((E,), dtype=torch.float32, device=x.device)
    top1.scatter_add_(0, eidx[..., 0].reshape(-1),
                      torch.ones((B * S,), dtype=torch.float32,
                                 device=x.device))
    ranks = data_ranks() if probs.requires_grad else None
    if ranks is None:
        me = probs.mean(dim=(0, 1))                            # (E,)
        aux = E * torch.sum(me * (top1 / (B * S)))
    else:
        # over data ranks the means are global, as the reference's are
        # under GSPMD: the ranks' sums summed (the gradient of each rank's
        # probabilities passes through), over the global row count. A
        # step with no gradient drops the aux (the reference's compiled
        # serving steps drop it too): it stays this rank's, uncounted
        rows = B * S * current_rules().size("batch")
        sums = collectives.tp_all_reduce(
            torch.cat([probs.sum(dim=(0, 1)), top1]), *ranks) / rows
        aux = E * torch.sum(sums[:E] * sums[E:])

    # ---- sort-based position-in-expert ----
    sort_idx, sorted_e, pos, starts, counts = dispatch(eidx, E)
    keep = pos < C
    tok_sorted = sort_idx // k                                 # its token

    # ---- expert buffers (B, E, C, d): slot (e, c) holds the selection at
    # sorted index starts[e] + c if the expert has that many, else zeros
    # (the reference's scatter into zeros, as a gather) ----
    c_idx = torch.arange(C, device=x.device)
    src = starts[:, :, None] + c_idx                           # (B, E, C)
    filled = c_idx < counts[:, :, None]
    src = torch.clamp(src, max=T - 1).reshape(B, E * C)
    tok = torch.gather(tok_sorted, 1, src)                     # (B, E*C)
    ebuf = torch.gather(h, 1, tok[..., None].expand(-1, -1, d))
    ebuf = torch.where(filled.reshape(B, E * C, 1), ebuf, 0.0)
    ebuf = ebuf.reshape(B, E, C, d)

    # ---- expert computation (gated MLP), one batched product an expert ----
    rules = current_rules()
    if expert_parallel(rules, E):
        out = _expert_ffn_expert_parallel(p, ebuf, rules)
    else:
        tp = tensor_parallel(rules)
        cut = tp is not None and tp.cut("ff", cfg.d_ff)
        ebuf = shard(ebuf, "batch", "act_expert", None, None)
        if cut:
            ebuf = tp.enter(ebuf)
        up = torch.einsum("becd,edf->becf", ebuf, p["wi"])
        gate = torch.einsum("becd,edf->becf", ebuf, p["wg"])
        act = shard(F.silu(gate) * up, "batch", "act_expert", None, "act_ff")
        out = torch.einsum("becf,efd->becd", act, p["wo"])
        if cut:
            # this rank's 'ff' rows of wo: the partial products summed
            out = collectives.tp_all_reduce(out, tp.mesh, tp.axis)
        out = shard(out, "batch", "act_expert", None, None)

    # ---- combine: each selection, in token order (t * k + j), reads its
    # slot's output (the zero row E*C when it was dropped) weighted by its
    # gate; each token then adds its k contributions in order ----
    slot = torch.empty_like(sort_idx).scatter_(
        1, sort_idx, torch.where(keep, sorted_e * C + pos, E * C))
    obuf = torch.cat([out.reshape(B, E * C, d),
                      torch.zeros((B, 1, d), dtype=out.dtype,
                                  device=x.device)], dim=1)
    got = torch.gather(obuf, 1, slot[..., None].expand(-1, -1, d))
    w = torch.where(slot < E * C, gates.reshape(B, T), 0.0)
    got = (got * w[..., None].to(got.dtype)).reshape(B, S, k, d)
    y = got[:, :, 0]
    for j in range(1, k):
        y = y + got[:, :, j]
    y = shard(y, "batch", None, "act_embed")
    return x + y, aux


# ---------------------------------------------------------------------------
# Explicit expert parallelism across ranks
# ---------------------------------------------------------------------------

def expert_parallel(rules, n_experts: int) -> bool:
    """The reference's condition for its ``shard_map`` branch: a mesh in
    the rules, and the expert axis split a number of ways that divides
    the experts."""
    return (rules is not None and rules.mesh is not None
            and rules.size("expert") > 1
            and n_experts % rules.size("expert") == 0)


def zero_gathered(rules, d_model: int) -> bool:
    """Whether the branch gathers the expert weights along ``embed`` (the
    reference's ``gather_d``): the rules map ``embed`` to a mesh axis
    whose size divides d."""
    axis = rules.rules.get("embed")
    return axis is not None and d_model % rules.axis_sizes.get(axis, 1) == 0


def _expert_ffn_expert_parallel(p, ebuf, rules):
    """The reference's ``_expert_ffn_shard_map`` across ranks.

    ebuf: (B_loc, E, C, d), this rank's batch rows, the same on every
    rank along the expert axis; p["wi"], p["wg"]: (E / ep, d / z, f),
    p["wo"]: (E / ep, f, d / z) (z = 1 unless ``zero_gathered``). The
    ZeRO shards are all-gathered over the ``embed`` axis, each rank runs
    its own experts on its slice of the buffers, and the outputs are
    all-gathered over the expert axis into (B_loc, E, C, d)."""
    mesh = rules.mesh
    if not hasattr(mesh, "group"):
        raise TypeError(
            f"moe_block: the expert-parallel branch runs across live ranks: "
            f"rules.mesh must be a launch.mesh.ProcessMesh, got "
            f"{type(mesh).__name__}; a mesh description belongs in "
            f"axis_sizes, with mesh=None (the expert-sharded SPMD mode)")
    expert_axis = rules.rules.get("expert")
    zero_axis = rules.rules.get("embed")
    E, d = ebuf.shape[1], ebuf.shape[3]
    ep = rules.size("expert")
    gather_d = zero_gathered(rules, d)
    z = rules.axis_sizes.get(zero_axis, 1) if gather_d else 1
    wi, wg, wo = p["wi"], p["wg"], p["wo"]
    held = (E // ep, d // z)
    if wi.shape[:2] != held or wg.shape[:2] != held or \
            wo.shape[0::2] != held:
        raise ValueError(
            f"moe_block: this rank holds wi {tuple(wi.shape)}, wo "
            f"{tuple(wo.shape)}; the branch takes its {E // ep} of {E} "
            f"experts and d / {z} = {d // z} along embed (launch/ranks.py "
            f"cuts a rank's block)")
    if gather_d:
        wi = collectives.gather_zero(wi, mesh, zero_axis, dim=1)
        wg = collectives.gather_zero(wg, mesh, zero_axis, dim=1)
        wo = collectives.gather_zero(wo, mesh, zero_axis, dim=2)
    eb = collectives.take_slice(ebuf, mesh, expert_axis, dim=1)
    up = torch.einsum("becd,edf->becf", eb, wi)
    gate = torch.einsum("becd,edf->becf", eb, wg)
    out = torch.einsum("becf,efd->becd", F.silu(gate) * up, wo)
    return collectives.gather_replicated(out, mesh, expert_axis, dim=1)

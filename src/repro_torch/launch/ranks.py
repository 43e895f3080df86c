"""Ranks across a process mesh: each rank's block of a case, and the
worker that runs a case's steps across ranks.

How a rank holds a ``launch/specs.build_case`` case with a
``ProcessMesh`` in its rules:

* under the baseline rules (``tp_rules()``: tensor parallelism,
  ``partitioning.tensor_parallel``) every parameter, cache and output
  is cut as its spec says after the divisibility rule
  (``partitioning.placement``, the dry-run's ``sanitize``): the bytes a
  rank holds are the dry-run's per-device bytes: each expert's 'ff'
  under MoE-TP, an SSM layer's state over its heads and its conv tail
  over its channels. A dense cache cut over its sequence must have the
  axis divide it (``rank_caches``);
* under ``tp_rules(expert_parallel=True, ...)`` the batch tensors
  (tokens, lengths, caches, images, frames) are cut over the batch axes
  only: a rank holds its rows, the same rows on every rank of one
  expert line; the expert weights ``wi``, ``wg``, ``wo`` and their AdamW
  moments are cut by their specs where the branch runs
  (``moe.expert_parallel``): this rank's E / ep experts, and under the
  fsdp rules its d / z slice along ``embed`` (``moe.zero_gathered``);
  every other tensor is whole on every rank;
* a train batch (the role "micro") is cut as a batch once its rows are
  in ``micro_order``: a rank holds its share of each of the reference's
  microbatches.

``rank_block`` cuts whole arguments or outputs to a rank's block and
``gather_blocks`` puts the blocks back together (for tests: copies that
ranks hold alike must be equal). ``run_ranks`` starts one process a rank
(``torch.multiprocessing`` spawn), joins each to the process group
through a ``file://`` store in a directory of the caller's and to the
mesh, runs the jobs it is given and hands back each rank's results on
the CPU. The jobs: ``run_plan_rank`` draws only this rank's block of
the parameters (``init_params``' cut, layer by layer), builds the case
with the process mesh in its rules and runs its steps (a ``Plan``'s
``paged`` steps run the paged pool instead: a prefill, a suffix prefill
over its cached prefix, decode steps; its train steps take a batch
whose rows a rank holds in ``micro_order``); ``run_moe_rank`` runs one
``moe_block`` with its gradient. ``run_plan`` is the same plan in one
process: the reference the ranks are held to.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch import collectives, distributed
from repro_torch.launch.mesh import CountingMesh, MeshDesc, ProcessMesh
from repro_torch.launch.specs import build_case, train_plan
from repro_torch.models import moe as MOE
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import (ParamSpec, flatten, init_params,
                                       moe_spec, param_structure)
from repro_torch.models.model import decode_forward, prefill_forward
from repro_torch.models.partitioning import (P, ShardingRules, block_index,
                                             kv_heads_cut, mesh_axes,
                                             placement, tensor_parallel,
                                             tp_rules, use_rules)
from repro_torch.models.transformer import (cache_pspecs, clone_caches,
                                            make_caches, reset_caches)
from repro_torch.training.optimizer import AdamW

# the role of each argument of a case, and of each output of its step
ARG_ROLES = {"prefill": ("params", "batch", "batch", "batch", "batch",
                         "batch"),
             "decode": ("params", "batch", "batch"),
             "train": ("params", "opt", "micro")}
OUT_ROLES = {"prefill": ("batch", "batch"), "decode": ("batch", "batch"),
             "train": ("params", "opt", "whole")}
SEED = 0


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def coordinates(desc: MeshDesc, rank: int) -> Dict[str, int]:
    """Rank ``rank``'s position on each axis of the mesh, row-major (the
    order in which ``init_device_mesh`` and ``jax.make_mesh`` lay ranks)."""
    out = {}
    for name, n in reversed(tuple(zip(desc.axis_names, desc.shape))):
        out[name] = rank % n
        rank //= n
    return out


def expert_entries(spec: ParamSpec, rules: ShardingRules):
    """Mesh axes each dim of a parameter leaf is cut over, or None when
    the leaf is whole on every rank: only the expert weights are cut, and
    only where the branch runs."""
    if "expert" not in spec.axes:
        return None
    n_exp = spec.shape[spec.axes.index("expert")]
    if not MOE.expert_parallel(rules, n_exp):
        return None
    d = spec.shape[spec.axes.index("embed")]
    out = []
    for a in spec.axes:
        if a == "expert":
            out.append(rules.rules["expert"])
        elif a == "embed" and MOE.zero_gathered(rules, d):
            out.append(rules.rules["embed"])
        else:
            out.append(None)
    return out


def leaf_entries(spec: ParamSpec, rules: ShardingRules):
    """Mesh axes each dim of a parameter leaf is cut over on a rank, or
    None when it is whole on every rank: under tensor parallelism its
    placement, else the expert-parallel branch's cut."""
    if tensor_parallel(rules) is not None:
        entries = placement(rules, spec.axes, spec.shape)
        return entries if any(e is not None for e in entries) else None
    return expert_entries(spec, rules)


def param_cut(rules: ShardingRules, coords: Dict[str, int]):
    """``init_params``' cut: this rank's block of each leaf it cuts."""
    def cut(spec: ParamSpec):
        entries = leaf_entries(spec, rules)
        if entries is None:
            return None
        return block_index(spec.shape, entries, rules.axis_sizes, coords)
    return cut


def _batch_entries(spec, rules: ShardingRules):
    """The entries of a batch tensor's spec a rank cuts it over: all of
    them under tensor parallelism, else those that name only batch
    axes."""
    if tensor_parallel(rules) is not None:
        return list(spec or ())
    batch = set(mesh_axes(rules.rules.get("batch")))
    return [e if e is not None and set(mesh_axes(e)) <= batch else None
            for e in tuple(spec or ())]


def _walk(fn, spec, tree):
    """``tree`` with each tensor t replaced by fn(its spec, t), visited in
    ``flatten``'s order (dict keys sorted; the dicts keep their order);
    the spec tree may stop early (a missing spec is None)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(spec, tree)
    if isinstance(tree, dict):
        got = {k: _walk(fn, spec.get(k) if isinstance(spec, dict) else None,
                        tree[k]) for k in sorted(tree)}
        return {k: got[k] for k in tree}
    specs = (spec if isinstance(spec, (tuple, list))
             and not isinstance(spec, P) else (None,) * len(tree))
    items = [_walk(fn, s, t) for s, t in zip(specs, tree)]
    if hasattr(tree, "_fields"):
        return type(tree)(*items)
    return type(tree)(items)


def micro_order(rules: ShardingRules, rows: int) -> Optional[torch.Tensor]:
    """The order of a train batch's ``rows`` in which each rank's block is
    contiguous, or None where it is the rows' own order. The reference's
    microbatch i is rows [i B / n, (i + 1) B / n) of the whole batch
    (``train_plan``'s n), which the data ranks split: a rank's block
    holds, microbatch by microbatch, its share of the reference's rows,
    and the step's reshape of its rows into n microbatches finds them
    (rows that n x data does not divide stay in order: no step splits
    them so)."""
    n = train_plan(rules, InputShape("train", 0, rows, "train"))[0]
    d = rules.size("batch")
    if n == 1 or d == 1 or rows % (n * d):
        return None
    return torch.arange(rows).reshape(n, d, rows // (n * d)).transpose(
        0, 1).reshape(-1)


def _leaf_entries(cfg: ModelConfig, role: str, spec, tree, rules,
                  structure=None):
    """(entries or None) of each tensor of ``tree`` in ``flatten``'s
    order, for one role."""
    if role == "whole":
        return [None] * len(flatten(tree))
    if role == "params":
        structure = structure or param_structure(cfg)
        return [leaf_entries(s, rules) for s in flatten(structure)]
    if role == "opt":
        per = _leaf_entries(cfg, "params", None, None, rules, structure)
        return [None] + per + per
    # "batch", and "micro": a train batch, cut as a batch once its rows
    # are in ``micro_order``
    got = []
    _walk(lambda s, t: got.append(_batch_entries(s, rules)), spec, tree)
    return got


def _tensors_of(tree) -> List[torch.Tensor]:
    got = []
    _walk(lambda s, t: got.append(t), None, tree)
    return got


def _rebuild(tree, new: Sequence[torch.Tensor]):
    it = iter(new)
    return _walk(lambda s, t: next(it), None, tree)


def rank_block(cfg: ModelConfig, roles: Sequence[str], specs, trees,
               rules: ShardingRules, coords: Dict[str, int],
               structure=None) -> tuple:
    """This rank's block of each of ``trees`` (whole tensors), cut by its
    role (``ARG_ROLES`` / ``OUT_ROLES``; ``specs`` the case's in_specs, or
    the step's output specs from ``out_specs``). ``structure``: the
    ParamSpec tree of a "params" role when it is not the whole model's
    (one MoE layer, say). A None tree stays None."""
    out = []
    for role, spec, tree in zip(roles, specs, trees):
        if tree is None:
            out.append(None)
            continue
        ents = _leaf_entries(cfg, role, spec, tree, rules, structure)
        ts = _tensors_of(tree)
        if len(ents) != len(ts):
            raise ValueError(f"rank_block: a {role} tree of {len(ts)} "
                             f"tensors, {len(ents)} expected")
        if role == "micro":
            order = micro_order(rules, ts[0].shape[0])
            if order is not None:
                ts = [t[order.to(t.device)] for t in ts]
        out.append(_rebuild(tree, [
            t if e is None else
            t[block_index(t.shape, e, rules.axis_sizes, coords)].clone()
            for e, t in zip(ents, ts)]))
    return tuple(out)


def gather_blocks(cfg: ModelConfig, roles: Sequence[str], specs,
                  blocks_by_rank: Sequence[tuple], like,
                  rules: ShardingRules, desc: MeshDesc,
                  structure=None) -> tuple:
    """The inverse of ``rank_block``: each rank's blocks (rank order)
    put together into whole trees shaped as ``like`` (whole trees or
    ``meta`` tensors of the whole shapes). Ranks that hold the same block
    must hold equal values (bitwise); else this raises."""
    out = []
    for i, (role, spec, tree) in enumerate(zip(roles, specs, like)):
        if tree is None:
            out.append(None)
            continue
        ents = _leaf_entries(cfg, role, spec, tree, rules, structure)
        whole = _tensors_of(tree)
        per_rank = [_tensors_of(b[i]) for b in blocks_by_rank]
        new = []
        for j, (e, w) in enumerate(zip(ents, whole)):
            first = per_rank[0][j]
            t = torch.empty(w.shape, dtype=first.dtype)
            held = {}
            for r, ts in enumerate(per_rank):
                idx = block_index(w.shape, e or (), rules.axis_sizes,
                                  coordinates(desc, r))
                key = tuple((s.start, s.stop) for s in idx)
                if key in held:
                    if not torch.equal(held[key], ts[j]):
                        raise AssertionError(
                            f"gather_blocks: rank {r} holds another value "
                            f"of a block it shares ({role}, leaf {j}, "
                            f"{tuple(w.shape)})")
                    continue
                held[key] = ts[j]
                t[idx] = ts[j]
            if role == "micro":
                order = micro_order(rules, t.shape[0])
                if order is not None:
                    t = torch.empty_like(t).index_copy_(0, order, t)
            new.append(t)
        out.append(_rebuild(tree, new))
    return tuple(out)


def out_specs(kind: str, case, rules: ShardingRules) -> tuple:
    """The specs of a step's outputs, in ``OUT_ROLES``' order."""
    if kind == "train":
        return (None, None, None)
    cache_spec = case.in_specs[3] if kind == "prefill" else case.in_specs[2]
    return (rules.spec(("batch", "act_vocab")), cache_spec)


# ---------------------------------------------------------------------------
# a plan of steps, in one process or on each rank
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Plan:
    """A case's steps on one configuration: a prefill of ``prefill``
    (batch, padded length, true lengths), then ``decode`` decode steps
    over the caches it filled (the first fed random tokens, each later
    one the greedy tokens of the step before), and ``train_steps`` train
    steps of ``train`` (batch, length) or (batch, length, valid labels a
    row: the rest -1), each on the new parameters and AdamW state of the
    one before and a batch of its own. ``paged`` (page, prefix length,
    prompt length) runs a paged pool instead of ``prefill``, batch 1: a
    prefill of the prompt's first tokens, a suffix prefill of the rest
    over them (``prefix_len`` / ``pos_base``), then the decode steps.
    Parameters are drawn from seed ``SEED`` on the device, inputs from
    ``SEED`` + 1 on the CPU. ``layers`` cuts the config's depth in whole
    periods of its pattern (jamba's 8 layers)."""
    arch: str
    reduced: bool = True
    layers: Optional[int] = None
    # (n_heads, n_kv_heads) in place of the config's
    heads: Optional[Tuple[int, int]] = None
    dtype: str = "float32"
    # K/V storage dtype of the caches ("float8_e4m3fn"), default dtype
    kv_dtype: Optional[str] = None
    # the rules: the expert-parallel branch's, or the baseline tensor-
    # parallel ones
    expert_parallel: bool = True
    fsdp: bool = False
    prefill: Optional[Tuple[int, int, Tuple[int, ...]]] = None
    paged: Optional[Tuple[int, int, int]] = None
    decode: int = 0
    train: Optional[Tuple] = None
    train_steps: int = 1
    # hand back the caches, new parameters and AdamW state as ``digest``s
    # (the logits and metrics whole): what a full-size run can return
    digest: bool = False
    # run the first step of each kind once first on copies of what it
    # writes, so that the counted, timed run is warm (a later step of the
    # kind is warm from the one before)
    warm: bool = False
    # on the card, run the first decode step once more on copies of the
    # caches after the counted run, and one more train step after the
    # last, under torch.profiler (``trace_step``)
    trace: bool = False
    # keep each serving step's routing: the experts of each token of each
    # MoE layer, "routes" (layers, rows, length, k) int16, each token's k
    # in ascending order (``moe.recording_routes``)
    routes: bool = False


def plan_config(plan: Plan) -> ModelConfig:
    cfg = get_config(plan.arch)
    if plan.reduced:
        cfg = cfg.reduced()
    if plan.layers:
        if plan.layers % len(cfg.pattern):
            raise ValueError(
                f"plan_config: {plan.layers} layers of {cfg.name}, not a "
                f"multiple of its {len(cfg.pattern)}-layer period")
        cfg = dataclasses.replace(cfg, n_layers=plan.layers,
                                  name=f"{cfg.name}-{plan.layers}layer")
    if plan.heads:
        nq, nkv = plan.heads
        cfg = dataclasses.replace(cfg, n_heads=nq, n_kv_heads=nkv,
                                  name=f"{cfg.name}-{nq}q{nkv}kv")
    return cfg


def plan_rules(plan: Plan, desc: MeshDesc, mesh=None) -> ShardingRules:
    """The plan's rules at the mesh's sizes; ``mesh`` None gives the
    one-process run of the same plan (the same ``train_plan``)."""
    return tp_rules(expert_parallel=plan.expert_parallel, fsdp=plan.fsdp,
                    axis_sizes=desc.axis_sizes, mesh=mesh)


def block_rules(plan: Plan, desc: MeshDesc) -> ShardingRules:
    """The plan's rules with a rank mesh over ``desc`` (a ``CountingMesh``
    at rank 0; no group): what ``rank_block`` and ``gather_blocks`` take
    on the host to cut, or put back together, the blocks the ranks hold
    (under tensor parallelism every leaf is cut)."""
    return plan_rules(plan, desc, CountingMesh(desc, coordinates(desc, 0)))


def rank_caches(cfg: ModelConfig, batch: int, max_len: int,
                rules: ShardingRules, coords: Dict[str, int], *,
                device, **kw) -> Dict[str, Any]:
    """This rank's block of ``make_caches(cfg, batch, max_len, **kw)``,
    cut as ``rank_block`` cuts a case's caches (by ``cache_pspecs``),
    filled as a fresh cache is (an SSM state cut over its heads, a conv
    tail over its channels). Under tensor parallelism a dense cache
    cut over its sequence must have the axis divide it: a rank reads the
    place of its slots from its share of the sequence."""
    layout = kw.get("layout", "dense")
    whole = make_caches(cfg, batch, max_len, device="meta", **kw)
    tp = tensor_parallel(rules)
    if tp is not None and layout == "dense" and \
            not kv_heads_cut(rules, cfg.n_kv_heads) and max_len % tp.ways:
        raise NotImplementedError(
            f"rank_caches: a dense cache of {max_len} slots cut over its "
            f"sequence {tp.ways} ways")
    specs = cache_pspecs(cfg, rules, layout)
    out = _walk(lambda spec, t: torch.zeros(
        t[block_index(t.shape, _batch_entries(spec, rules),
                      rules.axis_sizes, coords)].shape,
        dtype=t.dtype, device=device), specs, whole)
    reset_caches(out)
    return out


def _ints(gen, high, shape):
    return torch.randint(0, high, shape, generator=gen, dtype=torch.int32)


def _normal(gen, shape, dtype):
    return torch.randn(shape, generator=gen).to(dtype)


def drive(cfg: ModelConfig, plan: Plan, params, rules: ShardingRules,
          device, coords: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
    """Run the plan's steps through ``build_case``'s step functions (the
    paged steps through ``prefill_forward`` / ``decode_forward`` under
    the rules). ``params`` are whole in one process (``coords`` None), or
    this rank's block; the inputs are made whole and cut to the rank's
    block, the caches made as this rank's block. Per step: its outputs,
    the kernel launches and the collectives (counts set to 0 just before
    the step, read just after), and its seconds (after a warm-up on
    copies where ``plan.warm``), and where ``plan.routes`` a serving
    step's routing ("routes"); the first decode step under "decode",
    the later ones in the list "more"; "greedy" (b_rows, steps): the
    argmax of each step's logits over the whole vocabulary (gathered
    after the step where a rank holds a block of it); "inputs": the whole
    inputs drawn (the prefill's "tokens", "lengths", "mm", "enc"; the
    first decode step's "decode")."""
    dt = getattr(torch, plan.dtype)
    kv = getattr(torch, plan.kv_dtype) if plan.kv_dtype else None
    gen = torch.Generator().manual_seed(SEED + 1)
    tp = None if coords is None else tensor_parallel(rules)
    res: Dict[str, Any] = {"more": [], "train_more": [], "greedy": [],
                           "inputs": {}}

    def cut(specs, args, role="batch"):
        """On a rank, the whole batch tensors ``args`` cut to its block."""
        if coords is None:
            return list(args)
        return list(rank_block(cfg, (role,) * len(args), specs, args,
                               rules, coords))

    def step(kind, fn, args, at=None):
        """Run one step; ``args[at]``: the caches it writes."""
        if plan.warm and kind not in res:
            fn(*(clone_caches(a) if i == at else a
                 for i, a in enumerate(args)))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ops.reset_launch_counts()
        collectives.reset()
        record = plan.routes and kind != "train"
        with (MOE.recording_routes() if record else
              contextlib.nullcontext()) as routes:
            t0 = time.perf_counter()
            out = fn(*args)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            secs = time.perf_counter() - t0
        kept = out
        if plan.digest:
            kept = ((out[0], digest(out[1])) if kind != "train" else
                    (digest(out[0]), digest(out[1]), out[2]))
        rec = dict(out=kept, s=secs, launches=ops.launch_counts(),
                   collectives=collectives.collective_bytes(),
                   calls=collectives.collective_calls())
        if routes:
            rec["routes"] = torch.stack(
                [e.sort(-1).values for e in routes]).to(torch.int16)
        if kind in res:
            res["more" if kind == "decode" else f"{kind}_more"].append(rec)
        else:
            res[kind] = rec
            if plan.trace and kind == "decode" and device.type == "cuda":
                rec["trace"] = trace_step(fn, [
                    clone_caches(a) if i == at else a
                    for i, a in enumerate(args)], device)
        if kind != "train":
            logits = out[0]
            if tp is not None and logits.shape[-1] < cfg.vocab:
                logits = collectives.all_gather(logits, tp.mesh, tp.axis,
                                                dim=-1)
            res["greedy"].append(logits.argmax(-1).to(torch.int32))
        return out

    def to(t):
        return None if t is None else t.to(device)

    def caches_of(b, max_len, **kw):
        kw = dict(dtype=dt, kv_dtype=kv, **kw)
        if coords is None:
            return make_caches(cfg, b, max_len, device=device, **kw)
        return rank_caches(cfg, b, max_len, rules, coords, device=device,
                           **kw)

    def decode(b, max_len, caches, fn=None):
        """``plan.decode`` steps, the first fed random tokens."""
        case = build_case(cfg, InputShape("decode", max_len, b, "decode"),
                          rules)
        first = to(_ints(gen, cfg.vocab, (b,)))
        res["inputs"]["decode"] = first
        toks = cut((case.in_specs[1],), (first,))
        for _ in range(plan.decode):
            _, caches = step("decode", fn or case.fn,
                             (params, toks[0], caches), at=2)
            toks = [res["greedy"][-1]]

    if plan.prefill is not None:
        b, s, lengths = plan.prefill
        case = build_case(cfg, InputShape("prefill", s, b, "prefill"), rules)
        toks = _ints(gen, cfg.vocab, case.args[1].shape)
        mm, enc = case.args[4], case.args[5]
        mm = None if mm is None else _normal(gen, mm.shape, dt)
        enc = None if enc is None else _normal(gen, enc.shape, dt)
        lens = torch.tensor(lengths, dtype=torch.int32, device=device)
        res["inputs"].update(tokens=toks, lengths=lens, mm=mm, enc=enc)
        at = (1, 2, 4, 5)
        args = cut([case.in_specs[i] for i in at],
                   (to(toks), lens, to(mm), to(enc)))
        _, caches = step("prefill", case.fn, (params, *args[:2],
                                               caches_of(b, s), *args[2:]),
                         at=3)
        decode(b, s, caches)
    if plan.paged is not None:
        # batch 1, so one data rank: the pool is the rows' shared state
        if rules.size("batch") > 1:
            raise ValueError("a paged plan runs batch 1: one data rank")
        page, prefix, n = plan.paged
        max_len = -(-(n + plan.decode) // page) * page
        width = max_len // page
        caches = caches_of(1, max_len, layout="paged", page_size=page,
                           n_pages=1 + width)
        caches["pages"][0] = torch.arange(width, 0, -1, dtype=torch.int32)
        text = _ints(gen, cfg.vocab, (n,))
        first = torch.zeros((1, -(-prefix // page) * page),
                            dtype=torch.int32)
        first[0, :prefix] = text[:prefix]
        pos_base = prefix // page * page
        rest = torch.zeros((1, -(-n // page) * page - pos_base),
                           dtype=torch.int32)
        rest[0, prefix - pos_base:n - pos_base] = text[prefix:]

        def prefill(params, tokens, caches, n, **kw):
            with use_rules(rules):
                return prefill_forward(params, cfg, tokens, caches,
                                       lengths=torch.tensor(
                                           [n], dtype=torch.int32,
                                           device=device), **kw)

        def paged_decode(params, tokens, caches):
            with use_rules(rules):
                return decode_forward(params, cfg, tokens, caches)

        _, caches = step("prefill", prefill, (params, to(first), caches,
                                              prefix), at=2)
        _, caches = step("suffix", functools.partial(
            prefill, prefix_len=prefix, pos_base=pos_base),
            (params, to(rest), caches, n), at=2)
        decode(1, max_len, caches, paged_decode)
    if plan.train is not None:
        b, s = plan.train[:2]
        case = build_case(cfg, InputShape("train", s, b, "train"), rules)
        state = AdamW().init(params)
        res["inputs"]["train"] = []
        for _ in range(plan.train_steps):
            batch = {k: _ints(gen, cfg.vocab, t.shape)
                     if t.dtype == torch.int32 else _normal(gen, t.shape, dt)
                     for k, t in case.args[2].items()}
            if len(plan.train) > 2:
                keep = torch.arange(batch["labels"].shape[1])[None] < \
                    torch.tensor(plan.train[2])[:, None]
                batch["labels"] = torch.where(keep, batch["labels"], -1)
            res["inputs"]["train"].append(batch)
            batch = cut((case.in_specs[2],), (
                {k: to(t) for k, t in batch.items()},), "micro")[0]
            params, state, _ = step("train", case.fn, (params, state, batch))
        if plan.trace and device.type == "cuda":
            # once the steps are done, so that only the last step's new
            # parameters and state are held beside the traced step's
            res["train"]["trace"] = trace_step(case.fn, [params, state,
                                                         batch], device)
    res["greedy"] = (torch.stack(res["greedy"], dim=1) if res["greedy"]
                     else None)
    return res


def trace_step(fn, args, device, top: int = 8) -> Dict[str, Any]:
    """``fn(*args)`` once under torch.profiler, its result dropped: the
    wall ms (tracing included), the device ms and launches of the kernels
    it ran, the part of those ms in NCCL's kernels (which count the time
    they wait for the other ranks), and the ``top`` kernels by device
    time (ms, launches, name)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile_serve import _device_us
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    # the device rows named "nccl:..." are the collectives' annotations,
    # ranges over their kernels, not kernels
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.key.startswith("nccl:")),
                     key=_device_us, reverse=True)
    return dict(wall_ms=1e3 * wall,
                device_ms=sum(_device_us(e) for e in kernels) / 1e3,
                nccl_ms=sum(_device_us(e) for e in kernels
                            if e.key.startswith("ncclDevKernel")) / 1e3,
                launches=sum(e.count for e in kernels),
                top=[(_device_us(e) / 1e3, e.count, e.key[:80])
                     for e in kernels[:top]])


def digest(tree) -> torch.Tensor:
    """(n, 2) float64 on the CPU: the sum and the sum of squares of each
    tensor of ``tree``, in ``flatten``'s order."""
    rows = [torch.stack([t.double().sum(), t.double().square().sum()])
            for t in _tensors_of(tree)]
    return torch.stack(rows).cpu()


def plan_params(plan: Plan, device, cut=None):
    """The plan's parameters, drawn from ``SEED`` on ``device`` (only the
    block ``cut`` keeps, where given: ``init_params``' cut)."""
    device = torch.device(device)
    return init_params(plan_config(plan), torch.Generator(
        device=device).manual_seed(SEED), device=device,
        dtype=getattr(torch, plan.dtype), cut=cut)


def run_plan(plan: Plan, desc: MeshDesc, device) -> Dict[str, Any]:
    """The plan in one process, with whole parameters, under the rules of
    the mesh's sizes with no mesh: the reference the ranks are held to."""
    device = torch.device(device)
    return drive(plan_config(plan), plan, plan_params(plan, device),
                 plan_rules(plan, desc), device)


def run_plan_rank(mesh: ProcessMesh, device, plan: Plan) -> Dict[str, Any]:
    """The plan on this rank: only its block of the parameters is drawn
    (``init_params``' cut, so the values are the whole tree's), the case
    built with the process mesh in its rules."""
    cfg = plan_config(plan)
    rules = plan_rules(plan, mesh.desc, mesh)
    coords = {a: mesh.coordinate(a) for a in mesh.axis_names}
    params = plan_params(plan, device, cut=param_cut(rules, coords))
    res = drive(cfg, plan, params, rules, device, coords)
    del params
    return res


def moe_loss(p, x, cfg: ModelConfig):
    """``moe_block`` on x with the loss sum(y ** 2) + aux, and the kept
    selections (B, S, k) in token order."""
    y, aux = MOE.moe_block(p, x, cfg)
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    _, _, eidx = MOE.route(p, h, cfg)
    sort_idx, _, pos, _, _ = MOE.dispatch(eidx, cfg.moe.n_experts)
    keep = torch.zeros_like(pos, dtype=torch.bool).scatter_(
        1, sort_idx, pos < MOE.capacity(cfg, x.shape[1]))
    return y, aux, keep.reshape(eidx.shape), torch.sum(y ** 2) + aux


def run_moe_rank(mesh: ProcessMesh, device, cfg: ModelConfig, p, x,
                 fsdp: bool) -> Dict[str, Any]:
    """One ``moe_block`` on this rank: ``p`` (one layer's whole MoE
    parameters) and ``x`` (B, S, d) whole, cut here to this rank's block
    and rows; the gradient of this rank's loss, sum(y ** 2) + aux, with
    respect to x and every parameter it holds. Over data ranks the aux is
    the whole batch's (its means global), so that the ranks' gradients,
    summed over the data ranks, are those of sum(y ** 2) + aux on the
    whole batch."""
    rules = tp_rules(expert_parallel=True, fsdp=fsdp,
                     axis_sizes=mesh.axis_sizes, mesh=mesh)
    coords = {a: mesh.coordinate(a) for a in mesh.axis_names}
    mine, xb = rank_block(cfg, ("params", "batch"),
                          (None, rules.spec(("batch", None, None))),
                          (p, x), rules, coords, structure=moe_spec(cfg))
    mine = {k: t.to(device).requires_grad_(True) for k, t in mine.items()}
    xb = xb.to(device).requires_grad_(True)
    collectives.reset()
    with use_rules(rules):
        y, aux, keep, loss = moe_loss(mine, xb, cfg)
    forward = collectives.collective_bytes()
    names = sorted(mine)
    grads = torch.autograd.grad(loss, [xb] + [mine[k] for k in names])
    return dict(y=y.detach(), aux=aux.detach(), keep=keep, x=xb.detach(),
                grad_x=grads[0], grads=dict(zip(names, grads[1:])),
                held={k: t.detach() for k, t in mine.items()},
                forward=forward, total=collectives.collective_bytes(),
                calls=collectives.collective_calls())


JOBS = {"plan": run_plan_rank, "moe": run_moe_rank}


def to_cpu(tree):
    """A copy of a tree of tensors (dicts, lists, tuples) on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [to_cpu(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            type(tree)(items)
    return tree


def _rank_main(rank: int, world: int, run_dir: str, backend: str,
               device: str, desc: MeshDesc) -> None:
    """One rank: join the group and the mesh, run the jobs of
    ``run_dir/jobs.pt``, save the results to ``run_dir/rank<r>.pt``."""
    run = Path(run_dir)
    if device == "cpu":
        # the ranks share the host's cores, and often with other work: one
        # intra-op thread a rank keeps them from oversubscribing it
        torch.set_num_threads(1)
    try:
        dev = distributed.init_process_group(
            backend, rank, world, f"file://{run / 'store'}", device)
        mesh = ProcessMesh(desc, dev.type)
        jobs = torch.load(run / "jobs.pt", weights_only=False)
        out = []
        for name, kw in jobs:
            out.append(to_cpu(JOBS[name](mesh, dev, **kw)))
            if dev.type == "cuda":
                # what this job held goes back to the card, which the
                # other ranks may share
                gc.collect()
                torch.cuda.empty_cache()
        torch.save(out, run / f"rank{rank}.pt")
    except BaseException:
        (run / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        distributed.shutdown()


def run_ranks(desc: MeshDesc, jobs: Sequence[Tuple[str, dict]], *,
              backend: str, device: str, run_dir, timeout: float) -> list:
    """Run ``jobs`` ((name in ``JOBS``, keyword arguments) each, in order)
    on one process a rank of ``desc`` (spawned; rank r at ``coordinates
    (desc, r)``), joined over ``backend`` through a ``file://`` store in
    ``run_dir`` (empty, the caller's own). Returns each rank's list of
    results, on the CPU. A rank that fails or does not finish within
    ``timeout`` seconds stops the others and raises here."""
    import torch.multiprocessing as mp
    run = Path(run_dir)
    run.mkdir(parents=True, exist_ok=True)
    torch.save(list(jobs), run / "jobs.pt")
    world = desc.size
    ctx = mp.start_processes(_rank_main, args=(world, str(run), backend,
                                               device, desc),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"run_ranks: {world} ranks did not finish in "
                    f"{timeout} s")
    except BaseException as e:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
        for proc in ctx.processes:
            proc.join(10)
        errs = "".join(f.read_text() for f in sorted(run.glob("rank*.err")))
        if errs:
            raise RuntimeError(f"run_ranks: a rank failed:\n{errs}") from e
        raise
    return [torch.load(run / f"rank{r}.pt", weights_only=False)
            for r in range(world)]

"""Training step + loop.

Same functions as ``repro/training/train.py``: ``jax.value_and_grad``
becomes ``torch.autograd.grad`` over detached copies of the parameter
leaves, the scan over microbatches a Python loop (the sum of f32
per-micro gradients divided by n, the mean of the losses). The step is
functional, as the reference's: it returns new params and optimizer
state and modifies neither input. On the card attention runs the
hand-written flash kernel and its gradient kernel.

Across ranks the reference's GSPMD program is spelled out: each rank
differentiates its share of the global loss (``models/model.py``), the
tensor-parallel collectives carry their transposes
(``launch/collectives.py``), the gradients are summed over the data
ranks once a step (``_sum_over_data``) and the clip's norm over the
ranks that cut a leaf (``_sq_norm``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import collectives
from repro_torch.models import partitioning
from repro_torch.models.model import train_forward
from repro_torch.models.params import (attn_spec, flatten, leaves,
                                       map_tree, param_structure, unflatten)
from repro_torch.training.optimizer import AdamW, AdamWState


def make_train_step(cfg: ModelConfig, opt: AdamW, remat: bool = True,
                    num_microbatches: int = 1, loss_chunk: int = 0,
                    grad_specs=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).

    num_microbatches > 1 accumulates gradients over that many slices of
    the batch. grad_specs: optional tree of partition specs matching
    params (``params.param_pspecs``); with microbatches, each
    micro-gradient and the accumulator are constrained to it leaf by
    leaf through ``partitioning._constrain``, as the reference pins its
    accumulator to the ZeRO shards. In one process that is a no-op.

    Across ranks (a rank mesh in the current rules: ``_process_mesh``)
    ``params`` and ``opt_state`` are this rank's blocks and ``batch`` its
    rows, microbatch by microbatch (``launch/ranks.py`` cuts them); the
    step returns this rank's blocks of the reference's step on the whole
    batch.
    """
    whole = [tuple(s.shape) for s in flatten(param_structure(cfg))]

    def _constrain(tree):
        if grad_specs is None:
            return tree
        specs = leaves(grad_specs)
        if len(specs) != len(leaves(tree)):
            raise ValueError(f"grad_specs: {len(specs)} specs for "
                             f"{len(leaves(tree))} gradient leaves")
        it = iter(specs)
        return map_tree(lambda g: partitioning._constrain(g, next(it)),
                        tree)

    def value_and_grad(params, batch):
        live = map_tree(lambda t: t.detach().requires_grad_(True), params)
        total, metrics = train_forward(live, cfg, batch, remat=remat,
                                       loss_chunk=loss_chunk)
        flat = leaves(live)
        gs = torch.autograd.grad(total, flat, allow_unused=True)
        it = iter([torch.zeros_like(p) if g is None else g
                   for p, g in zip(flat, gs)])
        metrics = {k: v.detach() for k, v in metrics.items()}
        return metrics, map_tree(lambda _: next(it), params)

    def train_step(params, opt_state: AdamWState, batch: Dict[str, Any]):
        mesh = _process_mesh(cfg)
        ranks = partitioning.data_ranks()
        if num_microbatches <= 1:
            metrics, grads = value_and_grad(params, batch)
            grads = _sum_over_data(grads, ranks)
        else:
            n = num_microbatches
            dev = leaves(params)[0].device
            g_sum = _constrain(map_tree(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=dev), params))
            l_sum = torch.zeros((), device=dev)
            a_sum = torch.zeros((), device=dev)
            for i in range(n):
                mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                      for k, v in batch.items()}
                m, g = value_and_grad(params, mb)
                it = iter(leaves(_constrain(g)))
                g_sum = _constrain(
                    map_tree(lambda a: a + next(it).float(), g_sum))
                l_sum = l_sum + m["loss"]
                a_sum = a_sum + m["aux"]
            grads = map_tree(lambda g: g / n, _sum_over_data(g_sum, ranks))
            metrics = {"loss": l_sum / n, "aux": a_sum / n}
        if mesh is None:
            new_params, new_state = opt.update(grads, opt_state, params)
        else:
            new_params, new_state = opt.update(
                grads, opt_state, params, sq_norm=_sq_norm(whole, grads, mesh))
        return new_params, new_state, dict(metrics)

    return train_step


def _process_mesh(cfg: ModelConfig):
    """The live process mesh of the current rules (a ``CountingMesh`` on
    the meta device), or None in one process.

    Across ranks the step runs under the baseline rules (tensor
    parallelism over 'model', data parallelism over the batch axes) for
    the dense decoders, for MoE-TP (each expert's 'ff' over 'model') and
    for the SSM block on each rank's heads (mamba2, jamba), and under the
    expert-parallel rules; it raises where a part is not ported: fsdp's
    ZeRO-3 training across data ranks, and the encoder-decoder under
    tensor parallelism."""
    rules = partitioning.current_rules()
    mesh = getattr(rules, "mesh", None)
    if mesh is None or not hasattr(mesh, "coordinate"):
        return None
    if rules.rules.get("embed") is not None and rules.size("batch") > 1:
        raise NotImplementedError(
            f"train_step: the fsdp rules split the batch "
            f"{rules.size('batch')} ways over {rules.rules.get('batch')}: "
            f"fsdp's ZeRO-3 training across data ranks is not ported "
            f"(ROADMAP.md Queue 1 item 4.3)")
    if cfg.encoder is not None:
        partitioning.refuse_cut(
            "train_step", functools.partial(attn_spec, cfg, cross=True),
            "training the encoder-decoder (whisper) under tensor "
            "parallelism (item 4.1)")
    return mesh


def _sum_over_data(grads, ranks):
    """The gradients summed over the data ranks (``partitioning.
    data_ranks``; every leaf is replicated over them): one all-reduce of
    a flat buffer a dtype, in the gradients' dtype."""
    if ranks is None:
        return grads
    flat = flatten(grads)
    out = list(flat)
    by_dtype: Dict[torch.dtype, list] = {}
    for i, g in enumerate(flat):
        by_dtype.setdefault(g.dtype, []).append(i)
    for idx in by_dtype.values():
        buf = collectives.all_reduce(
            torch.cat([flat[i].reshape(-1) for i in idx]), *ranks)
        for i, part in zip(idx, buf.split([flat[i].numel() for i in idx])):
            out[i] = part.view(flat[i].shape)
    return unflatten(grads, out)


def _sq_norm(whole, grads, mesh) -> torch.Tensor:
    """The squared global norm of gradients of which some leaves are this
    rank's blocks (shapes below the whole tree's ``whole``, cut over
    'model' by tensor parallelism or by the expert axis): their sum is
    all-reduced over that axis, the whole leaves counted once."""
    rules = partitioning.current_rules()
    tp = partitioning.tensor_parallel(rules)
    axis = tp.axis if tp is not None else rules.rules["expert"]
    own, shared = [], []
    for shape, g in zip(whole, flatten(grads)):
        (shared if tuple(g.shape) == shape else own).append(
            torch.sum(torch.square(g.float())))
    total = sum(shared)
    if own:
        total = total + collectives.all_reduce(sum(own), mesh, axis)
    return total


def train_loop(cfg: ModelConfig, params, batches, *,
               opt: Optional[AdamW] = None, remat: bool = False):
    """Simple training loop over an iterable of batches."""
    opt = opt or AdamW()
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, remat=remat)
    losses = []
    for batch in batches:
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
    return params, opt_state, losses

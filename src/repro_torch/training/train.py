"""Training step + loop.

Same functions as ``repro/training/train.py``: ``jax.value_and_grad``
becomes ``torch.autograd.grad`` over detached copies of the parameter
leaves, the scan over microbatches a Python loop (the sum of f32
per-micro gradients divided by n, the mean of the losses). The step is
functional, as the reference's: it returns new params and optimizer
state and modifies neither input. On the card attention runs the
hand-written flash kernel and its gradient kernel.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import collectives
from repro_torch.models import partitioning
from repro_torch.models.model import train_forward
from repro_torch.models.params import flatten, leaves, map_tree, \
    param_structure
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
    """
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
        if num_microbatches <= 1:
            metrics, grads = value_and_grad(params, batch)
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
            grads = map_tree(lambda g: g / n, g_sum)
            metrics = {"loss": l_sum / n, "aux": a_sum / n}
        if mesh is None:
            new_params, new_state = opt.update(grads, opt_state, params)
        else:
            new_params, new_state = opt.update(
                grads, opt_state, params, sq_norm=_sq_norm(cfg, grads, mesh))
        return new_params, new_state, dict(metrics)

    return train_step


def _process_mesh(cfg: ModelConfig):
    """The live process mesh of the current rules, or None in one process.

    Across ranks the step runs at 1 x ep only: every rank holds the same
    rows and computes the same loss, and the expert-parallel branch's
    exchanges leave each rank the whole gradient of every leaf it holds
    (``launch/collectives.py``). Over data ranks the gradients of the
    leaves they share would have to be summed, which nothing does yet;
    under tensor parallelism (a dense leaf cut over 'model') the
    collectives' transposes are missing too: both raise."""
    partitioning.refuse_cut(
        "train_step", lambda: {f"leaf {i}": s for i, s in enumerate(
            flatten(param_structure(cfg)))},
        "training across ranks (the data-parallel gradient reduction and "
        "TP's transposes)")
    rules = partitioning.current_rules()
    mesh = getattr(rules, "mesh", None)
    if mesh is None or not hasattr(mesh, "group"):
        return None
    if rules.size("batch") > 1:
        raise NotImplementedError(
            f"train_step: the batch split {rules.size('batch')} ways over "
            f"{rules.rules.get('batch')}: the data-parallel gradient "
            f"reduction across ranks is not ported (ROADMAP.md Queue 1); "
            f"run the step on a mesh of 1 x ep")
    return mesh


def _sq_norm(cfg: ModelConfig, grads, mesh) -> torch.Tensor:
    """The squared global norm of gradients of which the expert leaves
    are this rank's blocks (shapes below the whole tree's): their sum is
    all-reduced over the expert axis, the whole leaves counted once."""
    rules = partitioning.current_rules()
    whole = [tuple(s.shape) for s in flatten(param_structure(cfg))]
    own, shared = [], []
    for shape, g in zip(whole, flatten(grads)):
        (shared if tuple(g.shape) == shape else own).append(
            torch.sum(torch.square(g.float())))
    total = sum(shared)
    if own:
        total = total + collectives.all_reduce(sum(own), mesh,
                                               rules.rules["expert"])
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

"""AdamW over the port's parameter trees (dicts and lists of tensors).

Same arithmetic as ``repro/training/optimizer.py``, step for step: the
global-norm clip in f32 (the squared norms summed over the leaves in
``jax.tree.leaves``'s order, ``params.flatten``), the warm-up schedule on
the incremented step, bias correction ``1 - b ** step`` in f32, and
decoupled weight decay on the f32 parameter cast back to its dtype. The
moments are f32; ``update`` returns new trees and modifies nothing.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.models.params import flatten, leaves, map_tree


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32
    mu: Any
    nu: Any


class AdamW(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        def zeros():
            return map_tree(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                  device=x.device), params)
        dev = leaves(params)[0].device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                          zeros(), zeros())

    def schedule(self, step):
        warm = torch.clamp((step + 1) / self.warmup_steps, max=1.0)
        return self.lr * warm

    def update(self, grads, state: AdamWState, params, *,
               sq_norm=None) -> Tuple[Any, AdamWState]:
        """sq_norm: the gradients' squared global norm, where the caller
        holds only a block of some leaves and has summed across ranks
        (``training/train.py``); None sums this tree's leaves."""
        # global-norm clip
        if sq_norm is None:
            sq_norm = sum(torch.sum(torch.square(g.float()))
                          for g in flatten(grads))
        gnorm = torch.sqrt(sq_norm)
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        grads = map_tree(lambda g: g.float() * scale, grads)

        step = state.step + 1
        lr = self.schedule(step)
        b1c = 1.0 - torch.pow(self.b1, step.float())
        b2c = 1.0 - torch.pow(self.b2, step.float())

        mu = _map2(lambda m, g: self.b1 * m + (1 - self.b1) * g,
                   state.mu, grads)
        nu = _map2(lambda v, g: self.b2 * v + (1 - self.b2) * g * g,
                   state.nu, grads)

        def upd(p, m, v):
            mhat = m / b1c
            vhat = v / b2c
            delta = mhat / (torch.sqrt(vhat) + self.eps) + \
                self.weight_decay * p.float()
            return (p.float() - lr * delta).to(p.dtype)

        it = iter(zip(leaves(mu), leaves(nu)))
        new_params = map_tree(lambda p: upd(p, *next(it)), params)
        return new_params, AdamWState(step, mu, nu)


def _map2(fn, a, b):
    """``fn`` over the paired leaves of two trees of one structure."""
    it = iter(leaves(b))
    return map_tree(lambda x: fn(x, next(it)), a)

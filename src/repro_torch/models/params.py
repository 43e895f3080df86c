"""Parameter structure: single source of truth for shapes.

``param_structure(cfg)`` returns the same tree of ``ParamSpec`` as
``repro/models/params.py`` (nested dicts, a list of per-pattern-position
blocks, and the stacked leading ``layers`` dim that the reference adds for
``lax.scan``); ``init_params`` materialises it as a dict of tensors,
``abstract_params`` as tensors on the ``meta`` device (shapes and dtypes
only, for the dry-run), and ``param_pspecs`` maps it to partition specs.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models.partitioning import (PartitionSpec, ShardingRules,
                                             logical_to_pspec)
from repro_torch.runtime import resolve_device


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # 'normal' | 'zeros' | 'ones' | 'ssm_a'


# tuples that are leaves of a tree, not nodes
_LEAF_TUPLES = (ParamSpec, PartitionSpec)


def map_tree(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a tree of dicts / lists / tuples."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(
            tree, _LEAF_TUPLES):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def leaves(tree) -> list:
    out: list = []
    map_tree(out.append, tree)
    return out


def flatten(tree) -> list:
    """The leaves of a tree in ``jax.tree.flatten``'s order: dict keys
    sorted, lists and tuples in order. ``leaves`` follows insertion
    order instead; a checkpoint's ``leaf_{i}`` and the optimizer's norm
    sum follow this one, so that they agree with the reference's."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (list, tuple)) and not isinstance(
            tree, _LEAF_TUPLES):
        return [x for v in tree for x in flatten(v)]
    return [tree]


def unflatten(like, flat) -> Any:
    """A tree shaped as ``like`` whose leaves are ``flat``, in
    ``flatten``'s order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            got = {k: build(t[k]) for k in sorted(t)}
            return {k: got[k] for k in t}
        if isinstance(t, (list, tuple)) and not isinstance(t, _LEAF_TUPLES):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def _stack(spec_tree, n: int):
    """Prepend a 'layers' dim to every leaf."""
    return map_tree(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.init),
        spec_tree)


def attn_spec(cfg: ModelConfig, cross: bool = False) -> Dict[str, ParamSpec]:
    d, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    out = {
        "norm": ParamSpec((d,), ("embed",), "ones"),
        "wq": ParamSpec((d, q), ("embed", "q")),
        "wk": ParamSpec((d, kv), ("embed", "kv")),
        "wv": ParamSpec((d, kv), ("embed", "kv")),
        "wo": ParamSpec((q, d), ("q", "embed")),
    }
    if cross:
        out.update({
            "xnorm": ParamSpec((d,), ("embed",), "ones"),
            "xwq": ParamSpec((d, q), ("embed", "q")),
            "xwk": ParamSpec((d, kv), ("embed", "kv")),
            "xwv": ParamSpec((d, kv), ("embed", "kv")),
            "xwo": ParamSpec((q, d), ("q", "embed")),
        })
    return out


def mlp_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "norm": ParamSpec((d,), ("embed",), "ones"),
        "wi": ParamSpec((d, f), ("embed", "ff")),      # up
        "wg": ParamSpec((d, f), ("embed", "ff")),      # gate
        "wo": ParamSpec((f, d), ("ff", "embed")),      # down
    }


def moe_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    return {
        "norm": ParamSpec((d,), ("embed",), "ones"),
        "router": ParamSpec((d, e), ("embed", None)),
        "wi": ParamSpec((e, d, f), ("expert", "embed", "ff")),
        "wg": ParamSpec((e, d, f), ("expert", "embed", "ff")),
        "wo": ParamSpec((e, f, d), ("expert", "ff", "embed")),
    }


def ssm_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    ssm = cfg.ssm
    d = cfg.d_model
    inner = ssm.inner_dim(d)
    nh = ssm.n_heads(d)
    n = ssm.state_dim
    conv_dim = inner + 2 * n
    return {
        "norm": ParamSpec((d,), ("embed",), "ones"),
        "w_in": ParamSpec((d, 2 * inner + 2 * n + nh), ("embed", "inner")),
        "conv_w": ParamSpec((ssm.conv_width, conv_dim), (None, "inner")),
        "conv_b": ParamSpec((conv_dim,), ("inner",), "zeros"),
        "a_log": ParamSpec((nh,), ("heads",), "ssm_a"),
        "d_skip": ParamSpec((nh,), ("heads",), "ones"),
        "dt_bias": ParamSpec((nh,), ("heads",), "zeros"),
        "out_norm": ParamSpec((inner,), ("inner",), "ones"),
        "w_out": ParamSpec((inner, d), ("inner", "embed")),
    }


def block_spec(cfg: ModelConfig, spec: LayerSpec) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if spec.mixer in ("attn", "swa"):
        out["attn"] = attn_spec(cfg, cross=cfg.encoder is not None)
    elif spec.mixer == "ssm":
        out["ssm"] = ssm_spec(cfg)
    if spec.ffn == "mlp":
        out["mlp"] = mlp_spec(cfg)
    elif spec.ffn == "moe":
        out["moe"] = moe_spec(cfg)
    return out


def encoder_layer_spec(cfg: ModelConfig) -> Dict[str, Any]:
    return {"attn": attn_spec(cfg), "mlp": mlp_spec(cfg)}


def param_structure(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    tree: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed")),
        "final_norm": ParamSpec((d,), ("embed",), "ones"),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamSpec((d, cfg.vocab), ("embed", "vocab"))
    tree["blocks"] = [
        _stack(block_spec(cfg, s), cfg.n_repeats) for s in cfg.pattern
    ]
    if cfg.encoder is not None:
        tree["encoder"] = {
            "layers": _stack(encoder_layer_spec(cfg), cfg.encoder.n_layers),
            "final_norm": ParamSpec((d,), ("embed",), "ones"),
            "pos_embed": ParamSpec((cfg.encoder.n_ctx, d), (None, "embed")),
        }
    if cfg.frontend is not None:
        tree["projector"] = ParamSpec(
            (cfg.frontend.feature_dim, d), (None, "embed"))
    return tree


def abstract_params(cfg: ModelConfig, dtype=torch.bfloat16
                    ) -> Dict[str, Any]:
    """The parameter tree as ``meta`` tensors: shapes and dtypes, no
    storage (the reference's ``ShapeDtypeStruct`` tree)."""
    return map_tree(
        lambda s: torch.empty(s.shape, dtype=dtype, device="meta"),
        param_structure(cfg))


def param_pspecs(cfg: ModelConfig, rules: Optional[ShardingRules]):
    """The parameter tree's partition specs: each leaf's logical axes
    through ``rules``."""
    return map_tree(lambda s: logical_to_pspec(s.axes, rules),
                    param_structure(cfg))


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda", dtype=torch.float32,
                cut: Optional[Callable[[ParamSpec], Optional[tuple]]] = None
                ) -> Dict[str, Any]:
    """Materialise random parameter values on ``device``.

    Same distributions as the reference (normal with std 1/sqrt(fan_in),
    ones, zeros, log-uniform A), drawn from ``generator`` (which must live
    on ``device``; a seed-0 one is made when None). The values differ
    from the reference's: to compare the two packages, convert the
    reference's parameters with ``repro_torch.convert``. Stacked leaves
    are drawn one layer at a time so the f32 draw of a full-width model
    never holds more than one layer's temporary.

    cut: maps a leaf's spec to the index of the block to keep (a tuple of
    slices over its dims), or None to keep it whole. Every leaf is still
    drawn in full, layer by layer, so a block holds the values of the
    whole tree's block (``launch/ranks.py``: a rank keeps only its
    experts under the expert-parallel rules, and its block of every leaf
    the tensor-parallel axis cuts under the baseline rules).
    """
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def draw(shape, fan_in):
        std = 1.0 / np.sqrt(max(fan_in, 1))
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * std).to(dtype)

    def mk(spec: ParamSpec):
        idx = cut(spec) if cut is not None else None

        def keep(t):
            return t if idx is None else t[idx].clone()

        if spec.init == "zeros":
            return keep(torch.zeros(spec.shape, dtype=dtype, device=dev))
        if spec.init == "ones":
            return keep(torch.ones(spec.shape, dtype=dtype, device=dev))
        if spec.init == "ssm_a":
            u = torch.rand(spec.shape, generator=generator, device=dev,
                           dtype=torch.float32) * (math.e - 1.0) + 1.0
            return keep(torch.log(u).to(dtype))
        shape = spec.shape
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        if spec.axes[0] == "layers" and len(shape) >= 3:
            if idx is None:
                out = torch.empty(shape, dtype=dtype, device=dev)
                for i in range(shape[0]):
                    out[i] = draw(shape[1:], fan_in)
                return out
            rows = range(shape[0])[idx[0]]
            out = torch.empty(torch.empty(shape, device="meta")[idx].shape,
                              dtype=dtype, device=dev)
            for i in range(shape[0]):
                layer = draw(shape[1:], fan_in)    # every layer: one stream
                if i in rows:
                    out[rows.index(i)] = layer[idx[1:]]
            return out
        return keep(draw(shape, fan_in))

    return map_tree(mk, param_structure(cfg))


def count_params(params) -> int:
    return sum(int(np.prod(x.shape)) for x in leaves(params))

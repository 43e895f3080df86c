"""Dry-run step builders: (step_fn, abstract args, partition specs) per
(architecture x input shape).

The reference's builders (``repro/launch/specs.py``) with ``meta``
tensors in place of ``ShapeDtypeStruct``: the abstract arguments have
the reference's shapes and dtypes and no storage, so a whole step runs
on them shape by shape and allocates nothing. The same builders drive
real execution when given concrete tensors on a device: ``case.fn``
calls the port's entry points, whatever device its arguments lie on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.model import decode_forward, prefill_forward
from repro_torch.models.params import abstract_params, map_tree, param_pspecs
from repro_torch.models.partitioning import P, ShardingRules, use_rules
from repro_torch.models.transformer import cache_pspecs, make_caches
from repro_torch.training.optimizer import AdamW, AdamWState
from repro_torch.training.train import make_train_step

# default microbatching for the train_4k shape (global_batch=256):
# micro=16 keeps per-micro logits (16 x 4096 x vocab f32) within HBM.
TRAIN_MICROBATCHES = 16


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _text_and_mm(cfg: ModelConfig, shape: InputShape) -> Tuple[int, int]:
    """Split the input shape's seq_len into (text_tokens, mm_tokens)."""
    if cfg.frontend is not None and cfg.encoder is None:
        n_mm = min(cfg.frontend.tokens_per_item, shape.seq_len // 2)
        return shape.seq_len - n_mm, n_mm
    return shape.seq_len, 0


def train_inputs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    b = shape.global_batch
    s_text, n_mm = _text_and_mm(cfg, shape)
    batch = {
        "tokens": _meta((b, s_text), torch.int32),
        "labels": _meta((b, s_text), torch.int32),
    }
    if n_mm:
        batch["mm_embeds"] = _meta((b, n_mm, cfg.frontend.feature_dim),
                                   torch.bfloat16)
    if cfg.encoder is not None:
        batch["enc_frames"] = _meta(
            (b, cfg.encoder.n_ctx, cfg.frontend.feature_dim), torch.bfloat16)
    return batch


def batch_pspecs(batch: Dict[str, Any], rules: ShardingRules):
    out = {}
    for k, v in batch.items():
        axes = ("batch",) + (None,) * (len(v.shape) - 1)
        out[k] = rules.spec(axes)
    return out


@dataclasses.dataclass
class DryrunCase:
    """One (arch x shape) case."""
    fn: Any                       # the step: runs on meta or real tensors
    args: Tuple[Any, ...]         # abstract (meta) args
    in_specs: Tuple[Any, ...]     # partition-spec trees matching args
    # the arguments the reference donates to its step (kept as metadata:
    # the port's steps write caches in place and return new params)
    donate: Tuple[int, ...] = ()


def train_plan(rules: ShardingRules, shape: InputShape):
    """(num_microbatches, loss_chunk) for a train case under these rules.

    FSDP variants spread the batch wide and ZeRO-3 weights re-gather per
    microbatch — so they run few/one microbatch(es) and bound logits with
    chunked CE instead. The MoE hybrid (batch on 'data' only) keeps 4
    microbatches to cap saved-activation memory while amortizing gathers.
    """
    bsz = rules.size("batch")
    if bsz >= shape.global_batch:            # dense FSDP: 1 row / device
        return 1, 512
    if rules.size("embed") > 1:              # ZeRO-3 hybrid (MoE)
        return 4, 512
    # baseline TP: each microbatch must still shard over the batch axes
    # (multi-pod: 32-way), else the sanitizer replicates the whole batch
    n_micro = min(TRAIN_MICROBATCHES, max(shape.global_batch // bsz, 1))
    return n_micro, 512 if n_micro < TRAIN_MICROBATCHES else 0


def build_case(cfg: ModelConfig, shape: InputShape,
               rules: ShardingRules, *, kv_dtype=None) -> DryrunCase:
    params = abstract_params(cfg, torch.bfloat16)
    p_specs = param_pspecs(cfg, rules)

    if shape.kind == "train":
        opt = AdamW()
        opt_state = AdamWState(
            _meta((), torch.int32),
            map_tree(lambda x: _meta(x.shape, torch.float32), params),
            map_tree(lambda x: _meta(x.shape, torch.float32), params))
        o_specs = AdamWState(P(), p_specs, p_specs)
        batch = train_inputs(cfg, shape)
        b_specs = batch_pspecs(batch, rules)
        n_micro, loss_chunk = train_plan(rules, shape)
        # under ZeRO-style weight sharding, pin the grad accumulator to the
        # param shards so per-micro grads reduce-scatter instead of
        # all-reducing at full size
        grad_specs = p_specs if (rules.size("embed") > 1 and n_micro > 1) \
            else None
        step = make_train_step(cfg, opt, remat=True,
                               num_microbatches=n_micro,
                               loss_chunk=loss_chunk,
                               grad_specs=grad_specs)

        def fn(params, opt_state, batch):
            with use_rules(rules):
                return step(params, opt_state, batch)

        return DryrunCase(fn, (params, opt_state, batch),
                          (p_specs, o_specs, b_specs), donate=(0, 1))

    if shape.kind == "prefill":
        b = shape.global_batch
        s_text, n_mm = _text_and_mm(cfg, shape)
        caches = make_caches(cfg, b, shape.seq_len, dtype=torch.bfloat16,
                             device="meta")
        c_specs = cache_pspecs(cfg, rules)
        tokens = _meta((b, s_text), torch.int32)
        lengths = _meta((b,), torch.int32)
        mm = (_meta((b, n_mm, cfg.frontend.feature_dim), torch.bfloat16)
              if n_mm else None)
        enc = (_meta((b, cfg.encoder.n_ctx, cfg.frontend.feature_dim),
                     torch.bfloat16) if cfg.encoder is not None else None)

        def fn(params, tokens, lengths, caches, mm_embeds, enc_frames):
            with use_rules(rules):
                return prefill_forward(params, cfg, tokens, caches,
                                       lengths=lengths, mm_embeds=mm_embeds,
                                       enc_frames=enc_frames)

        bspec = rules.spec(("batch", None))
        mm_spec = rules.spec(("batch", None, None)) if mm is not None else None
        enc_spec = (rules.spec(("batch", None, None)) if enc is not None
                    else None)
        return DryrunCase(
            fn, (params, tokens, lengths, caches, mm, enc),
            (p_specs, bspec, rules.spec(("batch",)), c_specs, mm_spec,
             enc_spec),
            donate=(3,))

    # decode
    b = shape.global_batch
    caches = make_caches(cfg, b, shape.seq_len, dtype=torch.bfloat16,
                         device="meta", for_decode=True, kv_dtype=kv_dtype)
    c_specs = cache_pspecs(cfg, rules)
    tokens = _meta((b,), torch.int32)

    def fn(params, tokens, caches):
        with use_rules(rules):
            return decode_forward(params, cfg, tokens, caches)

    return DryrunCase(fn, (params, tokens, caches),
                      (p_specs, rules.spec(("batch",)), c_specs),
                      donate=(2,))


def decode_supported(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    """Returns a skip reason, or None if the (arch x shape) pair runs.

    long_500k requires sub-quadratic decode memory: pure full-attention
    archs are skipped; SSM / SSM-dominant hybrid / SWA run.
    """
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention decode at 524k KV is out of scope "
                "(no sliding-window/block-sparse variant for this arch)")
    return None

"""Analytic FLOP / HBM-byte estimates per (arch x shape).

The reference's analytic model of its own forward and backward
(``repro/launch/analytic.py``), with the same formulas, so that a share
of the card's peak is read against the same count on both sides: FLOPs
and bytes come from the config and the shape alone, independent of how
the step is split into kernels or devices. Conventions:

* FLOPs: 2 per MAC; attention is causal (x0.5 of the full square), capped
  by the sliding window where present; MoE counts top-k x capacity-factor
  experts; backward = 2x forward; remat re-runs forward (total 4x fwd).
* HBM bytes (per device): parameters are streamed once per (micro)batch
  pass, KV/SSM caches read+written, activations ~12 residual-stream
  passes per layer, logits in f32. Attention score tiles are assumed to
  stay on chip (the flash kernel keeps them in shared memory and
  registers); a plain attention would write them to device memory, which
  is precisely the traffic the kernel removes.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import InputShape, ModelConfig


@dataclass
class Estimate:
    flops_global: float
    hbm_bytes_per_device: float


def _attn_ctx(cfg: ModelConfig, shape: InputShape) -> float:
    """Mean attended context per query token."""
    if shape.kind in ("train", "prefill"):
        full = shape.seq_len / 2.0                     # causal mean
        if cfg.sliding_window:
            return min(full, cfg.sliding_window)
        return full
    # decode: one token attends the whole cache (or window)
    kv = shape.seq_len
    if cfg.sliding_window:
        kv = min(kv, cfg.sliding_window)
    return kv


def forward_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """Global forward FLOPs for one step of this shape."""
    tokens = shape.global_batch * (
        shape.seq_len if shape.kind in ("train", "prefill") else 1)
    # matmul flops over active params (embeds excluded from matmul cost,
    # lm head included)
    n_embed = cfg.vocab * cfg.d_model
    head = n_embed if not cfg.tie_embeddings else cfg.vocab * cfg.d_model
    n_mat = cfg.active_param_count() - n_embed - head + head
    f = 2.0 * n_mat * tokens
    # attention quadratic term
    n_attn = len(cfg.attn_layers)
    if n_attn and cfg.n_heads:
        ctx = _attn_ctx(cfg, shape)
        f += 4.0 * n_attn * tokens * ctx * cfg.q_dim
        if cfg.encoder is not None:   # cross-attention over encoder ctx
            f += 4.0 * cfg.n_layers * tokens * cfg.encoder.n_ctx * cfg.q_dim
            # encoder itself (only when frames are consumed)
            if shape.kind in ("train", "prefill"):
                enc_tokens = shape.global_batch * cfg.encoder.n_ctx
                enc_params = 4 * cfg.d_model ** 2 + 2 * cfg.d_model * cfg.d_ff
                f += 2.0 * cfg.encoder.n_layers * enc_params * enc_tokens
                f += 4.0 * cfg.encoder.n_layers * enc_tokens \
                    * cfg.encoder.n_ctx * cfg.q_dim
    # SSD scan: per token per ssm layer ~ (6 inner N) for state update/out
    # + chunk-quadratic intra-chunk term amortized ~ (2 L N + 2 L P) ~ small
    if cfg.ssm is not None and cfg.ssm_layers:
        inner = cfg.ssm.inner_dim(cfg.d_model)
        nh = cfg.ssm.n_heads(cfg.d_model)
        per_tok = 6.0 * nh * cfg.ssm.head_dim * cfg.ssm.state_dim
        if shape.kind in ("train", "prefill"):
            per_tok += 4.0 * cfg.ssm.chunk_size * (
                cfg.ssm.state_dim + cfg.ssm.head_dim)
        f += len(cfg.ssm_layers) * per_tok * tokens
    return f


def step_flops(cfg: ModelConfig, shape: InputShape) -> float:
    fwd = forward_flops(cfg, shape)
    if shape.kind == "train":
        return 4.0 * fwd            # fwd + bwd(2x) + remat re-fwd(1x)
    return fwd


def cache_bytes(cfg: ModelConfig, shape: InputShape, decode_clamp: bool,
                kv_elem_bytes: int = 2) -> float:
    """Global KV + SSM cache size for this shape."""
    b = shape.global_batch
    s = shape.seq_len
    total = 0.0
    n_attn = len(cfg.attn_layers)
    if n_attn:
        eff = s
        if decode_clamp and cfg.sliding_window and \
                all(sp.mixer != "attn" for sp in cfg.pattern):
            eff = min(s, cfg.sliding_window)
        total += n_attn * b * eff * 2 * cfg.kv_dim * kv_elem_bytes
    if cfg.ssm is not None and cfg.ssm_layers:
        nh = cfg.ssm.n_heads(cfg.d_model)
        total += len(cfg.ssm_layers) * b * (
            nh * cfg.ssm.head_dim * cfg.ssm.state_dim * 4       # f32 state
            + (cfg.ssm.conv_width - 1) * (
                cfg.ssm.inner_dim(cfg.d_model) + 2 * cfg.ssm.state_dim) * 2)
    if cfg.encoder is not None:
        total += cfg.n_layers * b * cfg.encoder.n_ctx * 2 * cfg.kv_dim * 2
    return total


def step_hbm_bytes(cfg: ModelConfig, shape: InputShape, n_chips: int,
                   num_microbatches: int = 1,
                   kv_elem_bytes: int = 2) -> float:
    """Per-device HBM traffic for one step."""
    p_bytes = cfg.param_count() * 2                 # bf16, sharded
    tokens = shape.global_batch * (
        shape.seq_len if shape.kind in ("train", "prefill") else 1)
    act = 12.0 * cfg.n_layers * tokens * cfg.d_model * 2
    if shape.kind == "train":
        # params re-streamed per microbatch x (fwd + remat-fwd + bwd)
        traffic = p_bytes * num_microbatches * 3
        traffic += act * 3
        # grads f32 rw + adam state rw
        traffic += cfg.param_count() * 4 * 4
        logits = tokens * cfg.vocab * 4 / max(num_microbatches, 1) \
            * num_microbatches  # each micro writes+reads its logits once
        traffic += logits * 2
    elif shape.kind == "prefill":
        traffic = p_bytes + act
        traffic += cache_bytes(cfg, shape, False, kv_elem_bytes)  # cache write
        traffic += shape.global_batch * cfg.vocab * 4
    else:
        traffic = p_bytes + act
        traffic += cache_bytes(cfg, shape, True, kv_elem_bytes)   # cache read
        traffic += shape.global_batch * cfg.vocab * 4
    return traffic / n_chips

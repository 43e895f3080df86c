"""Decoder backbone: caches, input embedding, the layer loop, LM head.

Same functions as ``repro/models/transformer.py`` for decoders of
attention (full or sliding-window) and Mamba2 (SSM) mixers with gated
MLP, top-k MoE or no ffn, and for the encoder-decoder (whisper-class:
``run_encoder`` and cross-attention over a slot-indexed cross-KV cache).
The reference's ``lax.scan`` over pattern repeats (and over encoder
layers) becomes a Python loop over ``r`` that hands each layer its slice
of the stacked parameters and cache views; the views are written in
place. With ``remat`` each repeat runs under activation checkpointing,
the reference's ``jax.checkpoint`` of its scan body.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.params import attn_spec, mlp_spec
from repro_torch.models.partitioning import (current_rules, kv_heads_cut,
                                             logical_to_pspec, refuse_cut,
                                             shard, tensor_parallel,
                                             use_rules)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def make_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                dtype=torch.float32, kv_dtype=None, device="cpu",
                for_decode: bool = False, layout: str = "dense",
                page_size: int = 16, n_pages: int = 0,
                with_attn: bool = True) -> Dict[str, Any]:
    """Cache dict for serving, one "attn" and one "ssm" entry per pattern
    position (None where the mixer has no such state).

    for_decode=True clamps dense sliding-window caches to the window (a
    ring buffer); prefill-capable caches keep max_len so a whole prompt
    fits. The paged layout is never clamped: the window is enforced by
    masking.

    kv_dtype: storage dtype of the attention K/V only (e.g.
    torch.float8_e4m3fn), default ``dtype``; SSM state and conv tails
    keep ``dtype``, kv_pos stays int32.

    layout="paged": attention KV lives in a shared pool of ``n_pages``
    physical pages of ``page_size`` tokens (page 0 is the trash page) and
    the dict grows a "pages" block table (batch, max_len // page_size).
    SSM state and the cross-KV stay slot-indexed in either layout.
    with_attn=False leaves the attention entries None (side state only,
    for a caller that swaps in its own pool).

    An encoder-decoder's "cross" is a CrossCache: K/V (n_repeats,
    batch, n_ctx, nkv, hd) in ``dtype`` (not ``kv_dtype``: an fp8 pool
    leaves the cross-KV wide) and enc_pos (n_repeats, batch, n_ctx)
    int32, -1 in a slot that no request has filled; None otherwise.
    """
    kv_dtype = kv_dtype or dtype
    paged = layout == "paged"
    if paged:
        if max_len % page_size:
            raise ValueError(
                f"max_len {max_len} not a multiple of page_size {page_size}")
        if n_pages < 2:
            raise ValueError("paged layout needs n_pages >= 2 "
                             "(page 0 is the reserved trash page)")
    attn, ssm = [], []
    for spec in cfg.pattern:
        if spec.mixer == "ssm":
            attn.append(None)
            ssm.append(SSM.make_ssm_cache(cfg, cfg.n_repeats, batch, dtype,
                                          device))
            continue
        ssm.append(None)
        if not with_attn:
            attn.append(None)
        elif paged:
            attn.append(L.make_paged_attn_cache(
                cfg, cfg.n_repeats, n_pages, page_size, kv_dtype, device))
        else:
            window = (cfg.sliding_window
                      if spec.mixer == "swa" and for_decode else None)
            attn.append(L.make_attn_cache(cfg, cfg.n_repeats, batch, max_len,
                                          window, kv_dtype, device))
    cross = None
    if cfg.encoder is not None:
        kshape = (cfg.n_repeats, batch, cfg.encoder.n_ctx, cfg.n_kv_heads,
                  cfg.head_dim)
        cross = L.CrossCache(
            torch.zeros(kshape, dtype=dtype, device=device),
            torch.zeros(kshape, dtype=dtype, device=device),
            torch.full(kshape[:3], -1, dtype=torch.int32, device=device))
    caches = {"attn": tuple(attn), "ssm": tuple(ssm), "cross": cross,
              "len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if paged:
        caches["pages"] = torch.zeros((batch, max_len // page_size),
                                      dtype=torch.int32, device=device)
    return caches


def cache_pspecs(cfg: ModelConfig, rules, layout: str = "dense"
                 ) -> Dict[str, Any]:
    """Partition specs matching ``make_caches``' structure.

    KV-cache sharding adapts per arch: heads when n_kv_heads divides the
    model axis (classic TP), else the sequence dim (flash-decode style) —
    e.g. smollm's kv=3 or glm4's kv=2 cannot split 16 ways by head.
    layout="paged": the pool's page axis takes the role of the sequence
    axis (pages spread flash-decode style); the block table and lengths
    stay batch-sharded.
    """
    lp = logical_to_pspec
    paged = layout == "paged"
    head_ok = kv_heads_cut(rules, cfg.n_kv_heads)
    seq_pref = rules is not None and rules.size("kv_seq") > 1
    if paged:
        # (repeats, n_pages, page, nkv, hd)
        kv_axes = ("layers", "kv_seq", None,
                   "kv_heads" if head_ok else None, None)
        pos_axes = None
    elif rules is not None and not head_ok and not seq_pref:
        # fall back to sequence sharding on whatever axis 'kv_heads' used
        kv_axes = ("layers", "batch", "kv_heads", None, None)
        pos_axes = ("layers", "batch", "kv_heads")
    else:
        kv_axes = ("layers", "batch", "kv_seq",
                   "kv_heads" if head_ok else None, None)
        pos_axes = ("layers", "batch", "kv_seq")
    attn, ssm = [], []
    for spec in cfg.pattern:
        if spec.mixer in ("attn", "swa"):
            kv = lp(kv_axes, rules)
            if paged:
                attn.append(L.PagedAttnCache(kv, kv))
            else:
                attn.append(L.AttnCache(kv, kv, lp(pos_axes, rules)))
            ssm.append(None)
        elif spec.mixer == "ssm":
            st = lp(("layers", "batch", "act_heads", None, None), rules)
            cv = lp(("layers", "batch", None, "act_inner"), rules)
            attn.append(None)
            ssm.append(SSM.SSMCache(st, cv))
        else:
            attn.append(None)
            ssm.append(None)
    cross = None
    if cfg.encoder is not None:
        kv = lp(("layers", "batch", None, "kv_heads", None), rules)
        cross = L.CrossCache(kv, kv, lp(("layers", "batch", None), rules))
    specs = {"attn": tuple(attn), "ssm": tuple(ssm), "cross": cross,
             "len": lp(("batch",), rules)}
    if paged:
        specs["pages"] = lp(("batch", None), rules)
    return specs


def reset_caches(caches) -> None:
    """Write back, in place, what ``make_caches`` puts in a fresh cache:
    zeros, and -1 (empty slot) in every ``kv_pos`` and in enc_pos."""
    for e in (*caches["attn"], *caches["ssm"], caches.get("cross")):
        if e is not None:
            for name, t in zip(e._fields, e):
                t.fill_(-1 if name in ("kv_pos", "enc_pos") else 0)
    caches["len"].zero_()
    if caches.get("pages") is not None:
        caches["pages"].zero_()


def clone_caches(caches) -> Dict[str, Any]:
    """A cache dict of copies of every tensor of ``caches``."""
    def entry(e):
        return None if e is None else type(e)(*(t.clone() for t in e))

    out = dict(caches, attn=tuple(map(entry, caches["attn"])),
               ssm=tuple(map(entry, caches["ssm"])),
               len=caches["len"].clone())
    if caches.get("cross") is not None:
        out["cross"] = entry(caches["cross"])
    if caches.get("pages") is not None:
        out["pages"] = caches["pages"].clone()
    return out


def cache_tensors(caches) -> list:
    """Every tensor of a cache dict (the reference's ``jax.tree.leaves``)."""
    out = []
    for e in (*caches["attn"], *caches["ssm"], caches.get("cross")):
        if e is not None:
            out.extend(e)
    out.append(caches["len"])
    if caches.get("pages") is not None:
        out.append(caches["pages"])
    return out


# ---------------------------------------------------------------------------
# Embedding / input merge
# ---------------------------------------------------------------------------

def embed_inputs(params, cfg: ModelConfig, tokens,
                 mm_embeds: Optional[torch.Tensor] = None):
    """tokens: (B, S_text) int; mm_embeds: (B, n_mm, feature_dim) or None.

    Multimodal embeddings are projected to d_model and PREPENDED to the
    text sequence. Returns (x (B, S, d), positions (B, S) int32).
    """
    x = embed_tokens(params, cfg, tokens)
    if mm_embeds is not None:
        mm = mm_embeds.to(x.dtype) @ params["projector"]
        x = torch.cat([mm, x], dim=1)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).repeat(b, 1)
    return shard(x, "batch", None, "act_embed"), positions


def embed_tokens(params, cfg: ModelConfig, tokens):
    """The embedding rows of ``tokens``; under tensor parallelism a
    rank's lookup of its rows of the table, summed over the ranks where
    'vocab' cuts them."""
    tp = tensor_parallel()
    if tp is None:
        return params["embed"][tokens.long()]
    return tp.embed(params["embed"], tokens.long(), cfg.vocab)


def scatter_mm_features(x, positions, mm_feats, mm_start):
    """Overwrite image-token positions of the embedding stream with
    projected multimodal features (the Encode-stage E->P hand-off).

    x: (B, S, d); positions: (B, S) ABSOLUTE positions; mm_feats:
    (B, n_mm, d) already projected; mm_start: int or (B,) position of the
    first image token. Positions outside [mm_start, mm_start + n_mm) keep
    their text embeddings.
    """
    n_mm = mm_feats.shape[1]
    start = torch.as_tensor(mm_start, dtype=torch.int32, device=x.device)
    if start.dim() == 0:
        start = start.expand(x.shape[0])
    rel = positions - start[:, None]                  # (B, S)
    valid = (rel >= 0) & (rel < n_mm)
    idx = torch.clamp(rel, 0, n_mm - 1).long()[..., None].expand(
        -1, -1, x.shape[2])
    gathered = torch.gather(mm_feats.to(device=x.device, dtype=x.dtype), 1,
                            idx)
    return torch.where(valid[..., None], gathered, x)


def lm_logits(params, cfg: ModelConfig, h):
    """The logits of ``h``; under tensor parallelism this rank's block of
    the vocabulary where 'vocab' cuts the head, ``h`` entering its
    product through ``TensorParallel.enter``."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    tp = tensor_parallel()
    if tp is not None and tp.cut("vocab", cfg.vocab):
        h = tp.enter(h)
    return shard(h @ w.to(h.dtype), "batch", None, "act_vocab")


# ---------------------------------------------------------------------------
# Encoder (whisper-style)
# ---------------------------------------------------------------------------

def run_encoder(params, cfg: ModelConfig, frames):
    """frames: (B, T, feature_dim) stub embeddings -> ((B, T, d_model),
    positions (B, T) int32). Non-causal self-attention in every layer."""
    refuse_cut("run_encoder", lambda: {**attn_spec(cfg), **{
        "mlp " + k: sp for k, sp in mlp_spec(cfg).items()}},
        "the encoder-decoder (whisper) under tensor parallelism (item 4.1)")
    enc = params["encoder"]
    x = frames.to(params["projector"].dtype) @ params["projector"]
    x = x + enc["pos_embed"][None, :x.shape[1]].to(x.dtype)
    b, t = x.shape[:2]
    positions = torch.arange(t, dtype=torch.int32,
                             device=x.device).repeat(b, 1)
    for r in range(cfg.encoder.n_layers):
        x, _ = L.attention_block(
            {k: w[r] for k, w in enc["layers"]["attn"].items()}, x,
            positions, cfg, causal=False)
        x = L.mlp_block({k: w[r] for k, w in enc["layers"]["mlp"].items()},
                        x, cfg)
    return L.rms_norm(x, enc["final_norm"], cfg.norm_eps), positions


# ---------------------------------------------------------------------------
# Decoder stack
# ---------------------------------------------------------------------------

def run_decoder(params, cfg: ModelConfig, x, positions, *,
                caches: Optional[Dict[str, Any]] = None,
                enc_out=None, remat: bool = False, prefix_len=None,
                pos_base=None):
    """Run all decoder layers.

    caches: cache dict from make_caches (serving) or None (no cache).
    enc_out: (enc_hidden, enc_pos) of an encoder-decoder's prefill; each
    layer's cross-KV is computed from it and written into
    ``caches["cross"]`` (when given) at its repeat. A decode step reads
    the cross-KV from there instead.
    remat: run each repeat of the layer loop under
    ``torch.utils.checkpoint`` (non-reentrant), as the reference wraps its
    scan body in ``jax.checkpoint``: the backward recomputes the repeat's
    activations, the flash forward kernel included, instead of keeping
    them. For training (caches None).
    prefix_len / pos_base: paged suffix prefill against a cached prefix
    (see layers.attention_block).
    Returns (h, new_caches, aux_loss): aux_loss is the MoE layers' summed
    load-balance loss (f32 scalar); the cache tensors are updated in place
    and the returned dict shares them.
    """
    cur_len = caches["len"] if caches is not None else None
    pages = caches.get("pages") if caches is not None else None
    attn_cls = L.PagedAttnCache if pages is not None else L.AttnCache
    decode = caches is not None and x.shape[1] == 1

    def repeat(h, aux, r):
        for i, spec in enumerate(cfg.pattern):
            p = params["blocks"][i]
            if spec.mixer in ("attn", "swa"):
                window = cfg.sliding_window if spec.mixer == "swa" else None
                c = caches["attn"][i] if caches is not None else None
                pa = {kk: t[r] for kk, t in p["attn"].items()}
                h, _ = L.attention_block(
                    pa, h, positions, cfg, window=window,
                    cache=tuple(t[r] for t in c) if c is not None else None,
                    cur_len=cur_len, pages=pages,
                    prefix_len=prefix_len, pos_base=pos_base)
                if cfg.encoder is not None:
                    cross = caches["cross"] if caches is not None else None
                    if decode:
                        ckv = tuple(t[r] for t in cross)
                    else:
                        ckv = L.compute_cross_kv(pa, *enc_out, cfg)
                        if cross is not None:
                            # T frames into n_ctx slots: the rest stay
                            # empty, as the reference pads them on insert
                            t = ckv[0].shape[1]
                            for dst, src, fill in zip(cross, ckv, (0, 0, -1)):
                                dst[r, :, :t].copy_(src)
                                dst[r, :, t:].fill_(fill)
                    h = L.cross_attention_block(pa, h, positions, ckv, cfg)
            elif spec.mixer == "ssm":
                c = caches["ssm"][i] if caches is not None else None
                h, _ = SSM.ssm_block(
                    {kk: t[r] for kk, t in p["ssm"].items()}, h, cfg,
                    cache=(c.state[r], c.conv[r]) if c is not None else None,
                    positions=positions)
            if spec.ffn == "mlp":
                h = L.mlp_block({kk: t[r] for kk, t in p["mlp"].items()}, h,
                                cfg)
            elif spec.ffn == "moe":
                h, a = MOE.moe_block({kk: t[r] for kk, t in p["moe"].items()},
                                     h, cfg)
                aux = aux + a
        return h, aux

    rules = current_rules()

    def recompute(h, aux, r):
        # the backward may recompute on another thread (autograd's device
        # thread on CUDA), where the thread-local rules are unset: the
        # expert-parallel branch must be taken there too
        with use_rules(rules):
            return repeat(h, aux, r)

    h = x
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(cfg.n_repeats):
        if remat:
            h, aux = checkpoint(recompute, h, aux, r, use_reentrant=False)
        else:
            h, aux = repeat(h, aux, r)

    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)

    new_caches = None
    if caches is not None:
        step = 1 if decode else positions.shape[1]
        new_caches = {
            "attn": tuple(attn_cls(*c) if c is not None else None
                          for c in caches["attn"]),
            "ssm": caches["ssm"], "cross": caches["cross"],
            "len": caches["len"] + step,
        }
        if pages is not None:
            new_caches["pages"] = pages
    return h, new_caches, aux

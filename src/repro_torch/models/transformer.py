"""Decoder backbone: caches, input embedding, the layer loop, LM head.

Same functions as ``repro/models/transformer.py`` for attention-only
decoders with gated MLPs. The reference's ``lax.scan`` over pattern
repeats becomes a Python loop over ``r`` that hands each layer its slice
of the stacked parameters and cache views; the views are written in
place. SSM mixers, MoE ffns and encoder-decoder models raise
``NotImplementedError`` (still to port, see ROADMAP.md).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

_TODO = "not ported yet (see ROADMAP.md, Queue 1)"


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the model features this port does not run yet."""
    if cfg.encoder is not None:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder / cross-attention {_TODO}")
    for spec in cfg.pattern:
        if spec.mixer not in ("attn", "swa"):
            raise NotImplementedError(f"{cfg.name}: {spec.mixer} mixer {_TODO}")
        if spec.ffn not in ("mlp", "none"):
            raise NotImplementedError(f"{cfg.name}: {spec.ffn} ffn {_TODO}")


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def make_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                dtype=torch.float32, device="cpu", layout: str = "dense",
                page_size: int = 16, n_pages: int = 0,
                with_attn: bool = True) -> Dict[str, Any]:
    """Cache dict for serving, one "attn" entry per pattern position.

    layout="paged": attention KV lives in a shared pool of ``n_pages``
    physical pages of ``page_size`` tokens (page 0 is the trash page) and
    the dict grows a "pages" block table (batch, max_len // page_size).
    with_attn=False leaves the attention entries None (side state only,
    for a caller that swaps in its own pool).
    """
    check_supported(cfg)
    paged = layout == "paged"
    if paged:
        if max_len % page_size:
            raise ValueError(
                f"max_len {max_len} not a multiple of page_size {page_size}")
        if n_pages < 2:
            raise ValueError("paged layout needs n_pages >= 2 "
                             "(page 0 is the reserved trash page)")
    attn = []
    for spec in cfg.pattern:
        if not with_attn:
            attn.append(None)
        elif paged:
            attn.append(L.make_paged_attn_cache(
                cfg, cfg.n_repeats, n_pages, page_size, dtype, device))
        else:
            attn.append(L.make_attn_cache(cfg, cfg.n_repeats, batch, max_len,
                                          dtype, device))
    caches = {"attn": tuple(attn), "ssm": tuple(None for _ in cfg.pattern),
              "cross": None,
              "len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if paged:
        caches["pages"] = torch.zeros((batch, max_len // page_size),
                                      dtype=torch.int32, device=device)
    return caches


def cache_tensors(caches) -> list:
    """Every tensor of a cache dict (the reference's ``jax.tree.leaves``)."""
    out = []
    for e in caches["attn"]:
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
    x = params["embed"][tokens.long()]
    if mm_embeds is not None:
        mm = mm_embeds.to(x.dtype) @ params["projector"]
        x = torch.cat([mm, x], dim=1)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).repeat(b, 1)
    return x, positions


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
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w.to(h.dtype)


# ---------------------------------------------------------------------------
# Decoder stack
# ---------------------------------------------------------------------------

def run_decoder(params, cfg: ModelConfig, x, positions, *,
                caches: Optional[Dict[str, Any]] = None,
                prefix_len=None, pos_base=None):
    """Run all decoder layers.

    caches: cache dict from make_caches (serving) or None (no cache).
    prefix_len / pos_base: paged suffix prefill against a cached prefix
    (see layers.attention_block).
    Returns (h, new_caches, aux_loss); the cache tensors are updated in
    place and the returned dict shares them.
    """
    check_supported(cfg)
    cur_len = caches["len"] if caches is not None else None
    pages = caches.get("pages") if caches is not None else None
    attn_cls = L.PagedAttnCache if pages is not None else L.AttnCache
    decode = caches is not None and x.shape[1] == 1
    h = x
    for r in range(cfg.n_repeats):
        for i, spec in enumerate(cfg.pattern):
            p = params["blocks"][i]
            if spec.mixer in ("attn", "swa"):
                window = cfg.sliding_window if spec.mixer == "swa" else None
                c = caches["attn"][i] if caches is not None else None
                h, _ = L.attention_block(
                    {kk: t[r] for kk, t in p["attn"].items()}, h, positions,
                    cfg, window=window,
                    cache=tuple(t[r] for t in c) if c is not None else None,
                    cur_len=cur_len, pages=pages,
                    prefix_len=prefix_len, pos_base=pos_base)
            if spec.ffn == "mlp":
                h = L.mlp_block({kk: t[r] for kk, t in p["mlp"].items()}, h,
                                cfg)

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
    return h, new_caches, torch.zeros((), dtype=torch.float32,
                                      device=x.device)

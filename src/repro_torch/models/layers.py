"""Core transformer layers: RMSNorm, RoPE, GQA attention (full / sliding
window, prefill / decode, dense and paged caches), gated MLP.

Same functions as ``repro/models/layers.py``. Where the reference returns
new cache arrays, the port writes the cache views it is given in place
(the engine's caches are preallocated and reused) and returns the same
views. Attention goes through ``repro_torch.kernels.ops``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as K
from repro_torch.models.partitioning import shard

FP8 = K.FP8
# the largest magnitude that rounds into float8_e4m3fn (448 and the tie
# at 464 round to 448; 480 would be the NaN code)
_FP8_LIMIT = 464.0


def to_kv(x, dtype):
    """``x`` in the KV storage dtype ``dtype``: every value that enters a
    KV cache or pool goes through here. For float8_e4m3fn it is the
    reference's ``astype``: NaN (with x's sign) where |x| > 464 or x is
    infinite, round-to-nearest-even elsewhere; ``Tensor.to`` would
    saturate to +-448 instead. Any other dtype is a plain ``.to``. The
    cast goes through f32 (exact from bf16, so one rounding, as JAX's):
    CUDA's bf16 copysign or cast does not keep every NaN's sign."""
    if dtype == FP8 and x.dtype != FP8:
        x = x.float()
        x = torch.copysign(x.masked_fill(x.abs() > _FP8_LIMIT, float("nan")),
                           x)
    return x.to(dtype)


def rms_norm(x, w, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def rope(x, positions, theta: float):
    """x: (b, s, heads, head_dim), positions: (b, s) int32."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(theta, exps)      # scalar base: no host->device copy
    ang = positions[..., None].float() * freqs          # (b, s, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class AttnCache(NamedTuple):
    """Per-pattern-position stacked KV cache.

    k, v:    (repeats, batch, S, n_kv, head_dim)
    kv_pos:  (repeats, batch, S) int32, -1 = empty slot.
    """

    k: torch.Tensor
    v: torch.Tensor
    kv_pos: torch.Tensor


class CrossCache(NamedTuple):
    """Stacked cross-attention K/V of an encoder-decoder, slot-indexed.

    k, v:     (repeats, batch, n_ctx, n_kv, head_dim)
    enc_pos:  (repeats, batch, n_ctx) int32, -1 = empty slot.
    """

    k: torch.Tensor
    v: torch.Tensor
    enc_pos: torch.Tensor


def make_attn_cache(cfg: ModelConfig, n_repeats: int, batch: int,
                    max_len: int, window: Optional[int], dtype, device):
    """``window``: clamp the cache to it (a ring buffer), or None for
    ``max_len`` slots. ``dtype`` is the K/V storage dtype (fp8 included);
    kv_pos is int32."""
    s = min(max_len, window) if window else max_len
    kshape = (n_repeats, batch, s, cfg.n_kv_heads, cfg.head_dim)
    return AttnCache(torch.zeros(kshape, dtype=dtype, device=device),
                     torch.zeros(kshape, dtype=dtype, device=device),
                     torch.full((n_repeats, batch, s), -1, dtype=torch.int32,
                                device=device))


class PagedAttnCache(NamedTuple):
    """Per-pattern-position paged KV pool, shared by all decode slots.

    k, v: (repeats, n_pages, page_size, n_kv, head_dim). Physical page 0
    is the trash page: unmapped block-table entries point there, so stray
    writes never touch live pages, and nothing reads it as data.
    """

    k: torch.Tensor
    v: torch.Tensor


def make_paged_attn_cache(cfg: ModelConfig, n_repeats: int, n_pages: int,
                          page_size: int, dtype, device):
    """``dtype`` is the K/V storage dtype (fp8 included)."""
    shape = (n_repeats, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return PagedAttnCache(torch.zeros(shape, dtype=dtype, device=device),
                          torch.zeros(shape, dtype=dtype, device=device))


def _split_heads(x, n, hd):
    return x.reshape(x.shape[:-1] + (n, hd))


def compute_cross_kv(p, enc_out, enc_pos, cfg: ModelConfig):
    """Cross-attention K/V from the encoder output (once per request):
    (k, v (b, T, nkv, hd), enc_pos (b, T))."""
    k = _split_heads(enc_out @ p["xwk"], cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(enc_out @ p["xwv"], cfg.n_kv_heads, cfg.head_dim)
    return k, v, enc_pos


def cross_attention_block(p, x, positions, enc_kv, cfg: ModelConfig):
    """Cross-attention over precomputed encoder K/V; residual included.
    Non-causal, so flash takes every query, the single decode token too."""
    k, v, enc_pos = enc_kv
    h = rms_norm(x, p["xnorm"], cfg.norm_eps)
    q = _split_heads(h @ p["xwq"], cfg.n_heads, cfg.head_dim)
    q = shard(q, "batch", None, "act_heads", None)
    out = K.attention(q, k.to(q.dtype), v.to(q.dtype), positions, enc_pos,
                      causal=False)
    out = out.reshape(x.shape[0], x.shape[1], cfg.q_dim)
    return x + shard(out @ p["xwo"], "batch", None, "act_embed")


def attention_block(p, x, positions, cfg: ModelConfig, *, window=None,
                    cache: Optional[Tuple[torch.Tensor, ...]] = None,
                    cur_len: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    pages: Optional[torch.Tensor] = None,
                    prefix_len=None, pos_base=None):
    """One self-attention sub-block with residual.

    cache: per-repeat cache views. Dense: (k_cache, v_cache, kv_pos) —
      (b, S, nkv, hd) / (b, S); a single decode token is written at slot
      ``cur_len % S`` (ring buffer). A prefill fills the views from the
      start and clears the rest.
    pages: (b, max_pages) int32 block table — switches the cache to the
      PAGED layout: cache is (k_pool, v_pool) of shape (n_pages, page,
      nkv, hd). Decode writes one token into its slot's current page;
      prefill scatters the sequence's pages into the pool (pages past a
      slot's mapped ones land on the trash page 0).
    prefix_len / pos_base (ints): SUFFIX prefill against a cached prefix
      (batch 1). The first ``prefix_len`` tokens already sit in pool pages
      mapped by the block table; ``x`` holds the tokens from the
      page-aligned ``pos_base`` onward (entries below ``prefix_len`` are
      dummies with position -1). Queries attend to the gathered prefix
      plus the in-batch suffix; the scatter is masked per token so a
      copied-on-write partial page keeps its prefix tokens.
    The cache views are written in place. Returns (out, cache_views_or_None).
    """
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    # q/k/v are constrained on their HEAD axes (shard() leaves a head
    # count that the model axis does not divide whole)
    q = _split_heads(h @ p["wq"], cfg.n_heads, cfg.head_dim)
    q = shard(q, "batch", None, "act_heads", None)
    k = _split_heads(h @ p["wk"], cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(h @ p["wv"], cfg.n_kv_heads, cfg.head_dim)
    k = shard(k, "batch", None, "act_kv_heads", None)
    v = shard(v, "batch", None, "act_kv_heads", None)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    b = x.shape[0]

    new_cache = None
    if cache is not None and pages is not None:
        # ---- paged KV pool: (n_pages, page, nkv, hd) shared by slots ----
        ck, cv = cache
        page = ck.shape[1]
        if x.shape[1] == 1:
            # decode: write one token into the slot's current page. Slots
            # whose row is unmapped all write the trash page 0, where the
            # last writer wins, as in the reference.
            pos = cur_len.to(torch.int32)                           # (b,)
            pidx = torch.clamp(pos // page, 0, pages.shape[1] - 1)
            phys = torch.gather(pages, 1, pidx[:, None].long())[:, 0].long()
            off = (pos % page).long()
            ck[phys, off] = to_kv(k[:, 0], ck.dtype)
            cv[phys, off] = to_kv(v[:, 0], cv.dtype)
            new_cache = (ck, cv)
            out = K.paged_attention(q[:, 0], ck, cv, pages, pos + 1,
                                    window=window)[:, None]
        elif prefix_len is None:
            # prefill: scatter the (padded) sequence's pages into the pool
            S = k.shape[1]
            if S % page:
                raise ValueError(
                    f"paged prefill length {S} not a multiple of page {page}")
            npg = S // page
            if npg > pages.shape[1]:
                raise ValueError("prefill longer than block table")
            flat = pages[:, :npg].reshape(-1).long()
            ck[flat] = to_kv(k.reshape(b * npg, page, *k.shape[2:]), ck.dtype)
            cv[flat] = to_kv(v.reshape(b * npg, page, *v.shape[2:]), cv.dtype)
            new_cache = (ck, cv)
            # attends over the unrounded k/v, as the reference does
            out = K.attention(q, k, v, positions, positions, window=window)
        else:
            # ---- suffix prefill against a cached prefix (batch 1) ----
            S = k.shape[1]
            if S % page:
                raise ValueError(
                    f"paged prefill length {S} not a multiple of page {page}")
            if b != 1:
                raise ValueError("suffix prefill is batch-1 only")
            npg = S // page
            width = pages.shape[1]
            # jax.lax.dynamic_slice clamps its start so the slice stays in
            # bounds; reproduce that
            start = min(max(int(pos_base) // page, 0), width - npg)
            flat = pages[:, start:start + npg].reshape(-1).long()
            kp = to_kv(k.reshape(b * npg, page, *k.shape[2:]), ck.dtype)
            vp = to_kv(v.reshape(b * npg, page, *v.shape[2:]), cv.dtype)
            # token-masked scatter: dummy positions (the CoW page's copied
            # prefix tokens and the right padding) keep the pool's values
            keep = (positions >= 0).reshape(b * npg, page)[..., None, None]
            ck[flat] = torch.where(keep, kp, ck[flat])
            cv[flat] = torch.where(keep, vp, cv[flat])
            new_cache = (ck, cv)
            # gather the cached prefix through the whole block-table row
            # (in q's dtype: an fp8 pool is widened here, flash never
            # reads fp8); slots at/after prefix_len are masked out
            row = pages.reshape(-1).long()
            pk = ck[row].reshape(b, width * page, *k.shape[2:])
            pv = cv[row].reshape(b, width * page, *v.shape[2:])
            span = torch.arange(width * page, dtype=torch.int32,
                                device=x.device)[None]
            pfx_pos = torch.where(span < int(prefix_len), span,
                                  torch.full_like(span, -1))
            k_all = torch.cat([pk.to(q.dtype), k], dim=1)
            v_all = torch.cat([pv.to(q.dtype), v], dim=1)
            kv_pos = torch.cat([pfx_pos.expand(b, width * page), positions],
                               dim=1).contiguous()
            out = K.attention(q, k_all, v_all, positions, kv_pos,
                              window=window)
    elif cache is not None:
        ck, cv, cpos = cache
        S = ck.shape[1]
        if x.shape[1] == 1:
            # ---- decode: write one token into the ring buffer ----
            slot = (cur_len % S).long()                        # (b,)
            bidx = torch.arange(b, device=x.device)
            ck[bidx, slot] = to_kv(k[:, 0], ck.dtype)
            cv[bidx, slot] = to_kv(v[:, 0], cv.dtype)
            cpos[bidx, slot] = positions[:, 0].to(torch.int32)
            new_cache = (ck, cv, cpos)
            # the decode kernel reads an fp8 cache as it is (the reference
            # casts the whole cache to q's dtype first: the same function)
            kv = (ck, cv) if ck.dtype == FP8 else (ck.to(q.dtype),
                                                   cv.to(q.dtype))
            out = K.attention(q, *kv, positions, cpos, window=window)
        else:
            # ---- prefill into cache (serving): seq fits the buffer ----
            s = k.shape[1]
            if S - s < 0:
                raise ValueError("prefill longer than cache")
            ck[:, :s] = to_kv(k, ck.dtype)
            ck[:, s:] = 0
            cv[:, :s] = to_kv(v, cv.dtype)
            cv[:, s:] = 0
            cpos[:, :s] = positions
            cpos[:, s:] = -1
            new_cache = (ck, cv, cpos)
            out = K.attention(q, k, v, positions, positions, window=window)
    else:
        # ---- training / encoder: no cache ----
        out = K.attention(q, k, v, positions, positions, window=window,
                          causal=causal)

    out = out.reshape(x.shape[0], x.shape[1], cfg.q_dim)
    out = shard(out @ p["wo"], "batch", None, "act_embed")
    return x + out, new_cache


def mlp_block(p, x, cfg: ModelConfig):
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    up = shard(h @ p["wi"], "batch", None, "act_ff")
    gate = shard(h @ p["wg"], "batch", None, "act_ff")
    out = (F.silu(gate) * up) @ p["wo"]
    return x + shard(out, "batch", None, "act_embed")

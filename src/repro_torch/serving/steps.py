"""Per-instance step functions: encode / prefill / decode / insert / page
movement.

Same steps as ``repro/serving/steps.py``. PyTorch runs eagerly, so there
is no ``jit``. Every step whose reference donates its cache argument
(``donate_argnums``) writes the given cache or pool tensors IN PLACE here
and returns the same tensors: the paged and suffix prefill (pool
pages), decode (the cache views), the paged and dense insert (the
destination cache), the cross-engine page copy, the swap-in scatter and
the copy-on-write page copy. A caller keeps using its tensors after the
call; one that needs the old contents (the swap-out gather) takes a copy
first.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import decode_forward, prefill_forward
from repro_torch.serving.sampling import sample


def _attn_pairs(dst_attn, src_attn):
    """(dst, src) tensor pairs of two attention-cache tuples."""
    for d, s in zip(dst_attn, src_attn):
        if d is not None:
            yield from zip(d, s)


def make_prefill_fn(cfg: ModelConfig, prefix: bool = False):
    """Prefill step.

    Dense: fills the fresh batch-1 cache it is given. Paged: ``caches``
    holds the engine's pool under "attn" (written in place by the page
    scatter; the reference donates it), a fresh batch-1 side state for
    "ssm"/"cross"/"len", and the request's staging block-table row under
    "pages".

    prefix=True is the SUFFIX variant over that paged dict: ``tokens``
    holds only the uncached tail of the prompt (from the page-aligned
    ``pos_base``; entries before ``prefix_len`` are dummies) and the
    block-table row already maps the shared prefix pages. The same step
    is the CHUNK step of chunked prefill (``lengths`` = the chunk's end).
    """
    if prefix:
        def prefill_suffix_fn(params, tokens, lengths, caches, prefix_len,
                              pos_base, mm_feats=None, mm_start=None):
            return prefill_forward(
                params, cfg, tokens, caches, lengths=lengths,
                prefix_len=prefix_len, pos_base=pos_base,
                mm_feats=mm_feats, mm_start=mm_start)

        return prefill_suffix_fn

    def prefill_fn(params, tokens, lengths, caches, mm_embeds=None,
                   enc_frames=None, mm_feats=None, mm_start=None):
        if enc_frames is not None:
            raise NotImplementedError(
                "encoder-decoder prefill not ported yet (see ROADMAP.md)")
        return prefill_forward(params, cfg, tokens, caches, lengths=lengths,
                               mm_embeds=mm_embeds, mm_feats=mm_feats,
                               mm_start=mm_start)

    return prefill_fn


def make_encode_fn(cfg: ModelConfig):
    """Encode-stage forward: stub patch embeddings through the real
    learned projector -> d_model-wide features, float32 so store
    round-trips (and recompute on the Prefill side) stay bit-identical."""

    def encode_fn(params, patches):
        proj = params["projector"]
        feats = patches.to(device=proj.device, dtype=proj.dtype) @ proj
        return feats.float()

    return encode_fn


def make_decode_fn(cfg: ModelConfig, temperature: float = 0.0):
    """Decode step: writes the new token's KV into ``caches`` in place and
    returns (next tokens (B,) int32, the updated cache dict)."""

    def decode_fn(params, tokens, caches, generator=None):
        logits, new_caches = decode_forward(params, cfg, tokens, caches)
        return sample(logits, generator, temperature), new_caches

    return decode_fn


def make_paged_insert_fn(cfg: ModelConfig):
    """Attach a prefilled request to slot ``slot`` of a PAGED decode cache.

    The attention KV is not touched — its pages are already in the pool
    (same-engine hand-off) or were copied by ``make_page_copy_fn``; this
    writes the slot's block-table row and length in place.
    """

    def insert_fn(side, dst_caches, table_row, slot: int):
        lens, pages = dst_caches["len"], dst_caches["pages"]
        lens[slot] = side["len"][0].to(lens.device)
        pages[slot] = table_row.to(device=pages.device, dtype=pages.dtype)
        return dst_caches

    return insert_fn


def make_page_copy_fn():
    """Cross-engine P->D page movement: gather the request's pages from
    the source pool and write them into the destination pool's allocated
    pages, in place. O(one request's pages)."""

    def copy_fn(src_attn, dst_attn, src_ids, dst_ids):
        for dst, src in _attn_pairs(dst_attn, src_attn):
            dst[:, dst_ids.to(dst.device).long()] = src[
                :, src_ids.to(src.device).long()].to(dst.device, dst.dtype)
        return dst_attn

    return copy_fn


def make_page_gather_fn():
    """Pull a set of physical pages out of the pool: the device side of
    preemption swap-out. Returns new tensors (advanced indexing copies),
    one per pool tensor, for the caller to move to the host."""

    def gather_fn(attn, ids):
        ids = ids.long()
        return tuple(None if e is None else type(e)(*(t[:, ids] for t in e))
                     for e in attn)

    return gather_fn


def make_page_scatter_fn():
    """Write previously-swapped page KV back into freshly-allocated pool
    pages, in place: the device side of preemption swap-in (re-fault)."""

    def scatter_fn(attn, data, ids):
        for pool, d in _attn_pairs(attn, data):
            pool[:, ids.to(pool.device).long()] = d.to(pool.device,
                                                       pool.dtype)
        return attn

    return scatter_fn


def make_pool_page_copy_fn():
    """Same-pool page duplication, in place: the copy-on-write step of the
    prefix cache. Copies each ``src_ids[i]`` page onto ``dst_ids[i]``."""

    def copy_fn(attn, src_ids, dst_ids):
        for e in attn:
            if e is None:
                continue
            for pool in e:
                pool[:, dst_ids.to(pool.device).long()] = pool[
                    :, src_ids.to(pool.device).long()]
        return attn

    return copy_fn


def make_insert_fn(cfg: ModelConfig):
    """Copy one request's prefilled cache (batch 1) into batch slot
    ``slot`` of the dense decode cache, in place — the P->D hand-off on
    the Decode instance."""

    def ins(dst, src, slot):
        if src.dim() >= 3 and src.shape[2] != dst.shape[2]:
            pad = dst.shape[2] - src.shape[2]
            fill = -1 if src.dtype == torch.int32 else 0
            shape = list(src.shape)
            shape[2] = pad
            src = torch.cat([src, torch.full(shape, fill, dtype=src.dtype,
                                             device=src.device)], dim=2)
        dst[:, slot] = src[:, 0].to(dst.device, dst.dtype)

    def insert_fn(src_caches, dst_caches, slot: int):
        for dst, src in _attn_pairs(dst_caches["attn"], src_caches["attn"]):
            ins(dst, src, slot)
        dst_caches["len"][slot] = src_caches["len"][0].to(
            dst_caches["len"].device)
        return dst_caches

    return insert_fn

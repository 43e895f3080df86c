"""Per-instance step functions: encode / prefill / decode / insert / page
movement.

Same steps as ``repro/serving/steps.py``. The reference compiles each
step with ``jax.jit``; here the decode step (every cache layout) and the
dense whole-prompt prefill go through a ``GraphStep``
(``serving/graphs.py``), which captures them as CUDA graphs and replays
them on CUDA tensors, and runs them eagerly on CPU tensors. The other
steps run eagerly on either device: the paged whole-prompt prefill, the
suffix/chunk prefill (its ``prefix_len`` and ``pos_base`` are Python
ints that the attention code slices with), the inserts and the page
movements. Sampling stays outside the graph.

Every step whose reference donates its cache argument
(``donate_argnums``) writes the given cache or pool tensors IN PLACE
here and returns the same tensors: the paged and suffix prefill (pool
pages), decode (the cache views and the lengths), the paged and dense
insert (the destination cache), the cross-engine page copy, the swap-in
scatter and the copy-on-write page copy. A caller keeps using its
tensors after the call; one that needs the old contents (the swap-out
gather) takes a copy first. The dense prefill donates nothing in the
reference: it fills the cache it is given from scratch and returns
copies, so a payload it returned survives the next prefill.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import to_kv
from repro_torch.models.model import decode_forward, prefill_forward
from repro_torch.models.transformer import clone_caches, reset_caches
from repro_torch.serving.graphs import GraphStep
from repro_torch.serving.sampling import sample


def _pairs(dst_entries, src_entries):
    """(dst, src) tensor pairs of two per-pattern-position cache tuples
    ("attn" or "ssm"), skipping positions without that state."""
    for d, s in zip(dst_entries, src_entries):
        if d is not None:
            yield from zip(d, s)


def _len_in_place(caches, new):
    """Write a step's new lengths into ``caches["len"]`` and hand back
    ``new`` over that tensor: a CUDA graph reads and writes only the
    tensors it was captured over."""
    caches["len"].copy_(new["len"])
    new["len"] = caches["len"]
    return new


def make_prefill_fn(cfg: ModelConfig, prefix: bool = False):
    """Prefill step.

    Dense: fills the batch-1 cache it is given from scratch (the same
    cache every call, which a CUDA graph is captured over) and returns
    (logits, caches) as copies. Paged: ``caches`` holds the engine's pool
    under "attn" (written in place by the page scatter; the reference
    donates it), a fresh batch-1 side state for "ssm"/"cross"/"len", and
    the request's staging block-table row under "pages"; it runs
    eagerly. ``enc_frames`` (an encoder-decoder's raw frames) run through
    the encoder inside either step, whose cross-KV lands in "cross".

    prefix=True is the SUFFIX variant over that paged dict: ``tokens``
    holds only the uncached tail of the prompt (from the page-aligned
    ``pos_base``; entries before ``prefix_len`` are dummies) and the
    block-table row already maps the shared prefix pages. The same step
    is the CHUNK step of chunked prefill (``lengths`` = the chunk's end).
    It runs eagerly.
    """
    if prefix:
        def prefill_suffix_fn(params, tokens, lengths, caches, prefix_len,
                              pos_base, mm_feats=None, mm_start=None):
            return prefill_forward(
                params, cfg, tokens, caches, lengths=lengths,
                prefix_len=prefix_len, pos_base=pos_base,
                mm_feats=mm_feats, mm_start=mm_start)

        return prefill_suffix_fn

    def dense_prefill(params, caches, tokens, lengths, mm_embeds, enc_frames,
                      mm_feats, mm_start):
        reset_caches(caches)
        logits, new = prefill_forward(params, cfg, tokens, caches,
                                      lengths=lengths, mm_embeds=mm_embeds,
                                      enc_frames=enc_frames,
                                      mm_feats=mm_feats, mm_start=mm_start)
        return logits, _len_in_place(caches, new)

    graph = GraphStep(dense_prefill)

    def prefill_fn(params, tokens, lengths, caches, mm_embeds=None,
                   enc_frames=None, mm_feats=None, mm_start=None):
        if caches.get("pages") is not None:
            return prefill_forward(params, cfg, tokens, caches,
                                   lengths=lengths, mm_embeds=mm_embeds,
                                   enc_frames=enc_frames,
                                   mm_feats=mm_feats, mm_start=mm_start)
        if mm_start is not None:       # a device value, as jit traces it
            mm_start = torch.as_tensor(mm_start, dtype=torch.int32,
                                       device=tokens.device)
        # an encoder-decoder's frames are an input of the graph: the
        # encoder runs inside the captured prefill
        logits, new = graph((params, caches), tokens, lengths, mm_embeds,
                            enc_frames, mm_feats, mm_start)
        return logits.clone(), clone_caches(new)

    prefill_fn.graph = graph
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
    """Decode step: writes the new token's KV into ``caches`` and advances
    ``caches["len"]``, both in place, and returns (next tokens (B,)
    int32, the cache dict over the same tensors)."""

    def decode(params, caches, tokens):
        logits, new = decode_forward(params, cfg, tokens, caches)
        return logits, _len_in_place(caches, new)

    graph = GraphStep(decode)

    def decode_fn(params, tokens, caches, generator=None):
        logits, new = graph((params, caches), tokens)
        return sample(logits, generator, temperature), new

    decode_fn.graph = graph
    return decode_fn


def make_paged_insert_fn(cfg: ModelConfig):
    """Attach a prefilled request to slot ``slot`` of a PAGED decode cache.

    The attention KV is not touched — its pages are already in the pool
    (same-engine hand-off) or were copied by ``make_page_copy_fn``; this
    writes the slot's block-table row, length and slot-indexed side state
    (SSM state and conv tail, cross-KV) in place, so a replayed decode
    graph reads the new request's encoder K/V at the same addresses.
    """

    def insert_fn(side, dst_caches, table_row, slot: int):
        for dst, src in _pairs(dst_caches["ssm"], side["ssm"]):
            dst[:, slot] = src[:, 0].to(dst.device, dst.dtype)
        if dst_caches["cross"] is not None:
            for dst, src in zip(dst_caches["cross"], side["cross"]):
                dst[:, slot] = src[:, 0].to(dst.device, dst.dtype)
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
        for dst, src in _pairs(dst_attn, src_attn):
            dst[:, dst_ids.to(dst.device).long()] = to_kv(
                src[:, src_ids.to(src.device).long()], dst.dtype).to(
                    dst.device)
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
        for pool, d in _pairs(attn, data):
            pool[:, ids.to(pool.device).long()] = to_kv(d, pool.dtype).to(
                pool.device)
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
    the Decode instance. Every tensor is copied (attention KV, SSM state
    and conv tail, cross-KV, length), so the decode cache never aliases
    the prefill cache and a replayed decode graph reads the new request's
    state at the same addresses."""

    def ins(dst, src, slot):
        if src.dim() >= 3 and src.shape[2] != dst.shape[2]:
            pad = dst.shape[2] - src.shape[2]
            fill = -1 if src.dtype == torch.int32 else 0
            shape = list(src.shape)
            shape[2] = pad
            src = torch.cat([src, torch.full(shape, fill, dtype=src.dtype,
                                             device=src.device)], dim=2)
        dst[:, slot] = to_kv(src[:, 0], dst.dtype).to(dst.device)

    def insert_fn(src_caches, dst_caches, slot: int):
        for key in ("attn", "ssm"):
            for dst, src in _pairs(dst_caches[key], src_caches[key]):
                ins(dst, src, slot)
        if dst_caches["cross"] is not None:
            for dst, src in zip(dst_caches["cross"], src_caches["cross"]):
                ins(dst, src, slot)
        dst_caches["len"][slot] = src_caches["len"][0].to(
            dst_caches["len"].device)
        return dst_caches

    return insert_fn

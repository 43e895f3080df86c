"""Public model API: prefill and decode forwards against caches.

Same functions as ``repro/models/model.py`` (``prefill_forward``,
``decode_forward``); training (``train_forward``) is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def prefill_forward(params, cfg: ModelConfig, tokens, caches,
                    *, lengths: Optional[torch.Tensor] = None,
                    mm_embeds=None, enc_frames=None, prefix_len=None,
                    pos_base=None, mm_feats=None, mm_start=None):
    """Populate caches from a (padded) prompt batch.

    lengths: (B,) true prompt lengths (including mm tokens). Padded
    positions get position -1 so they are masked everywhere.
    prefix_len / pos_base (ints; paged suffix prefill, batch 1): the first
    ``prefix_len`` tokens are already cached in pool pages; ``tokens``
    holds only the slice from the page-aligned ``pos_base`` onward. The
    returned logits are still for the true last prompt token.
    mm_feats / mm_start: features already projected to d_model, (B, n_mm,
    d), scattered over the embedding stream at absolute positions
    [mm_start, mm_start + n_mm).
    enc_frames: (B, T, feature_dim) raw frames of an encoder-decoder,
    run through the encoder; its cross-KV goes into ``caches["cross"]``.
    Returns (last_token_logits (B, vocab) f32, new_caches).
    """
    x, positions = T.embed_inputs(params, cfg, tokens, mm_embeds)
    neg = torch.full((), -1, dtype=torch.int32, device=x.device)
    if prefix_len is not None:
        if lengths is None:
            raise ValueError("suffix prefill requires lengths")
        idx = torch.arange(x.shape[1], dtype=torch.int32,
                           device=x.device)[None]
        abspos = int(pos_base) + idx
        valid = (abspos >= int(prefix_len)) & (abspos < lengths[:, None])
        positions = torch.where(valid, abspos, neg)
    elif lengths is not None:
        idx = torch.arange(x.shape[1], dtype=torch.int32,
                           device=x.device)[None]
        positions = torch.where(idx < lengths[:, None], idx, neg)
    if mm_feats is not None:
        # padded/invalid positions are -1, hence rel < 0 -> untouched
        x = T.scatter_mm_features(x, positions, mm_feats, mm_start)
    enc_out = None
    if cfg.encoder is not None:
        enc_out = T.run_encoder(params, cfg, enc_frames)
    h, new_caches, _ = T.run_decoder(params, cfg, x, positions,
                                     caches=caches, enc_out=enc_out,
                                     prefix_len=prefix_len,
                                     pos_base=pos_base)
    if prefix_len is not None:
        last = torch.clamp(lengths - 1 - int(pos_base), min=0)
        new_caches["len"] = lengths
    elif lengths is not None:
        last = torch.clamp(lengths - 1, min=0)
        new_caches["len"] = lengths
    else:
        last = torch.full((x.shape[0],), x.shape[1] - 1, dtype=torch.int32,
                          device=x.device)
        new_caches["len"] = torch.full((x.shape[0],), x.shape[1],
                                       dtype=torch.int32, device=x.device)
    idx = last.long()[:, None, None].expand(-1, 1, h.shape[2])
    h_last = torch.gather(h, 1, idx)                       # (B, 1, d)
    logits = T.lm_logits(params, cfg, h_last)[:, 0]
    return logits.float(), new_caches


def decode_forward(params, cfg: ModelConfig, tokens, caches):
    """One decode step. tokens: (B,) previous tokens.

    Position of the new token is caches['len'] (per row). Returns
    (logits (B, vocab) f32, new_caches).
    """
    positions = caches["len"][:, None].to(torch.int32)          # (B, 1)
    x = params["embed"][tokens.long()[:, None]]
    h, new_caches, _ = T.run_decoder(params, cfg, x, positions,
                                     caches=caches)
    logits = T.lm_logits(params, cfg, h)[:, 0]
    return logits.float(), new_caches

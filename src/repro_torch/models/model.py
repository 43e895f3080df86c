"""Public model API: the training loss and the prefill and decode
forwards against caches.

Same functions as ``repro/models/model.py``: ``train_forward`` (the
causal-LM loss, no caches), ``prefill_forward`` and ``decode_forward``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import collectives
from repro_torch.models import transformer as T
from repro_torch.models.partitioning import (data_ranks, shard,
                                             tensor_parallel)


def _ce_loss(params, cfg: ModelConfig, h_text, targets):
    """Token-mean cross entropy; returns (sum_nll, n_valid), f32. Targets
    below 0 are padding: their nll is taken at index 0 and weighted 0
    (JAX's take_along_axis wraps -1 to the last index; either is 0).
    Where tensor parallelism cuts the logits over the vocabulary, the
    vocab-parallel form: the largest logit, the sum of exponentials and
    the target's logit each summed (the largest: maximised) over the
    ranks."""
    logits = T.lm_logits(params, cfg, h_text).float()
    idx = torch.clamp(targets.long(), min=0)
    mask = (targets >= 0).float()
    tp = tensor_parallel()
    if tp is None or not tp.cut("vocab", cfg.vocab):
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, idx[..., None])[..., 0]
        return torch.sum(nll * mask), torch.sum(mask)
    start, n = tp.block(cfg.vocab)
    top = collectives.all_reduce(logits.detach().amax(-1), tp.mesh, tp.axis,
                                 op="max")
    local = idx - start
    mine = (local >= 0) & (local < n)
    target = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])
    target = torch.where(mine, target[..., 0], 0.0)
    sums = collectives.tp_all_reduce(torch.stack(
        [torch.exp(logits - top[..., None]).sum(-1), target], -1),
        tp.mesh, tp.axis)
    nll = torch.log(sums[..., 0]) + top - sums[..., 1]
    return torch.sum(nll * mask), torch.sum(mask)


def train_forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                  *, remat: bool = True, loss_chunk: int = 0
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Causal-LM loss. batch: tokens (B,S_t), labels (B,S_t), optional
    mm_embeds (B,n_mm,feat) and enc_frames (B,T,feat). Returns (total,
    {"loss", "aux"}) with total = loss + 0.01 aux (the MoE layers'
    load-balance loss).

    Over data ranks (``partitioning.data_ranks``) ``batch`` is this
    rank's rows: ``total`` is its share of the global loss (its summed
    nll over the global count of valid targets, and the global aux), and
    the metrics are the global ones, equal on every rank.

    loss_chunk > 0: the lm-head product and cross entropy run over
    sequence chunks of that length (the last padded with targets -1, as
    the reference pads its scan), so the (B, S, vocab) logits never exist
    at once in the forward.
    remat: recompute each repeat of the layer loop in the backward
    (``transformer.run_decoder``).
    """
    tokens = batch["tokens"]
    x, positions = T.embed_inputs(params, cfg, tokens, batch.get("mm_embeds"))
    enc_out = None
    if cfg.encoder is not None:
        enc_out = T.run_encoder(params, cfg, batch["enc_frames"])
    h, _, aux = T.run_decoder(params, cfg, x, positions, caches=None,
                              enc_out=enc_out, remat=remat)
    n_mm = x.shape[1] - tokens.shape[1]
    # next-token prediction within the text segment
    h_pred = h[:, n_mm:][:, :-1]
    targets = batch["labels"][:, 1:]
    if loss_chunk and h_pred.shape[1] > loss_chunk:
        c = loss_chunk
        pad = (-h_pred.shape[1]) % c
        if pad:
            h_pred = F.pad(h_pred, (0, 0, 0, pad))
            targets = F.pad(targets, (0, pad), value=-1)
        sum_nll = torch.zeros((), device=h.device)
        n_valid = torch.zeros((), device=h.device)
        for i in range(0, h_pred.shape[1], c):
            ds, dn = _ce_loss(params, cfg, h_pred[:, i:i + c],
                              targets[:, i:i + c])
            sum_nll = sum_nll + ds
            n_valid = n_valid + dn
    else:
        sum_nll, n_valid = _ce_loss(params, cfg, h_pred, targets)
    ranks = data_ranks()
    if ranks is None:
        loss = mean = sum_nll / torch.clamp(n_valid, min=1.0)
    else:
        # this rank's share of the global loss: its sum over the global
        # count; the metric, the global mean
        sums = collectives.all_reduce(torch.stack([sum_nll.detach(),
                                                   n_valid]), *ranks)
        count = torch.clamp(sums[1], min=1.0)
        loss, mean = sum_nll / count, sums[0] / count
    aux_w = 0.01
    total = loss + aux_w * aux
    return total, {"loss": mean, "aux": aux}


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
    x = T.embed_tokens(params, cfg, tokens[:, None])
    x = shard(x, "batch", None, "act_embed")
    h, new_caches, _ = T.run_decoder(params, cfg, x, positions,
                                     caches=caches)
    logits = T.lm_logits(params, cfg, h)[:, 0]
    return logits.float(), new_caches

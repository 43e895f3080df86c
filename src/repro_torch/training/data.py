"""Synthetic data pipeline (token streams + multimodal stubs).

Same generator as ``repro/training/data.py``: the same numpy draws from
the same ``default_rng(seed)``, so its tokens equal the reference's
bitwise; the arrays become int32 / f32 tensors on ``device``.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.runtime import resolve_device


def synthetic_batches(cfg: ModelConfig, batch: int, seq: int, steps: int,
                      seed: int = 0, mm: bool = False, device="cuda"
                      ) -> Iterator[Dict[str, torch.Tensor]]:
    """Learnable synthetic LM data: t_{i+1} = (a*t_i + b) % vocab with
    per-sequence (a, b) drawn from a small set — the model must infer the
    recurrence in-context."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    a_set = np.array([3, 5, 7, 11])
    b_set = np.array([1, 2, 17, 31])
    mod = min(cfg.vocab, 64)      # keep the token alphabet small => learnable

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    for _ in range(steps):
        a = rng.choice(a_set, size=(batch, 1))
        b = rng.choice(b_set, size=(batch, 1))
        t0 = rng.integers(0, mod, size=(batch, 1))
        toks = [t0]
        for _i in range(seq - 1):
            toks.append((a * toks[-1] + b) % mod)
        tokens = torch.as_tensor(np.concatenate(toks, axis=1).astype(np.int32),
                                 device=dev)
        out = {"tokens": tokens, "labels": tokens.clone()}
        if mm and cfg.frontend is not None:
            n = min(cfg.frontend.tokens_per_item, 16)
            out["mm_embeds"] = f32(
                rng.normal(0, 0.02, (batch, n, cfg.frontend.feature_dim)))
        if cfg.encoder is not None:
            out["enc_frames"] = f32(
                rng.normal(0, 0.02, (batch, cfg.encoder.n_ctx,
                                     cfg.frontend.feature_dim)))
        yield out

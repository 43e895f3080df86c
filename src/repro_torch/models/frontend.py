"""Modality frontend STUBS, as in ``repro/models/frontend.py``.

The ViT / conv-codec trunk is not implemented; ``stub_embeddings``
produces deterministic pseudo-embeddings of the right shape from the raw
input bytes, standing in for precomputed patch/frame features. The
projector into d_model is a real learned parameter
(``params['projector']``). The pure-Python helpers are copies of the
reference's. ``stub_embeddings`` draws from numpy's generator seeded by
the same sha256 digest as the reference, so its values are the port's
own (the reference draws from ``jax.random``); a test that compares the
two packages hands the port's features to both.
"""
from __future__ import annotations

import hashlib
from typing import Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

# (H, W) -> n tokens, matching the paper's Table 3 for openPangu-7B-VL.
PAPER_RESOLUTION_TOKENS = {
    (280, 280): 100,
    (560, 560): 400,
    (640, 960): 529,
    (720, 1280): 1196,
    (1080, 1920): 2691,
    (4096, 3112): 16206,
}


def encode_tokens_for_image(resolution: Tuple[int, int],
                            patch: int = 28, merge: int = 1) -> int:
    """Vision-token count for an image; follows the paper's scaling."""
    if resolution in PAPER_RESOLUTION_TOKENS:
        return PAPER_RESOLUTION_TOKENS[resolution]
    h, w = resolution
    return max(1, (h // patch) * (w // patch) // max(merge, 1))


def content_hash(payload: bytes) -> str:
    """Hash key for the MM Store (paper §3.2: hash of multimodal input)."""
    return hashlib.sha256(payload).hexdigest()


def stub_embeddings(cfg: ModelConfig, payload: bytes, n_tokens: int = 0,
                    dtype=torch.float32) -> torch.Tensor:
    """Deterministic pseudo patch/frame embeddings for one item.

    Shape (n_tokens, feature_dim), on the CPU. Deterministic in the
    payload so MM Store cache hits return bit-identical features.
    """
    fe = cfg.frontend
    assert fe is not None, f"{cfg.name} has no frontend"
    n = n_tokens or fe.tokens_per_item
    seed = int.from_bytes(hashlib.sha256(payload).digest()[:4], "big")
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, fe.feature_dim), dtype=np.float32)
    return torch.from_numpy(x * np.float32(0.02)).to(dtype)


def feature_bytes(cfg: ModelConfig, n_tokens: int, dtype_bytes: int = 2) -> int:
    """Size of the E->P payload for n vision/audio tokens (post-projector,
    d_model-wide — what actually travels per the paper's Table 3)."""
    return n_tokens * cfg.d_model * dtype_bytes


def mm_key_run(key: str, n: int) -> list:
    """Pseudo-token run standing in for a multimodal segment in the radix
    prefix-cache key: (mm-content-hash, token-run).

    Deterministic in the content hash, so the same image always expands to
    the same run. Tokens are NEGATIVE ints, disjoint from any real vocab
    id — they are never embedded, only matched; the engine feeds 0 at mm
    positions and overwrites those embeddings with the projected features.
    """
    seed = int.from_bytes(hashlib.sha256(key.encode()).digest()[:8], "big")
    out, x = [], seed
    for _ in range(n):
        # 64-bit LCG (Knuth MMIX constants): cheap, deterministic spread
        x = (x * 6364136223846793005 + 1442695040888963407) & ((1 << 64) - 1)
        out.append(-1 - (x >> 33))
    return out

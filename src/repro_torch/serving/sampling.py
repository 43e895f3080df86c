"""Token sampling."""
from __future__ import annotations

from typing import Optional

import torch


def sample(logits, generator: Optional[torch.Generator] = None,
           temperature: float = 0.0) -> torch.Tensor:
    """logits: (B, vocab) f32 -> (B,) int32.

    Greedy at temperature 0 (or without a generator), the only setting
    with a parity target against the reference; otherwise a categorical
    draw from ``generator``, whose numbers differ from ``jax.random``'s.
    """
    if temperature <= 0.0 or generator is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)

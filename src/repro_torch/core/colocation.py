"""Operator-level co-location interference model (paper §3.5, Fig. 6).

The paper profiles pairs of operators executing concurrently on one NPU
and finds that operators with *different* resource footprints (AI Core vs
AI Vector vs DMA) interfere little, while similar footprints interfere
strongly. TPU analogue: MXU (systolic matmul) vs VPU (vector) vs HBM DMA
vs ICI collectives. We keep the insight as a calibrated pairwise matrix
and derive stage-level slowdowns from each stage's operator mix.

Stage profiles:
* Encode  (ViT forward)      — MXU-dominated, compute-bound.
* Prefill (long-seq forward) — MXU-dominated with HBM traffic.
* Decode  (batched 1-token)  — HBM-dominated, memory-bound.

This yields the paper's ordering: co-locating Encode with Decode is cheap
(complementary), Encode with Prefill is moderately expensive (both MXU),
and duplicate stages are the worst.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Mapping, Tuple

OPERATORS = ("matmul", "vector", "dma", "collective")

# pairwise latency-increase factors when two operator classes co-execute
# (symmetric; 1.0 = no interference). Calibrated to the *structure* of the
# paper's Fig. 6 heatmap: like-with-like is expensive.
_M: Dict[Tuple[str, str], float] = {
    ("matmul", "matmul"): 1.90,
    ("vector", "vector"): 1.80,
    ("dma", "dma"): 1.85,
    ("collective", "collective"): 1.60,
    ("matmul", "vector"): 1.25,
    ("matmul", "dma"): 1.10,
    ("matmul", "collective"): 1.05,
    ("vector", "dma"): 1.20,
    ("vector", "collective"): 1.10,
    ("dma", "collective"): 1.30,
}


def op_interference(a: str, b: str) -> float:
    return _M.get((a, b)) or _M.get((b, a)) or 1.0


# stage operator mixes (fractions of busy time per operator class)
STAGE_MIX: Dict[str, Dict[str, float]] = {
    "E": {"matmul": 0.80, "vector": 0.15, "dma": 0.05, "collective": 0.00},
    "P": {"matmul": 0.70, "vector": 0.10, "dma": 0.15, "collective": 0.05},
    "D": {"matmul": 0.20, "vector": 0.10, "dma": 0.65, "collective": 0.05},
}


def stage_slowdown(stage: str, concurrent: Iterable[str]) -> float:
    """Latency multiplier for `stage` while `concurrent` stages share the
    chip. Multiplicative across concurrent stages (>=1.0)."""
    mix_a = STAGE_MIX[stage]
    factor = 1.0
    for other in concurrent:
        mix_b = STAGE_MIX[other]
        pair = sum(mix_a[a] * mix_b[b] * op_interference(a, b)
                   for a in OPERATORS for b in OPERATORS)
        factor *= max(pair, 1.0)
    return factor


def interference_heatmap() -> Dict[Tuple[str, str], float]:
    """Full stage x stage matrix (for the Fig. 6 benchmark)."""
    return {(a, b): stage_slowdown(a, [b])
            for a in STAGE_MIX for b in STAGE_MIX}

"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.

[arXiv:2401.04088] — SWA window 4096 caps decode KV, so long_500k runs
for this arch (sub-quadratic decode memory).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    pattern=(LayerSpec("swa", "moe"),),
    moe=MoEConfig(n_experts=8, top_k=2),
    sliding_window=4096,
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088",
)

"""llama4-scout-17b-a16e [moe] — 16 experts top-1, early-fusion vision.

[hf:meta-llama/Llama-4-Scout-17B-16E]
"""
from repro_torch.configs.base import FrontendConfig, LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    arch_type="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    pattern=(LayerSpec("attn", "moe"),),
    moe=MoEConfig(n_experts=16, top_k=1),
    # early-fusion multimodal: vision frontend STUB provides patch embeddings
    frontend=FrontendConfig(kind="vision", tokens_per_item=576, feature_dim=1408),
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)

"""openPangu-7B-VL — the paper's own evaluation model (ViT 0.7B + LLM 7B).

No public model card exists; geometry is estimated from the paper:
Table 3 shows E->P transmitted features of shape [n, 3584], so the
projected feature dim (= LLM d_model) is 3584; a 720x1280 image encodes
to 1196 tokens. The 7B LLM geometry is taken as the standard 7B-class
layout at d_model=3584. Marked ESTIMATED in DESIGN.md.
"""
from repro_torch.configs.base import FrontendConfig, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="openpangu-7b-vl",
    arch_type="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    pattern=(LayerSpec("attn", "mlp"),),
    frontend=FrontendConfig(kind="vision", tokens_per_item=1196,  # 720p
                            feature_dim=1280),
    rope_theta=1_000_000.0,
    source="paper (EPD-Serve) — ESTIMATED geometry",
)

"""llava-next-mistral-7b [vlm] — mistral-7b backbone, anyres ViT STUB.

[hf:llava-hf/llava-v1.6-mistral-7b-hf] — anyres tiling: base image +
up to 4 tiles, 576 patch embeddings each (24x24 @ CLIP ViT-L/14-336).
The ViT trunk is a stub; the projector (2-layer MLP in the original,
linear here) and the full language backbone are implemented.
"""
from repro_torch.configs.base import FrontendConfig, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    arch_type="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    pattern=(LayerSpec("attn", "mlp"),),
    frontend=FrontendConfig(kind="vision", tokens_per_item=2880,  # 5 x 576
                            feature_dim=1024),
    rope_theta=1_000_000.0,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)

"""mamba2-370m [ssm] — attention-free, SSD (state-space duality).

[arXiv:2405.21060] — 48 Mamba2 blocks (each block contains its own gated
projection, so there is no separate FFN: d_ff=0).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    pattern=(LayerSpec("ssm", "none"),),
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=256),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)

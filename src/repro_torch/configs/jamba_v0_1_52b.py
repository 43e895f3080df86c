"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887] — 8-layer period: attention at position 4, Mamba
elsewhere; MoE replaces the MLP on every other layer. We implement the
SSM layers with Mamba2/SSD (TPU-friendly matmul form); the original uses
Mamba1 — noted in DESIGN.md as a deliberate TPU adaptation.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig, SSMConfig

_PATTERN = tuple(
    LayerSpec(mixer=("attn" if i == 4 else "ssm"),
              ffn=("moe" if i % 2 == 1 else "mlp"))
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    pattern=_PATTERN,
    moe=MoEConfig(n_experts=16, top_k=2),
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=256),
    source="arXiv:2403.19887",
)

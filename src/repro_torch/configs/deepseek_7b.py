"""deepseek-7b [dense] — llama-arch, MHA (kv=32).  [arXiv:2401.02954]"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    arch_type="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=102400,
    pattern=(LayerSpec("attn", "mlp"),),
    source="arXiv:2401.02954",
)

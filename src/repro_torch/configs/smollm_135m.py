"""smollm-135m [dense] — llama-arch small.  [hf:HuggingFaceTB/SmolLM-135M]"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    arch_type="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab=49152,
    pattern=(LayerSpec("attn", "mlp"),),
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)

"""whisper-base [audio] — enc-dec transformer backbone, conv frontend STUB.

[arXiv:2212.04356] — the mel-spectrogram + conv feature extractor is a
stub that emits 1500 frame embeddings (30 s of audio); the 6-layer
encoder and 6-layer decoder (self + cross attention) are implemented.
"""
from repro_torch.configs.base import (EncoderConfig, FrontendConfig, LayerSpec,
                                      ModelConfig)

CONFIG = ModelConfig(
    name="whisper-base",
    arch_type="audio",
    n_layers=6,                   # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    pattern=(LayerSpec("attn", "mlp"),),
    encoder=EncoderConfig(n_layers=6, n_ctx=1500),
    frontend=FrontendConfig(kind="audio", tokens_per_item=1500, feature_dim=512),
    tie_embeddings=True,
    source="arXiv:2212.04356",
)

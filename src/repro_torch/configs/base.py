"""Config system for EPD-Serve reproduction.

A ``ModelConfig`` fully describes one backbone: layer pattern (attention /
sliding-window attention / SSM mixers, dense / MoE ffns), GQA geometry,
vocab, and the (stubbed) modality frontend for VLM / audio archs.

Every assigned architecture gets one module in this package defining
``CONFIG``; ``repro_torch.configs.get_config(name)`` resolves it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    # capacity factor for einsum (dropped-token) dispatch; tokens per expert
    # = ceil(tokens * top_k / n_experts * capacity_factor)
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD geometry."""

    state_dim: int = 128          # N: per-head state size
    head_dim: int = 64            # P: channels per SSD head
    expand: int = 2               # inner dim = expand * d_model
    chunk_size: int = 256         # SSD chunk length
    conv_width: int = 4           # depthwise causal conv width

    def inner_dim(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.inner_dim(d_model) // self.head_dim


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB: emits precomputed embeddings (see DESIGN.md).

    ``kind`` is 'vision' or 'audio'. ``tokens_per_item`` is the number of
    embedding tokens one image / audio clip contributes; ``feature_dim`` is
    the frontend's native output dim (projected to d_model by a learned
    projector, which IS implemented — only the encoder trunk is stubbed).
    """

    kind: str
    tokens_per_item: int
    feature_dim: int


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder half of an encoder-decoder backbone (whisper-style)."""

    n_layers: int
    n_ctx: int                    # encoder sequence length (audio frames)


@dataclass(frozen=True)
class LayerSpec:
    """One layer position in the repeating pattern.

    mixer: 'attn' (full causal), 'swa' (sliding window), 'ssm' (Mamba2 SSD)
    ffn:   'mlp' (gated dense), 'moe' (top-k experts), 'none'
    """

    mixer: str = "attn"
    ffn: str = "mlp"


# ---------------------------------------------------------------------------
# ModelConfig
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    frontend: Optional[FrontendConfig] = None
    encoder: Optional[EncoderConfig] = None
    sliding_window: Optional[int] = None
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    source: str = ""              # citation for the config

    # -- derived ----------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern length {len(self.pattern)}"
        )

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def has_attention(self) -> bool:
        return any(s.mixer in ("attn", "swa") for s in self.pattern)

    @property
    def attn_layers(self) -> Tuple[int, ...]:
        """Absolute indices of attention layers (for KV-cache layout)."""
        out = []
        for r in range(self.n_repeats):
            for i, s in enumerate(self.pattern):
                if s.mixer in ("attn", "swa"):
                    out.append(r * len(self.pattern) + i)
        return tuple(out)

    @property
    def ssm_layers(self) -> Tuple[int, ...]:
        out = []
        for r in range(self.n_repeats):
            for i, s in enumerate(self.pattern):
                if s.mixer == "ssm":
                    out.append(r * len(self.pattern) + i)
        return tuple(out)

    @property
    def sub_quadratic(self) -> bool:
        """True if decode memory is o(seq): SSM-only, or SWA-capped KV."""
        mixers = {s.mixer for s in self.pattern}
        if mixers <= {"ssm"}:
            return True
        if "attn" in mixers:
            # hybrid with a few full-attention layers still scales linearly
            # in KV but with a small constant; the brief treats SSM-dominant
            # hybrids as long-context capable.
            return self.arch_type == "hybrid"
        if mixers <= {"swa", "ssm"}:
            return self.sliding_window is not None
        return False

    def reduced(self, *, n_layers: int = 0, d_model: int = 0,
                n_experts: int = 0, vocab: int = 0) -> "ModelConfig":
        """A small same-family variant for CPU smoke tests."""
        pat = len(self.pattern)
        nl = n_layers or min(self.n_layers, 2 * pat if pat <= 2 else pat)
        dm = d_model or min(self.d_model, 256)
        nh = max(1, dm // 64)
        # keep the GQA grouping qualitatively (grouped vs MHA)
        ratio = max(1, self.n_heads // max(self.n_kv_heads, 1))
        nkv = max(1, nh // ratio)
        moe = self.moe
        if moe is not None:
            moe = dataclasses.replace(
                moe, n_experts=n_experts or min(moe.n_experts, 4),
                top_k=min(moe.top_k, n_experts or min(moe.n_experts, 4)))
        ssm = self.ssm
        if ssm is not None:
            ssm = dataclasses.replace(ssm, state_dim=min(ssm.state_dim, 32),
                                      head_dim=32, chunk_size=32)
        fe = self.frontend
        if fe is not None:
            fe = dataclasses.replace(fe, tokens_per_item=min(fe.tokens_per_item, 16),
                                     feature_dim=min(fe.feature_dim, 128))
        enc = self.encoder
        if enc is not None:
            enc = dataclasses.replace(enc, n_layers=2, n_ctx=32)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=nl, d_model=dm, n_heads=nh, n_kv_heads=nkv,
            head_dim=dm // nh if nh else 64,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=vocab or min(self.vocab, 512),
            moe=moe, ssm=ssm, frontend=fe, encoder=enc,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
        )

    # -- size accounting ----------------------------------------------------
    def param_count(self) -> int:
        """Total parameter count (embeddings included)."""
        total = self.vocab * self.d_model          # embed
        if not self.tie_embeddings:
            total += self.vocab * self.d_model     # lm head
        total += self.d_model                      # final norm
        for spec in self.pattern:
            total += self.n_repeats * self._layer_params(spec)
        if self.encoder is not None:
            enc_layer = (
                2 * self.d_model  # norms
                + 4 * self.d_model * self.d_model  # self-attn qkvo (MHA)
                + 2 * self.d_model * self.d_ff     # non-gated mlp
            )
            total += self.encoder.n_layers * enc_layer + self.d_model
        if self.frontend is not None:
            total += self.frontend.feature_dim * self.d_model  # projector
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        total = self.vocab * self.d_model
        if not self.tie_embeddings:
            total += self.vocab * self.d_model
        total += self.d_model
        for spec in self.pattern:
            total += self.n_repeats * self._layer_params(spec, active=True)
        return total

    def _layer_params(self, spec: LayerSpec, active: bool = False) -> int:
        n = 0
        d = self.d_model
        if spec.mixer in ("attn", "swa"):
            n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            n += d  # norm
            if self.encoder is not None:
                # decoder layers of an enc-dec backbone carry cross-attention
                n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d + d
        elif spec.mixer == "ssm":
            ssm = self.ssm
            inner = ssm.inner_dim(d)
            nh = ssm.n_heads(d)
            # in_proj -> [z, x, B, C, dt], out_proj, conv, norm
            zxbcdt = 2 * inner + 2 * ssm.state_dim + nh
            n += d * zxbcdt + inner * d
            n += ssm.conv_width * (inner + 2 * ssm.state_dim)
            n += 2 * nh + d  # A_log, D, norm
        if spec.ffn == "mlp":
            n += 3 * d * self.d_ff + d
        elif spec.ffn == "moe":
            e = self.moe.top_k if active else self.moe.n_experts
            n += e * 3 * d * self.d_ff + d + d * self.moe.n_experts  # router
        return n


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

"""The real Encode-stage instance (paper §3.2, the E in EPD).

One ``EncodeEngine`` is one Encode serving instance: it runs the modality
frontend forward — the stubbed ViT/conv trunk plus the REAL learned
projector (``params['projector']``), through ``steps.make_encode_fn``
— and lands the resulting d_model-wide feature tensor in the shared
``MMStore`` under the input's content hash. Downstream, a Prefill
engine consumes the features by scattering them into the embedding
stream at image-token positions (``prefill_request(mm_feats=...)``),
and the ``EPPrefetcher`` hides the E->P hand-off under scheduling.

Dedup is the stage's cheapest win: a payload whose hash is already
resident skips the forward entirely (cross-request reuse — the store's
hit/miss stats track exactly this). ``compute_features`` is also the
cluster's fault-tolerant recompute arm: a Prefill-side store miss calls
it to rebuild the feature tensor locally, and because the same
projector forward runs in both places the recompute is bit-identical
to the original encode.

For encoder-decoder archs (whisper-class), the cross-attention encoder
runs inside prefill against raw frames, so the store payload is the raw
stub frame tensor, un-projected.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.mm_store import MMStore
from repro_torch.core.telemetry import NULL_TRACER, MetricsRegistry, Tracer
from repro_torch.models import frontend as FE
from repro_torch.serving.request import Request
from repro_torch.serving.steps import make_encode_fn


class EncodeEngine:
    def __init__(self, cfg: ModelConfig, params, *, store: MMStore,
                 name: str = "E0",
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None):
        if cfg.frontend is None:
            raise ValueError(f"{cfg.name} has no modality frontend — "
                             f"an Encode instance has nothing to run")
        self.cfg = cfg
        self.params = params
        self.store = store
        self.name = name
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        # VLM-class: trunk+projector forward. Whisper-class keeps raw
        # frames (the encoder runs under prefill's cross-attention).
        self._encode = make_encode_fn(cfg) if cfg.encoder is None else None
        M = self.metrics
        self._m_requests = M.counter("encode_requests_total", engine=name)
        self._m_tokens = M.counter("encode_tokens_total", engine=name)
        self._m_dedup = M.counter("encode_dedup_total", engine=name)

    def compute_features(self, payload: bytes,
                         n_tokens: int = 0) -> np.ndarray:
        """Run the frontend forward for one payload: stub trunk ->
        learned projector -> (n_tokens, d_model) float32. This is the
        single implementation behind the Encode stage AND the
        Prefill-side store-miss recompute arm, so recomputes are
        bit-identical to the features they replace."""
        patches = FE.stub_embeddings(self.cfg, payload, n_tokens or None)
        if self._encode is None:
            return patches.numpy()              # raw frames (whisper)
        return self._encode(self.params, patches).cpu().numpy()

    def encode_request(self, req: Request) -> str:
        """Encode one request's payload into the MM Store; returns the
        content-hash key the Prefill stage will fetch by. A resident key
        skips the forward (dedup — the §3.2 cross-request reuse path);
        ``contains`` doesn't consume injected store faults, so those hit
        the Prefill-side fetch and exercise the recompute arm."""
        key = FE.content_hash(req.mm_payload)
        self._m_requests.inc()
        with self.tracer.span("encode.forward", track=self.name,
                              request_id=req.request_id,
                              tokens=req.mm_tokens):
            if self.store.contains(key):
                self.store.stats.hits += 1
                self._m_dedup.inc()
            else:
                self.store.stats.misses += 1
                feats = self.compute_features(req.mm_payload, req.mm_tokens)
                self.store.put(key, feats, feats.nbytes)
                self._m_tokens.inc(feats.shape[0])
        return key

    def dispatch(self, req: Request) -> Tuple[str, bool]:
        """Iteration-loop entry point: encode ``req`` and report whether
        the forward actually ran (``ran=False`` = store dedup hit). The
        continuous scheduler uses ``ran`` to decide whether the E->P
        feature barrier charges encode time or the feature is free —
        dedup'd features carry no arrival dependency."""
        key = FE.content_hash(req.mm_payload)
        ran = not self.store.contains(key)
        self.encode_request(req)
        return key, ran

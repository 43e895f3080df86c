"""Roofline-derived stage cost model.

Maps (model config, stage, request shape, instance resources) to service
times, using the same three-term decomposition as the dry-run roofline
(EXPERIMENTS.md §Roofline): compute = FLOPs / (chips * peak), memory =
bytes / (chips * HBM bw), collective = bytes / link bw. A stage's service
time is max(compute, memory) + collective + fixed launch overhead.

Hardware constants: ``V5E`` is the reference's TPU v5e target (the
paper's Ascend Atlas 800I A2 is comparable per-chip; DESIGN.md records
the swap), ``H100`` the card the port serves on. Efficiencies are
de-rates from peak, the usual 0.4-0.6 MFU band for prefill-like work.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class Hardware:
    peak_flops: float = 197e12        # bf16 FLOP/s per chip
    hbm_bw: float = 819e9             # B/s per chip
    link_bw: float = 50e9             # B/s per ICI link (paper: RDMA/HCCS)
    # E->P features go through the MM Store (DRAM staging + network, the
    # Mooncake path): effective bandwidth back-computed from the paper's
    # Table 3 measurements (0.72 MB in 8.1 ms ... 116 MB in 730 ms).
    store_bw: float = 0.16e9
    mfu: float = 0.5                  # achievable fraction of peak, compute
    mbu: float = 0.7                  # achievable fraction of HBM bw
    tp_allreduce_lat: float = 8e-6    # per-collective latency, seconds
    tp_efficiency: float = 0.7        # per-doubling compute scaling under TP
    launch_overhead: float = 2e-4     # per-step host/launch overhead
    handshake: float = 2e-3           # KV-transfer metadata handshake (paper §3.3)
    # device<->host staging link for page-level preemption swaps (PCIe
    # 4.0 x16 class) + the per-swap fixed cost (descriptor build, pinned
    # staging-buffer handoff, allocator round trip)
    host_bw: float = 25.6e9
    swap_latency: float = 0.3e-3
    # cross-instance dispatch overhead (scheduler tick, batch formation,
    # local cache write) — the "scheduling latency" of the paper's Table 3:
    # ~30 ms base plus a store-bandwidth write of the feature.
    dispatch_base: float = 30e-3
    dtype_bytes: int = 2


V5E = Hardware()
# cross-node disaggregation profile: KV moves over RDMA/DCN instead of ICI
RDMA = Hardware(link_bw=12.5e9, handshake=13e-3)
# one NVIDIA H100 SXM: dense bf16 tensor-core peak, HBM3, NVLink 4 (per
# direction) between cards, PCIe 5.0 x16 to the host; every other field
# (de-rates, overheads, the store path) is V5E's
H100 = Hardware(peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9,
                host_bw=64e9)


# ViT encoder proxy for the Encode stage (paper: 0.6-6B ViT params).
@dataclass(frozen=True)
class EncoderModel:
    params: float = 0.7e9             # openPangu-7B-VL ViT
    d_model: int = 1280
    n_layers: int = 32
    # ViT runs on pre-merge patches (2x2 pixel-unshuffle before the
    # projector is standard in Qwen2-VL-style stacks) — internal sequence
    # is ~4x the emitted vision tokens. This is what makes Encode rival
    # Prefill in latency (paper Fig. 2).
    internal_multiplier: int = 4


@dataclass(frozen=True)
class CostModel:
    cfg: ModelConfig
    hw: Hardware = V5E
    vit: EncoderModel = EncoderModel()
    # paged KV: tokens per pool page (0 = dense layout). P->D payloads
    # round up to whole pages and transfers plan at page granularity.
    page_tokens: int = 0

    # ---- stage compute ------------------------------------------------------
    def _chip_rate(self, chips: int, tp: int) -> float:
        """Aggregate compute rate: TP scales sub-linearly (sync overhead)."""
        eff = self.hw.tp_efficiency ** max(0, (tp - 1).bit_length()) \
            if tp > 1 else 1.0
        return chips * self.hw.peak_flops * self.hw.mfu * eff

    def encode_time(self, n_tokens: int, chips: int = 1, tp: int = 1) -> float:
        """ViT forward over n visual tokens (compute-bound)."""
        n_int = n_tokens * self.vit.internal_multiplier
        flops = 2.0 * self.vit.params * n_int
        # quadratic attention term
        flops += 4.0 * self.vit.n_layers * n_int ** 2 * self.vit.d_model
        t = flops / self._chip_rate(chips, tp)
        return t + self.hw.launch_overhead + self._tp_penalty(tp, self.vit.n_layers)

    def prefill_time(self, prompt_len: int, chips: int = 1, tp: int = 1,
                     cached_prefix: float = 0.0) -> float:
        """One request's prefill. ``cached_prefix`` tokens are served from
        the prefix cache: linear (MLP/projection) FLOPs cover only the
        computed suffix, and the quadratic term is suffix queries against
        the FULL context (cached KV is still attended to)."""
        cfg = self.cfg
        n_active = cfg.active_param_count()
        computed = max(1.0, prompt_len - max(0.0, cached_prefix))
        flops = 2.0 * n_active * computed
        attn_layers = len(cfg.attn_layers) or 0
        if attn_layers:
            eff_ctx = prompt_len if cfg.sliding_window is None else min(
                prompt_len, cfg.sliding_window)
            flops += 4.0 * attn_layers * computed * eff_ctx * cfg.q_dim
        t_c = flops / self._chip_rate(chips, tp)
        t_m = self.param_bytes() / (chips * self.hw.hbm_bw * self.hw.mbu)
        t = max(t_c, t_m)
        return t + self.hw.launch_overhead + self._tp_penalty(tp, cfg.n_layers)

    def chunk_prefill_times(self, prompt_len: int,
                            chunk_tokens: "list[float]", chips: int = 1,
                            tp: int = 1,
                            cached_prefix: float = 0.0) -> "list[float]":
        """Per-chunk slices of one request's prefill for the chunked
        streaming schedule (kv_transfer.plan_chunked).

        ``chunk_tokens[k]`` is the number of tokens chunk *k* computes
        (a leading 0 entry models a cached-prefix segment: no compute,
        its KV is already resident). The monolithic
        ``prefill_time(prompt_len, cached_prefix=...)`` is split across
        chunks proportional to each chunk's FLOPs — linear terms on its
        computed tokens, the quadratic attention term against its
        end-of-chunk context — so chunking never changes total modeled
        compute; each chunk past the first adds one ``launch_overhead``
        (the extra kernel dispatch), which is the honest cost of
        chunking that the transfer overlap has to beat.
        """
        cfg = self.cfg
        total = self.prefill_time(prompt_len, chips, tp,
                                  cached_prefix=cached_prefix)
        n_active = cfg.active_param_count()
        attn_layers = len(cfg.attn_layers)
        ctx = max(0.0, cached_prefix)
        weights = []
        for c in chunk_tokens:
            ctx += c
            w = 2.0 * n_active * c
            if attn_layers and c:
                eff_ctx = ctx if cfg.sliding_window is None else min(
                    ctx, cfg.sliding_window)
                w += 4.0 * attn_layers * c * eff_ctx * cfg.q_dim
            weights.append(w)
        wsum = sum(weights) or 1.0
        out = [total * w / wsum for w in weights]
        extra = 0
        for k, c in enumerate(chunk_tokens):
            if c <= 0:
                continue
            if extra:
                out[k] += self.hw.launch_overhead
            extra += 1
        return out

    def decode_step_time(self, batch: int, kv_len: float, chips: int = 1,
                         tp: int = 1) -> float:
        """One decode iteration for a batch (memory-bound)."""
        cfg = self.cfg
        bytes_moved = self.param_bytes() + batch * self.kv_bytes_per_token() \
            * self._eff_kv(kv_len)
        t_m = bytes_moved / (chips * self.hw.hbm_bw * self.hw.mbu)
        flops = 2.0 * cfg.active_param_count() * batch
        t_c = flops / self._chip_rate(chips, tp)
        t = max(t_m, t_c)
        return t + self.hw.launch_overhead + self._tp_penalty(tp, cfg.n_layers)

    def swap_time(self, n_pages: int) -> float:
        """One-direction host-link time to move ``n_pages`` of KV between
        the device pool and host memory: the service-time cost of a
        page-level preemption swap-out, or of the swap-in at re-fault.
        The simulator charges it into the decode stream (the honest
        pessimistic placement: the pool pages are not reusable until the
        copy lands)."""
        if n_pages <= 0:
            return 0.0
        if not self.page_tokens:
            raise ValueError("swap_time needs a paged layout "
                             "(page_tokens > 0)")
        return (self.hw.swap_latency
                + n_pages * self.kv_page_bytes() / self.hw.host_bw)

    def _tp_penalty(self, tp: int, n_layers: int) -> float:
        """Inter-chip sync overhead of tensor parallelism (2 allreduce/layer).

        This is what makes TP2 the worst deployment in the paper (§4.3)."""
        if tp <= 1:
            return 0.0
        return 2.0 * n_layers * self.hw.tp_allreduce_lat * (tp - 1)

    def _eff_kv(self, kv_len: float) -> float:
        w = self.cfg.sliding_window
        return min(kv_len, w) if w else kv_len

    # ---- payload sizes ------------------------------------------------------
    def param_bytes(self) -> float:
        return self.cfg.active_param_count() * self.hw.dtype_bytes

    def kv_bytes_per_token(self) -> float:
        """P->D payload per token: attention KV (+ amortized SSM state)."""
        cfg = self.cfg
        b = len(cfg.attn_layers) * 2 * cfg.kv_dim * self.hw.dtype_bytes
        return b

    def ssm_state_bytes(self) -> float:
        cfg = self.cfg
        if cfg.ssm is None:
            return 0.0
        nh = cfg.ssm.n_heads(cfg.d_model)
        per_layer = nh * cfg.ssm.head_dim * cfg.ssm.state_dim * 4  # f32
        return len(cfg.ssm_layers) * per_layer

    def kv_page_bytes(self) -> float:
        """Bytes of one KV pool page across all attention layers
        (0 when the layout is dense)."""
        return self.page_tokens * self.kv_bytes_per_token()

    def kv_page_bytes_per_layer(self) -> float:
        """One layer's slice of a KV page — the rounding quantum for
        per-layer transfer planning (kv_transfer.plan(page_bytes=...))."""
        n_attn = max(len(self.cfg.attn_layers), 1)
        return self.kv_page_bytes() / n_attn

    def kv_bytes(self, prompt_len: int) -> float:
        """Total P->D payload for one request (page-rounded when paged)."""
        eff = self._eff_kv(prompt_len)
        if self.page_tokens:
            eff = math.ceil(eff / self.page_tokens) * self.page_tokens
        return self.kv_bytes_per_token() * eff + self.ssm_state_bytes()

    def feature_bytes(self, n_tokens: int) -> float:
        """E->P payload (projected features, d_model wide — Table 3)."""
        return n_tokens * self.cfg.d_model * self.hw.dtype_bytes

    # ---- transfers ----------------------------------------------------------
    def transfer_time(self, nbytes: float, with_handshake: bool = True) -> float:
        t = nbytes / self.hw.link_bw
        return t + (self.hw.handshake if with_handshake else 0.0)

    def recover_transfer(self, plan, injector, policy, key=None,
                         replan: bool = True):
        """Deliver a transfer plan through the fault plane: re-schedules
        the plan's groups under the injector's handshake/wire faults with
        the retry policy's backoff, falling back to a fresh grouped plan
        for only the missing groups (kv_transfer.recover_plan), using
        THIS hardware profile's handshake latency and link bandwidth —
        the hook that charges retry time into simulator and cluster
        latency accounting. Returns (recovered_plan, TransferRecovery);
        raises TransferError when a group cannot be delivered at all."""
        from repro_torch.core import kv_transfer
        return kv_transfer.recover_plan(
            plan, injector=injector, policy=policy,
            handshake=self.hw.handshake, link_bw=self.hw.link_bw,
            key=key, replan=replan)

    def feature_transfer_time(self, nbytes: float) -> float:
        """E->P feature movement through the MM Store path."""
        return nbytes / self.hw.store_bw

    def dispatch_latency(self, nbytes: float) -> float:
        """Cross-instance scheduling latency (paper Table 3): scheduler
        tick + batch formation + local cache write of the feature. The
        write path is marginally faster than the store fetch (~5%), so for
        very large features (4K images) the transfer outruns scheduling
        and overlap dips below 100% — exactly the paper's Table 3 shape."""
        return self.hw.dispatch_base + nbytes / (self.hw.store_bw * 1.05)

    def per_layer_kv_bytes(self, prompt_len: int) -> float:
        cfg = self.cfg
        n_attn = max(len(cfg.attn_layers), 1)
        return self.kv_bytes(prompt_len) / n_attn

    def per_layer_prefill_time(self, prompt_len: int, chips: int = 1,
                               tp: int = 1,
                               cached_prefix: float = 0.0) -> float:
        return self.prefill_time(prompt_len, chips, tp,
                                 cached_prefix) / self.cfg.n_layers

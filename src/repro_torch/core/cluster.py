"""REAL-compute EPD mini-cluster.

Wires actual PyTorch ``Engine`` instances (repro_torch.serving.engine)
through the same EPD-Serve machinery the reference's simulator uses — MM
Store, modality-aware router, E->P prefetch bookkeeping, P->D grouped KV
transfer planning — so the disaggregation logic runs end-to-end with
real tensors: full-size models on the GPU, reduced configs on the CPU in
the tests. The transfer and retry charges are modeled by ``CostModel``
on the ``hw`` profile: ``costmodel.V5E`` by default, the reference's, so
that the CPU tests hold the port's modelled charges to the reference's;
``costmodel.H100`` where the cluster serves on the card
(``chip_smoke.py``, ``launch/serve.py``).

Stage mapping:
* Encode instance  — runs the (stubbed) frontend + owns the MM Store put.
* Prefill instance — fetches features by hash from the MM Store
  (recomputing on a miss — fault-tolerance path), runs real prefill,
  exports the prefilled cache dict (the "KV payload").
* Decode instance  — imports caches via the grouped transfer planner
  (payload bytes measured from the actual arrays) and continuous-batches
  decode steps.

Co-located stages share one Engine's params but keep separate logical
queues, mirroring the paper's logical-isolation/physical-co-location.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.batching import (IterationScheduler, PrefillJob,
                                       StreamTimeline)
from repro_torch.core.costmodel import CostModel, Hardware, V5E
from repro_torch.core.deployment import Deployment, InstanceSpec
from repro_torch.core.faults import (DEFAULT_RETRY, NO_RETRY, NoFreeSlot,
                                     SITE_DECODE_CRASH,
                                     SITE_STORE_FETCH, FaultInjector, FaultPlan,
                                     InstanceDown, RetryPolicy, TransferError)
from repro_torch.core.scheduler import Router
from repro_torch.runtime import resolve_device
from repro_torch.core.ep_prefetch import EPPrefetcher
from repro_torch.core.events import EventLoop
from repro_torch.core.kv_transfer import (TransferPlan, emit_spans,
                                          plan as kv_plan,
                                          plan_chunked as kv_plan_chunked)
from repro_torch.core.mm_store import MMStore
from repro_torch.core.telemetry import (NULL_TRACER, LatencyAccountant,
                                        MetricsRegistry, Tracer)
from repro_torch.models import frontend as FE
from repro_torch.serving.encode_engine import EncodeEngine
from repro_torch.serving.engine import Engine
from repro_torch.serving.graphs import census
from repro_torch.serving.kv_pool import PoolExhausted
from repro_torch.models.transformer import cache_tensors
from repro_torch.serving.request import Request


def cache_nbytes(caches) -> int:
    return sum(x.numel() * x.element_size() for x in cache_tensors(caches))


@dataclass
class ClusterReport:
    completed: List[Request] = field(default_factory=list)
    kv_plans: List[TransferPlan] = field(default_factory=list)
    recomputes: int = 0
    # page-level preemption on the Decode engine
    preemptions: int = 0
    swapped_pages: int = 0           # host-link pages moved (out + in)
    admission_denials: int = 0       # inserts denied by the decode pool
    # fault recovery (chaos layer): per-arm counters and every request
    # the cluster gave up on — losses are surfaced, never silent. The
    # retry counters/time live in the cluster-wide metrics registry
    # (labeled by site); the historical names read through below.
    instance_crashes: int = 0
    reroutes: int = 0
    swap_losses: int = 0
    lost: List[Request] = field(default_factory=list)
    metrics: MetricsRegistry = field(default_factory=MetricsRegistry)

    # -- registry read-through (historical counter names) --------------------
    @property
    def retry_time_total(self) -> float:
        """Modeled retry/backoff seconds charged into latency accounting,
        across every recovery site (store fetch + transfer)."""
        return self.metrics.total("retry_time_seconds_total")

    @property
    def store_retries(self) -> int:
        return int(self.metrics.value("recovery_retries_total",
                                      site=SITE_STORE_FETCH))

    @property
    def transfer_retries(self) -> int:
        return int(self.metrics.value("recovery_retries_total",
                                      site="transfer"))

    @property
    def transfer_replans(self) -> int:
        return int(self.metrics.value("transfer_replans_total"))

    @property
    def encode_skips(self) -> int:
        """Encode forwards skipped outright because the (mm-hash,
        token-run) prefix key already covered the whole image run."""
        return int(self.metrics.value("encode_skips_total"))

    @property
    def mean_kv_overlap(self) -> float:
        if not self.kv_plans:
            return 1.0
        return sum(p.overlap_ratio for p in self.kv_plans) / len(self.kv_plans)


class EPDCluster:
    """E / P / D as separate engines over shared params (disaggregated)."""

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 4,
                 max_len: int = 128, kv_scheme: str = "grouped",
                 hw: Hardware = V5E, paged: bool = False,
                 page_size: int = 16, prefix_cache: bool = False,
                 n_prefill_pool_pages: Optional[int] = None,
                 chunked_prefill: bool = False, prefill_chunk: int = 32,
                 preemption: bool = False,
                 n_decode_pool_pages: Optional[int] = None,
                 n_decode: int = 1,
                 n_encode: int = 1, ep_overlap: str = "async",
                 faults: Optional[FaultPlan] = None,
                 retry: Optional[RetryPolicy] = None,
                 recovery: bool = True,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 device="cuda", cache_dtype=None):
        # resolve the device first: a default (CUDA) construction on a
        # machine without CUDA raises before any engine is built
        self.device = resolve_device(device)
        self.cfg = cfg
        # telemetry plane: one metrics registry + one span tracer + one
        # latency accountant for the whole cluster. The accountant's
        # clock is wall time (sync at every state transition) PLUS
        # modeled charges (transfer exposure, retry backoff) — the same
        # virtual timebase retry_time accounting already used; the
        # tracer is re-clocked onto it so wall spans and modeled
        # transfer spans share one timeline.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.acc = LatencyAccountant(wall=time.perf_counter)
        if tracer is not None:
            tracer.set_clock(self.acc.clock)
        self._queue_since: Dict[int, float] = {}
        # one fault plane across every failure domain: store fetches,
        # transfer groups, decode instances, and the swap tier all draw
        # from the same seeded injector. faults=None keeps the zero-fault
        # fast paths byte-identical to the pre-chaos cluster.
        self.faults = faults
        self.injector = FaultInjector(faults, metrics=self.metrics)
        if retry is not None:
            self.retry = retry
        else:
            # with a fault plan the recovery arms get the standard
            # backoff policy; without one NO_RETRY preserves the legacy
            # single-attempt store semantics (§3.2 recompute) exactly
            self.retry = DEFAULT_RETRY if faults is not None else NO_RETRY
        self.recovery = recovery
        self.store = MMStore(injector=self.injector)
        self.cost = CostModel(cfg, hw,
                              page_tokens=page_size if paged else 0)
        # Encode stage: real EncodeEngine instances (round-robin) feeding
        # the MM Store, with the E->P hand-off modeled per ep_overlap:
        #   async  — hash-only announce; the feature transfer hides under
        #            dispatch + the pre-image text prefill (RServe-style
        #            barrier only at image-token positions);
        #   sync   — the feature pushes E->P serially before prefill;
        #   inline — encode folds into the prefill instance (no transfer).
        # Arms differ ONLY in modeled accounting charges: the same
        # features flow through the same forwards, so greedy
        # output is bit-identical across all three.
        if ep_overlap not in ("async", "sync", "inline"):
            raise ValueError(f"unknown ep_overlap mode {ep_overlap!r}")
        if n_encode < 1:
            raise ValueError("need n_encode >= 1")
        self.ep_overlap = ep_overlap
        self.encode_engines = (
            [EncodeEngine(cfg, params, store=self.store, name=f"E{i}",
                          tracer=self.tracer, metrics=self.metrics)
             for i in range(n_encode)]
            if cfg.frontend is not None else [])
        self._next_encode = 0
        self._ep_loop = EventLoop()
        self.prefetcher = EPPrefetcher(self._ep_loop, self.store, self.cost,
                                       async_mode=(ep_overlap == "async"))
        self._encode_skipped: set = set()
        self.kv_scheme = kv_scheme
        self.paged = paged
        self.chunked_prefill = chunked_prefill
        # Prefill engine: batch 1 (prefill is per-request); carries the
        # radix prefix cache when enabled (hits skip prefill compute for
        # the shared pages and the transfer planner charges suffix-only)
        # and the chunked-prefill window (each chunk's pages stream to
        # Decode while the next chunk computes).
        self._params = params
        self._cache_dtype = cache_dtype
        self._engine_opts = {
            "prefill": dict(max_batch=1, max_len=max_len, paged=paged,
                            page_size=page_size, prefix_cache=prefix_cache,
                            n_pool_pages=n_prefill_pool_pages,
                            chunked_prefill=chunked_prefill,
                            prefill_chunk=prefill_chunk),
            "decode": dict(max_batch=max_batch, max_len=max_len,
                           paged=paged, page_size=page_size,
                           n_pool_pages=n_decode_pool_pages,
                           preemption=preemption, faults=self.injector)}
        self.prefill_engine = self.make_engine("prefill", 0)
        # Decode instances: preemption=True turns decode-side pool
        # pressure into page-level swap-to-host + resume instead of a
        # pool error; n_decode_pool_pages sizes the pool below
        # worst-case for overload experiments; n_decode > 1 gives the
        # crash re-route arm a surviving instance to land on.
        if n_decode < 1:
            raise ValueError("need n_decode >= 1")
        self.decode_engines = [self.make_engine("decode", i)
                               for i in range(n_decode)]
        self.dead: set = set()           # indices of crashed instances
        self.report = ClusterReport(metrics=self.metrics)
        self._pending: List[Request] = []
        # crash-harvested requests waiting for re-admission: (request,
        # the decode-input token the resumed slot must feed next)
        self._reroute_queue: List[Request] = []
        # modeled stream clock: enable_timeline() attaches a FUSED clock
        # to the serial driver (one device, stages serialize);
        # run_continuous builds its own per-stage StreamTimeline. Both
        # charge the same CostModel durations, so serial vs continuous
        # makespans compare apples-to-apples.
        self.timeline: Optional[StreamTimeline] = None
        self.continuous_timeline: Optional[StreamTimeline] = None
        self.continuous_scheduler: Optional[IterationScheduler] = None
        # ground-truth Router (continuous mode): built over the REAL
        # engine names and fed chunk-granular occupancy as chunks
        # actually execute, not callback estimates
        self.router: Optional[Router] = None

    def make_engine(self, role: str, i: int, **overrides) -> Engine:
        """Engine ``i`` of ``role`` ("prefill" or "decode") as this cluster
        builds it: its options, tracer, metrics, accountant, device and
        cache dtype, with ``overrides`` on top (``kv_dtype`` for the
        launcher's ``--kv-fp8``)."""
        kw = dict(self._engine_opts[role],
                  name=("P" if role == "prefill" else "D") + str(i),
                  tracer=self.tracer, device=self.device,
                  cache_dtype=self._cache_dtype, metrics=self.metrics,
                  accountant=self.acc)
        kw.update(overrides)
        return Engine(self.cfg, self._params, **kw)

    def graph_census(self) -> Dict[str, Any]:
        """``graphs.census`` of the CUDA-graph steps of the prefill and
        every decode engine: captures, replays and the graphs' nodes."""
        engines = [self.prefill_engine, *self.decode_engines]
        return census(s for e in engines for s in e.graph_steps())

    # ---- decode-instance topology ----
    @property
    def decode_engine(self) -> Engine:
        """First live decode instance (single-instance compatibility)."""
        return self.decode_engines[self.live_decode_indices()[0]]

    def live_decode_indices(self) -> List[int]:
        out = [i for i in range(len(self.decode_engines))
               if i not in self.dead]
        if not out:
            raise InstanceDown("all-decode", 0)
        return out

    def _pick_decode(self) -> Optional[Engine]:
        """Least-loaded live instance with a free slot (ties -> lowest
        index, so placement is deterministic); None when every live
        instance is full."""
        best = None
        best_free = 0
        for i in self.live_decode_indices():
            free = len(self.decode_engines[i].free_slots())
            if free > best_free:
                best, best_free = self.decode_engines[i], free
        return best

    # ---- latency attribution / queue-span helpers ----
    def _park_queued(self, req: Request) -> None:
        """A request (re-)enters a wait queue: accountant state goes to
        ``queue`` and the wait start is remembered for the queue span."""
        self.acc.set_state(req.request_id, "queue")
        if self.tracer.enabled:
            self._queue_since.setdefault(req.request_id, self.acc.clock())

    def _unpark_queued(self, req: Request) -> None:
        """A queued request starts service: close its queue-wait span
        and move its accountant state to ``compute``."""
        self.acc.set_state(req.request_id, "compute")
        t0 = self._queue_since.pop(req.request_id, None)
        if t0 is not None and self.tracer.enabled:
            self.tracer.add("queue.wait", t0, self.acc.clock(),
                            track="router", request_id=req.request_id)

    def attribution(self) -> Dict[str, Any]:
        """Per-request TTFT/TPOT attribution report (see
        ``telemetry.LatencyAccountant.report``)."""
        self.acc.sync()
        return self.acc.report()

    # ---- modeled stream clock (serial baseline) ----
    def enable_timeline(self) -> StreamTimeline:
        """Attach a FUSED modeled clock to the serial driver: every
        stage charge serializes onto one stream, exactly how the serial
        chunk loop occupies a single python thread. The continuous
        benchmark divides its per-stage makespan by this baseline."""
        self.timeline = StreamTimeline(fused=True)
        return self.timeline

    def _modeled_prefill_times(self, req: Request, caches) -> List[float]:
        """Per-chunk modeled prefill durations for one finished payload
        (one entry for a monolithic prefill) — the same CostModel calls
        the transfer planner and the continuous scheduler charge."""
        cached = getattr(caches, "cached_tokens", 0)
        chunks = getattr(caches, "chunks", None)
        if chunks:
            return self.cost.chunk_prefill_times(
                req.total_prompt_len, [t for t, _ in chunks],
                cached_prefix=cached)
        return [self.cost.prefill_time(req.total_prompt_len,
                                       cached_prefix=cached)]

    # ---- Encode stage ----
    def _pick_encode(self) -> EncodeEngine:
        eng = self.encode_engines[self._next_encode
                                  % len(self.encode_engines)]
        self._next_encode += 1
        return eng

    def _can_skip_encode(self, req: Request, key: str) -> bool:
        """True when the prefill engine's radix tree already holds KV
        for the WHOLE image run under the (mm-hash, token-run) prefix
        key — then neither the encode forward nor the feature fetch is
        needed: the image's contribution to this prompt is entirely KV
        reuse (MM Store dedup composed with the prefix cache)."""
        pc = self.prefill_engine.prefix_cache
        if pc is None or self.cfg.encoder is not None or not req.mm_tokens:
            return False
        p = list(req.prompt_tokens)
        key_tokens = (p[:req.mm_pos] + FE.mm_key_run(key, req.mm_tokens)
                      + p[req.mm_pos:])
        run_end = req.mm_pos + req.mm_tokens
        if run_end > len(key_tokens) - 1:
            # the match is capped at n-1 (one token must be computed for
            # logits): a run reaching the last token can't be covered
            return False
        return pc.match_len(key_tokens, cap=len(key_tokens) - 1) >= run_end

    def encode(self, req: Request) -> Optional[str]:
        if not req.is_multimodal or not self.encode_engines:
            return None
        eng = self._pick_encode()
        key = FE.content_hash(req.mm_payload)
        if self._can_skip_encode(req, key):
            self.metrics.counter("encode_skips_total").inc()
            self._encode_skipped.add(req.request_id)
            if self.tracer.enabled:
                t = self.acc.clock()
                self.tracer.add("encode.skip", t, t, track=eng.name,
                                request_id=req.request_id)
            return key
        with self.tracer.span("encode", track=eng.name,
                              request_id=req.request_id):
            _, ran = eng.dispatch(req)
        if self.timeline is not None and ran:
            self.timeline.charge_encode(
                self.cost.encode_time(req.mm_tokens))
        return key

    # ---- E->P hand-off accounting (overlap arms) ----
    def _charge_ep_overlap(self, req: Request, key: str) -> None:
        """Charge the MODELED E->P hand-off latency for one feature per
        the overlap arm (the real arrays move in-process, like the P->D
        transfer). inline: zero — there is no E->P link. sync: dispatch
        plus the full feature push, serialized before prefill. async:
        hash-only announce; the transfer hides under dispatch + the
        pre-image TEXT prefill (chunks before ``mm_pos`` proceed while
        the feature is in flight), so only the exposed remainder — the
        RServe-style feature-arrival barrier at the first image-token
        position — delays the request."""
        if self.ep_overlap == "inline":
            return
        nbytes = self.cost.feature_bytes(req.mm_tokens)
        disp = self.cost.dispatch_latency(nbytes)
        xfer = self.cost.feature_transfer_time(nbytes)
        pre = 0.0
        if req.mm_pos > 0:
            pre = self.cost.chunk_prefill_times(
                req.total_prompt_len,
                [req.mm_pos, req.total_prompt_len - req.mm_pos])[0]
        if self.ep_overlap == "async":
            hint = disp + pre
            extra = disp + max(0.0, xfer - disp - pre)
        else:
            hint = 0.0
            extra = disp + xfer
        # the prefetcher records the announce->ready bookkeeping (its
        # overlap_ratio is the paper's Table 3 metric); the loop fires
        # the ready callback synchronously — features are already local
        self.prefetcher.notify(req.request_id, key, req.mm_tokens,
                               on_ready=lambda _rc: None,
                               scheduling_latency_hint=hint)
        self._ep_loop.run()
        self.acc.sync()
        t0 = self.acc.now
        self.acc.advance(extra, req.request_id, "transfer")
        if self.timeline is not None and extra > 0:
            self.timeline.charge_encode(extra)
        if self.tracer.enabled and extra > 0:
            self.tracer.add("ep.prefetch", t0, self.acc.now, track="store",
                            request_id=req.request_id,
                            mode=self.ep_overlap, nbytes=nbytes)

    # ---- Prefill stage (with FT retry + recompute on store miss) ----
    def prefill(self, req: Request, key: Optional[str]):
        if key is None:
            return self.prefill_engine.prefill_request(req)
        if req.request_id in self._encode_skipped:
            # full-run prefix hit: no features needed — prefill rides
            # the (mm-hash, token-run) radix key alone, and there is no
            # E->P transfer to charge
            self._encode_skipped.discard(req.request_id)
            return self.prefill_engine.prefill_request(req, mm_key=key)
        # layered store-fetch arm: retry with backoff per the policy
        # (attempt keys the injector's draw, so transient faults
        # heal), then fall back to the §3.2 local recompute. The
        # default NO_RETRY policy keeps the legacy single-attempt
        # behavior exactly.
        feats = self.store.get(key, record=False)
        attempt = 1
        while feats is None and attempt < self.retry.max_attempts:
            back = self.retry.backoff(attempt, key=key)
            self.metrics.counter("retry_time_seconds_total",
                                 site=SITE_STORE_FETCH).inc(back)
            self.metrics.counter("recovery_retries_total",
                                 site=SITE_STORE_FETCH).inc()
            # backoff is modeled time: charge it to the request's
            # retry component and render it on the store track
            self.acc.sync()
            t0 = self.acc.now
            self.acc.advance(back, req.request_id, "retry")
            if self.tracer.enabled:
                self.tracer.add("retry.store", t0, self.acc.now,
                                track="store",
                                request_id=req.request_id,
                                attempt=attempt)
            feats = self.store.get(key, record=False, attempt=attempt)
            attempt += 1
        if feats is None:
            # fault tolerance: recompute locally (paper §3.2) through
            # the SAME frontend forward the Encode stage ran, so
            # the rebuilt features are bit-identical — and re-put under
            # the same hash (the dedup-put now adopts the fresh tuple)
            feats = self.encode_engines[0].compute_features(
                req.mm_payload, req.mm_tokens)
            self.store.put(key, feats, feats.nbytes)
            self.report.recomputes += 1
        else:
            self._charge_ep_overlap(req, key)
        feats = torch.as_tensor(feats)[None]
        if self.cfg.encoder is not None:
            return self.prefill_engine.prefill_request(req, None, feats)
        return self.prefill_engine.prefill_request(req, mm_feats=feats,
                                                   mm_key=key)

    # ---- P->D transfer + Decode import ----
    def _build_kv_plan(self, req: Request, caches) -> TransferPlan:
        # paged payloads already carry their page-granular byte count;
        # dense payloads are measured from the actual arrays.
        nbytes = getattr(caches, "kv_nbytes", None)
        if nbytes is None:
            nbytes = cache_nbytes(caches)
        # prefix-cache hits shrink the prefill the transfer overlaps with:
        # only the computed suffix counts as per-layer compute.
        cached = getattr(caches, "cached_tokens", 0)
        chunks = getattr(caches, "chunks", None)
        if chunks:
            # streaming chunked prefill: segment k's pages (measured from
            # the actual payload) ship while segment k+1 computes; a
            # cached-prefix segment (0 computed tokens) is ready at t=0
            per_page = nbytes / max(len(caches.page_ids), 1)
            p = kv_plan_chunked(
                chunk_bytes=[n_pg * per_page for _, n_pg in chunks],
                chunk_compute=self.cost.chunk_prefill_times(
                    req.total_prompt_len, [toks for toks, _ in chunks],
                    cached_prefix=cached),
                handshake=self.cost.hw.handshake,
                link_bw=self.cost.hw.link_bw,
                page_bytes=self.cost.kv_page_bytes())
        else:
            p = kv_plan(self.kv_scheme,
                        n_layers=self.cfg.n_layers,
                        bytes_per_layer=nbytes / self.cfg.n_layers,
                        per_layer_compute=self.cost.per_layer_prefill_time(
                            req.total_prompt_len, cached_prefix=cached),
                        handshake=self.cost.hw.handshake,
                        link_bw=self.cost.hw.link_bw,
                        page_bytes=self.cost.kv_page_bytes_per_layer())
        return p

    def _count_transfer_recovery(self, rec) -> None:
        self.metrics.counter("recovery_retries_total",
                             site="transfer").inc(rec.retries)
        self.metrics.counter("transfer_replans_total").inc(
            rec.replanned_groups)
        self.metrics.counter("retry_time_seconds_total",
                             site="transfer").inc(rec.retry_time)

    def transfer_and_insert(self, req: Request, caches, first: int,
                            append_token: bool = True) -> Engine:
        p = self._build_kv_plan(req, caches)
        # deliver the plan through the fault plane: transfer groups
        # re-handshake/resend with backoff, exhausted groups replan
        # fresh; the retry time lands in retry_time_total (latency
        # accounting) and the *recovered* plan is what gets recorded.
        rec = None
        if self.faults is not None:
            p, rec = self.cost.recover_transfer(
                p, self.injector,
                self.retry if self.recovery else NO_RETRY,
                key=req.request_id, replan=self.recovery)
            self._count_transfer_recovery(rec)
        return self._insert_with_plan(req, caches, first, p, rec,
                                      append_token)

    def _insert_with_plan(self, req: Request, caches, first: int,
                          p: TransferPlan, rec, append_token: bool) -> Engine:
        engine = self._pick_decode() or self.decode_engine
        # The exposed transfer latency (and any retry backoff folded
        # into it by recovery) is modeled time — the real arrays move
        # in-process. Charge it on the accounting clock: retry time to
        # the retry component, the remaining exposure to transfer. The
        # modeled group schedule is anchored so its prefill_end lands
        # at the current accounting now (the real prefill just ended on
        # the wall clock).
        self.acc.sync()
        base = self.acc.now - p.prefill_end
        retry_t = rec.retry_time if rec is not None else 0.0
        exposed = max(0.0, p.exposed_latency - retry_t)
        self.acc.advance(retry_t, req.request_id, "retry")
        self.acc.advance(exposed, req.request_id, "transfer")
        emit_spans(self.tracer, p, base=base,
                   handshake=self.cost.hw.handshake,
                   compute_track=self.prefill_engine.name,
                   link_track=f"{self.prefill_engine.name}->{engine.name}",
                   request_id=req.request_id, recovery=rec)
        # insert may preempt a decode victim to make room; only a
        # successful admission records the transfer plan
        engine.insert(req, caches, first, append_token=append_token)
        self.acc.mark_first_token(req.request_id)
        self.acc.set_state(req.request_id, "compute")
        self.report.kv_plans.append(p)
        if self.timeline is not None:
            self.timeline.charge_decode(max(0.0, p.exposed_latency))
        return engine

    # ---- full pipeline ----
    def submit(self, req: Request) -> bool:
        """Run E->P and admit into Decode. Returns False when the decode
        pool denied admission (exhausted even after preemption would
        leave no active slot): the request re-queues at the front and
        its payload is released — it re-prefills on retry (the prefix
        cache, when enabled, makes that cheap). A request whose P->D
        transfer is unrecoverable (retry + replan exhausted, or any
        fault with recovery off) is killed and surfaced in
        ``report.lost`` — never silently dropped."""
        self.acc.open(req.request_id)
        if self._pick_decode() is None:
            self._park_queued(req)
            self._pending.append(req)
            return True
        self._unpark_queued(req)
        key = self.encode(req)
        first, caches = self.prefill(req, key)
        if self.timeline is not None:
            for dt in self._modeled_prefill_times(req, caches):
                self.timeline.charge_prefill(dt)
        try:
            self.transfer_and_insert(req, caches, first)
        except PoolExhausted:
            # insert raises before any mutation: no token was recorded
            if self.paged:
                self.prefill_engine.release_payload(caches)
            self.report.admission_denials += 1
            self._park_queued(req)
            self._pending.insert(0, req)
            return False
        except TransferError:
            if self.paged:
                self.prefill_engine.release_payload(caches)
            req.killed = True
            self.report.lost.append(req)
            self.acc.close(req.request_id)
        return True

    # ---- decode-instance crash + cross-instance re-route ----
    def _maybe_crash(self, step: int) -> None:
        """Consult the fault plane for instance crashes this step. The
        last live instance is never crashed (a zero-instance cluster has
        no recovery arm — that is a different failure class than the
        paper's elastic churn)."""
        for i in list(self.live_decode_indices()):
            if len(self.live_decode_indices()) <= 1:
                return
            if self.injector.should_fail(SITE_DECODE_CRASH, key=(i, step)):
                self._crash_instance(i)

    def _crash_instance(self, i: int) -> None:
        """Kill decode instance ``i`` mid-stream: its pool, KV, and swap
        store vanish with it. In-flight requests (active slots AND
        parked preemptees) are harvested for re-route when recovery is
        on, else killed into ``report.lost``. Either way every affected
        request is accounted for — never a silent drop."""
        if i in self.dead:
            raise InstanceDown(f"decode[{i}]", 0)
        eng = self.decode_engines[i]
        inflight = eng.mark_crashed()
        self.dead.add(i)
        if self.router is not None:
            self.router.on_instance_down(eng.name)
        self.report.instance_crashes += 1
        self.metrics.counter("instance_crashes_total",
                             engine=eng.name).inc()
        if self.tracer.enabled:
            t = self.acc.clock()
            self.tracer.add("crash", t, t, track=eng.name,
                            harvested=len(inflight))
        for req in inflight:
            if self.recovery:
                self._park_queued(req)
                self._reroute_queue.append(req)
            else:
                req.killed = True
                self.report.lost.append(req)
                self.acc.close(req.request_id)

    def _reroute_one(self, req: Request) -> bool:
        """Re-route one crash-harvested request to a surviving instance.

        At harvest time the request's KV covered
        ``prompt + output_tokens[:-1]`` and the next decode input was
        ``output_tokens[-1]`` — so a re-prefill of exactly that sequence
        (riding the prefix cache: only the uncached suffix recomputes)
        rebuilds bit-identical KV on the survivor, and ``insert`` with
        ``append_token=False`` resumes decode at the exact position.
        Returns False (request back at the queue head) when the
        survivor's pool denied admission — retried after decode drains."""
        seq = list(req.prompt_tokens) + list(req.output_tokens[:-1])
        shadow = Request(prompt_tokens=seq, max_new_tokens=1,
                         mm_payload=req.mm_payload,
                         mm_tokens=req.mm_tokens, mm_pos=req.mm_pos,
                         priority=req.priority)
        # the shadow prefill's charges (store retries, transfer
        # exposure) bill the original request's ledger entry
        self.acc.alias(shadow.request_id, req.request_id)
        self._unpark_queued(req)
        key = self.encode(shadow)
        first, caches = self.prefill(shadow, key)
        try:
            self.transfer_and_insert(req, caches,
                                     int(req.output_tokens[-1]),
                                     append_token=False)
        except PoolExhausted:
            if self.paged:
                self.prefill_engine.release_payload(caches)
            self.report.admission_denials += 1
            self._park_queued(req)
            self._reroute_queue.insert(0, req)
            return False
        except TransferError:
            if self.paged:
                self.prefill_engine.release_payload(caches)
            req.killed = True
            self.report.lost.append(req)
            self.acc.close(req.request_id)
            return True
        self.report.reroutes += 1
        return True

    def run_until_done(self, max_steps: int = 1000) -> List[Request]:
        steps = 0
        done: List[Request] = []

        def live():
            return [self.decode_engines[i]
                    for i in self.live_decode_indices()]

        while ((any(e.n_active or e.preempted for e in live())
                or self._pending or self._reroute_queue)
               and steps < max_steps):
            self._maybe_crash(steps)
            for eng in live():
                if eng.n_active or eng.preempted:
                    if self.timeline is not None and eng.n_active:
                        batch = eng.n_active
                        kv = sum(r.total_prompt_len + len(r.output_tokens)
                                 for r in eng.slots if r is not None) / batch
                        self.timeline.charge_decode(
                            self.cost.decode_step_time(batch, kv))
                    for r, _t, d in eng.decode_step():
                        if d:
                            done.append(r)
                            self.acc.close(r.request_id,
                                           n_output_tokens=len(
                                               r.output_tokens))
                # swap-loss casualties (no recompute arm available)
                while eng.lost:
                    lost = eng.lost.pop(0)
                    self.report.lost.append(lost)
                    self.acc.close(lost.request_id)
            # reconcile ledger states with where each request actually
            # is after the step (preemption may have parked a request:
            # parked time is queueing; resumed requests compute again),
            # then fold in the engines' measured swap durations — the
            # notes reclassify already-charged time, so they drain only
            # after the sync inside set_state has charged it.
            for eng in live():
                for pr in eng.preempted:
                    self.acc.set_state(pr.req.request_id, "queue")
                for r in eng.slots:
                    if r is not None:
                        self.acc.set_state(r.request_id, "compute")
            self.acc.sync()
            for eng in self.decode_engines:
                eng.drain_notes()
            self.prefill_engine.drain_notes()
            while self._reroute_queue and self._pick_decode() is not None:
                if not self._reroute_one(self._reroute_queue.pop(0)):
                    break                  # denied: wait for drain
            while self._pending and self._pick_decode() is not None:
                if not self.submit(self._pending.pop(0)):
                    break                  # denied: wait for decode to drain
            steps += 1
        self._finalize(done)
        return done

    def _finalize(self, done: List[Request]) -> None:
        """Close the run out: sync accounting, drain swap notes, fold
        engine counters into the report (shared by both drivers). Any
        engine-side casualty still sitting in ``eng.lost`` (filled
        outside a driver's own drain point) lands in ``report.lost``
        with its accountant record closed — losses are never silent."""
        self.acc.sync()
        for eng in self.decode_engines:
            self._harvest_engine_lost(eng, None)
            eng.drain_notes()
        self.prefill_engine.drain_notes()
        self.report.completed.extend(done)
        self.report.preemptions = sum(e.preempt_count
                                      for e in self.decode_engines)
        self.report.swapped_pages = sum(
            e.swap_out_pages_total + e.swap_in_pages_total
            for e in self.decode_engines)
        if self.paged:
            self.report.swap_losses = sum(e.pool.swap_lost_total
                                          for e in self.decode_engines)
        if self.prefetcher.records:
            self.metrics.gauge("ep_overlap_ratio").set(
                self.prefetcher.mean_overlap_ratio)

    # ---- continuous batching: the iteration-level cluster driver ----
    def _submit_continuous(self, req: Request, sched: IterationScheduler,
                           tl: StreamTimeline, router: Router) -> PrefillJob:
        """Fold the Encode dispatch into the serving loop and queue one
        prefill job. The async arm's E->P feature arrival becomes a REAL
        dependency edge: ``feature_ready_at`` gates only the chunk whose
        window overlaps the image run, so pre-image text chunks start
        while the feature is still in flight; the sync arm gates the
        whole job (``ready_at``); inline charges the encode forward on
        the prefill stream and has no link to wait on."""
        pe = self.prefill_engine
        # jobs the engine cannot serve through the resumable chunk state
        # machine — whisper-class encoder-decoder prefills (cross-attn
        # needs the full enc frames), or a non-chunked/non-paged prefill
        # engine — run MONOLITHIC: one unchunkable work item through
        # ``prefill_request``, still scheduled/admitted like any job.
        monolithic = (self.cfg.encoder is not None or not pe.paged
                      or pe._prefill_suffix is None)
        ready_at = 0.0
        feature_ready_at = 0.0
        meta: Dict[str, Any] = {}
        key = None
        if req.is_multimodal and self.encode_engines:
            eng = self._pick_encode()
            key = FE.content_hash(req.mm_payload)
            if self._can_skip_encode(req, key):
                # full-run radix hit: no forward, no features, no barrier
                self.metrics.counter("encode_skips_total").inc()
            else:
                with self.tracer.span("encode", track=eng.name,
                                      request_id=req.request_id):
                    _, ran = eng.dispatch(req)
                # the feature itself is fetched LAZILY at the barrier
                # chunk (``_fetch_features_continuous``) so a store
                # fault or mid-flight eviction surfaces inside the
                # iteration loop, where the §3.2 retry/recompute arms
                # are schedulable work — not at submit time.
                meta["needs_feats"] = True
                t_enc = self.cost.encode_time(req.mm_tokens) if ran else 0.0
                if self.ep_overlap == "inline":
                    if t_enc:
                        tl.charge_prefill(t_enc)
                else:
                    enc_done = (tl.charge_encode(t_enc) if t_enc
                                else tl.t_encode)
                    router.on_busy_until(eng.name, enc_done)
                    nbytes = self.cost.feature_bytes(req.mm_tokens)
                    arrival = (enc_done + self.cost.dispatch_latency(nbytes)
                               + self.cost.feature_transfer_time(nbytes))
                    if self.ep_overlap == "async" and not monolithic:
                        feature_ready_at = arrival
                    else:
                        # sync arm — or a monolithic prefill, whose one
                        # work item always overlaps the feature
                        ready_at = arrival
                    # announce->ready bookkeeping (Table-3 overlap ratio)
                    self.prefetcher.notify(req.request_id, key,
                                           req.mm_tokens,
                                           on_ready=lambda _rc: None)
                    self._ep_loop.run()
        meta["mm_key"] = key
        # whisper-class enc frames live on the ENCODER side: they do not
        # occupy decoder prefill positions
        n_mm = (req.mm_tokens
                if key is not None and self.cfg.encoder is None else 0)
        n_tokens = len(req.prompt_tokens) + n_mm
        job = PrefillJob(
            req=req, n_tokens=n_tokens,
            chunk=(n_tokens if monolithic
                   else pe.prefill_chunk if pe.chunked_prefill
                   else pe.max_len),
            ready_at=ready_at, feature_ready_at=feature_ready_at)
        if monolithic:
            meta["monolithic"] = True
        job.meta.update(meta)
        self._park_queued(req)
        router.on_enqueue(pe.name, job.n_tokens, rid=str(req.request_id))
        return sched.submit(job)

    def _restart_one_prefill(self, sched: IterationScheduler) -> bool:
        """Pool-deadlock recovery: every schedulable chunk stalled on
        the allocator and nothing else can free pages. Abort the
        YOUNGEST in-flight task (least work lost; the prefix cache, when
        on, keeps its finished chunks cheap to redo) and send its job
        back to the waiting queue. The Router ledger self-corrects: the
        restarted task's re-retirements are capped at what the request
        still owes."""
        for job in reversed(sched.live):
            if job.task is not None and not job.task.closed:
                job.task.abort()
                job.task = None
                job.meta.pop("chunk_times", None)
                sched.live.remove(job)
                sched.waiting.append(job)
                sched.note_stall(job, "restart")
                self._park_queued(job.req)
                return True
        return False

    def _fetch_features_continuous(self, job: PrefillJob,
                                   sched: IterationScheduler,
                                   tl: StreamTimeline) -> bool:
        """Lazy E->P feature fetch at the barrier chunk, with the store
        failure domain as SCHEDULER work instead of a synchronous retry
        loop: a faulted fetch (or a mid-flight eviction) pushes the
        job's barrier clock by the capped retry backoff — the plan
        composes around the parked job — and on policy exhaustion the
        §3.2 recompute runs as a schedulable encode work item whose
        modeled completion gates only this job's barrier chunk. Returns
        True once ``meta["mm_feats"]`` is populated; False means the
        job stalled this iteration (barrier pushed into the future)."""
        req = job.req
        key = job.meta["mm_key"]
        rid = req.request_id
        barrier = "ready_at" if job.meta.get("monolithic") \
            else "feature_ready_at"
        attempt = job.meta.get("store_attempts", 0)
        feats = self.store.get(key, record=False, attempt=attempt)
        if feats is not None:
            job.meta["mm_feats"] = torch.as_tensor(feats)[None]
            return True
        attempt += 1
        job.meta["store_attempts"] = attempt
        base = max(tl.t_prefill, job.ready_at, job.feature_ready_at)
        nxt = self.retry.next_retry_at(base, attempt, key=key)
        if nxt is not None:
            back = nxt - base
            self.metrics.counter("retry_time_seconds_total",
                                 site=SITE_STORE_FETCH).inc(back)
            self.metrics.counter("recovery_retries_total",
                                 site=SITE_STORE_FETCH).inc()
            self.acc.sync()
            t0 = self.acc.now
            self.acc.advance(back, rid, "retry")
            if self.tracer.enabled:
                self.tracer.add("retry.store", t0, self.acc.now,
                                track="store", request_id=rid,
                                attempt=attempt)
            setattr(job, barrier, nxt)
            sched.note_stall(job, "store_retry")
            return False
        # policy exhausted (or single-attempt NO_RETRY): §3.2 local
        # recompute through the SAME frontend forward — the
        # rebuilt features are bit-identical — charged on the ENCODE
        # stream as its own work item; its completion is this job's new
        # feature barrier and every other job keeps stepping meanwhile.
        feats = self.encode_engines[0].compute_features(
            req.mm_payload, req.mm_tokens)
        self.store.put(key, feats, feats.nbytes)
        self.report.recomputes += 1
        self.metrics.counter("continuous_recomputes_total").inc()
        t_enc = self.cost.encode_time(req.mm_tokens)
        done = tl.charge_encode(t_enc, not_before=tl.t_prefill)
        setattr(job, barrier, max(getattr(job, barrier), done))
        job.meta["mm_feats"] = torch.as_tensor(feats)[None]
        sched.note_stall(job, "store_recompute")
        # stall until the modeled clock reaches the recompute completion
        return False

    def _advance_monolithic(self, job: PrefillJob,
                            sched: IterationScheduler, tl: StreamTimeline,
                            router: Router) -> bool:
        """Run an UNCHUNKABLE job as one scheduled work item: the whole
        prefill through ``prefill_request`` (whisper-class cross-attn
        decoders, or engines without the paged suffix step). The job
        admits/parks/retries exactly like a chunked one — only the
        prefill itself is indivisible."""
        pe = self.prefill_engine
        req = job.req
        rid = str(req.request_id)
        if job.meta.get("needs_feats") and job.meta.get("mm_feats") is None:
            if not self._fetch_features_continuous(job, sched, tl):
                return False
        feats = job.meta.get("mm_feats")
        self._unpark_queued(req)
        try:
            with self.tracer.span("prefill.monolithic", track=pe.name,
                                  request_id=req.request_id,
                                  tokens=job.n_tokens):
                if self.cfg.encoder is not None and feats is not None:
                    first, payload = pe.prefill_request(req, None, feats)
                elif feats is not None:
                    first, payload = pe.prefill_request(
                        req, mm_feats=feats, mm_key=job.meta.get("mm_key"))
                elif job.meta.get("mm_key") is not None:
                    first, payload = pe.prefill_request(
                        req, mm_key=job.meta["mm_key"])
                else:
                    first, payload = pe.prefill_request(req)
        except PoolExhausted:
            # the allocator raises before any mutation: retry after
            # decode drain / admission frees prefill pool pages
            sched.note_stall(job, "pool")
            self._park_queued(req)
            return False
        router.on_start(pe.name, 0, rid=rid)
        cached = getattr(payload, "cached_tokens", 0)
        dur = self.cost.prefill_time(max(job.n_tokens, 1),
                                     cached_prefix=cached)
        nb = max(job.ready_at, job.feature_ready_at)
        t_done = tl.charge_prefill(dur, not_before=nb)
        router.on_prefill_progress(pe.name, job.n_tokens, rid=rid)
        router.on_busy_until(pe.name, t_done)
        job.result = (first, payload)
        job.meta["prefill_done"] = t_done
        sched.mark_ready(job)
        return True

    def _advance_chunk(self, job: PrefillJob, sched: IterationScheduler,
                       tl: StreamTimeline, router: Router) -> bool:
        """Run one chunk of one scheduled job: lazy task creation (the
        prefix match retires cached tokens immediately), feature supply
        once the barrier chunk is reached, then the suffix
        prefill — with chunk-granular occupancy reported to the Router
        as the chunk ACTUALLY executes (ground truth, not callbacks)."""
        if job.meta.get("monolithic"):
            return self._advance_monolithic(job, sched, tl, router)
        pname = self.prefill_engine.name
        rid = str(job.req.request_id)
        if job.task is None:
            job.task = self.prefill_engine.start_prefill_task(
                job.req, None, job.meta.get("mm_key"),
                defer_features=bool(job.meta.get("needs_feats")))
            self._unpark_queued(job.req)
            # cached-prefix tokens retire at task creation; computed
            # tokens retire per executed chunk below — conservation:
            # cached + sum(chunks) == the on_enqueue total
            router.on_start(pname, job.task.done, rid=rid)
            job.meta["chunk_times"] = list(self.cost.chunk_prefill_times(
                job.n_tokens, job.task.planned_chunk_tokens(),
                cached_prefix=job.task.done))
        task = job.task
        needed_feats = task.needs_features_next()
        if needed_feats and job.meta.get("needs_feats") \
                and job.meta.get("mm_feats") is None:
            if not self._fetch_features_continuous(job, sched, tl):
                return False
        if needed_feats and job.meta.get("mm_feats") is not None:
            task.supply_features(job.meta["mm_feats"])
        try:
            computed = task.run_chunk()
        except PoolExhausted:
            # allocator raised before any mutation: stall + retry after
            # decode drain / admission frees prefill pool pages
            sched.note_stall(job, "pool")
            return False
        except BaseException:
            task.abort()
            raise
        times = job.meta["chunk_times"]
        dur = times.pop(0) if times else 0.0
        nb = job.ready_at
        if needed_feats:
            nb = max(nb, job.feature_ready_at)
        t_done = tl.charge_prefill(dur, not_before=nb)
        router.on_prefill_progress(pname, computed, rid=rid)
        router.on_busy_until(pname, t_done)
        if task.finished:
            job.result = task.finish()
            job.meta["prefill_done"] = t_done
            sched.mark_ready(job)
        return True

    def _admit_with_faults(self, job: PrefillJob, req: Request, payload,
                           first: int, append_token: bool,
                           sched: IterationScheduler,
                           tl: StreamTimeline) -> Optional[Engine]:
        """Admit one ready job through the fault plane WITHOUT blocking
        the iteration on a synchronous retry loop. Each admission pass
        makes ONE delivery attempt of the whole plan; a transfer fault
        parks the job at the ready-queue head with a ``retry_at`` clock
        (capped backoff, charged to the request's retry component as a
        dependency edge — the decode device is not busy waiting) and the
        plan composes around it. On policy exhaustion the serial arm
        fires: full grouped retry + fresh replan of missing groups; if
        THAT fails, TransferError propagates and the caller records the
        loss. Returns None when parked."""
        p = self._build_kv_plan(req, payload)
        rid = req.request_id
        attempt = job.meta.get("xfer_attempts", 0) + 1
        if not self.recovery or attempt >= self.retry.max_attempts:
            # the last word: the grouped retry/replan arm (recovery off:
            # single attempt, no replan — the loss baseline)
            p, rec = self.cost.recover_transfer(
                p, self.injector,
                self.retry if self.recovery else NO_RETRY,
                key=(rid, "replan"), replan=self.recovery)
            self._count_transfer_recovery(rec)
            return self._insert_with_plan(req, payload, first, p, rec,
                                          append_token)
        one_shot = RetryPolicy(max_attempts=1, jitter=0.0,
                               seed=self.retry.seed)
        try:
            p, rec = self.cost.recover_transfer(
                p, self.injector, one_shot, key=(rid, attempt),
                replan=False)
        except TransferError:
            job.meta["xfer_attempts"] = attempt
            base = max(tl.t_prefill, job.meta.get("prefill_done", 0.0))
            nxt = self.retry.next_retry_at(base, attempt, key=rid)
            back = nxt - base
            self.metrics.counter("recovery_retries_total",
                                 site="transfer").inc()
            self.metrics.counter("retry_time_seconds_total",
                                 site="transfer").inc(back)
            self.metrics.counter("sched_retry_parks_total",
                                 engine=self.prefill_engine.name).inc()
            self.acc.sync()
            t0 = self.acc.now
            self.acc.advance(back, rid, "retry")
            if self.tracer.enabled:
                self.tracer.add("retry.transfer", t0, self.acc.now,
                                track="router", request_id=rid,
                                attempt=attempt)
            sched.park_ready(job, nxt)
            return None
        self._count_transfer_recovery(rec)
        return self._insert_with_plan(req, payload, first, p, rec,
                                      append_token)

    def _harvest_reroutes(self, sched: IterationScheduler,
                          tl: StreamTimeline, router: Router) -> None:
        """Scheduler-visible crash/swap-loss recovery: every harvested
        request re-enters the iteration loop as a fresh ``PrefillJob``
        over ``prompt + output_tokens[:-1]`` (the prefix cache keeps the
        re-prefill cheap); at admission the ORIGINAL request resumes
        decode on a survivor with ``append_token=False`` — bit-identical
        greedy resume, no global drain, other requests keep stepping."""
        while self._reroute_queue:
            req = self._reroute_queue.pop(0)
            seq = list(req.prompt_tokens) + list(req.output_tokens[:-1])
            shadow = Request(prompt_tokens=seq, max_new_tokens=1,
                             mm_payload=req.mm_payload,
                             mm_tokens=req.mm_tokens, mm_pos=req.mm_pos,
                             priority=req.priority)
            # the shadow prefill's charges (store retries, transfer
            # exposure) bill the original request's ledger entry
            self.acc.alias(shadow.request_id, req.request_id)
            self.metrics.counter("continuous_reroute_jobs_total").inc()
            job = self._submit_continuous(shadow, sched, tl, router)
            job.meta["resume"] = (req, int(req.output_tokens[-1]))

    def _harvest_engine_lost(self, eng: Engine,
                             sched: Optional[IterationScheduler]) -> None:
        """Reconcile one engine's swap-loss casualties with the
        scheduler's live window: requests the ENGINE could not rebuild
        (multimodal feature embeddings are not retained; cross-attn
        decoders have no suffix step) re-enter the waiting queue as
        re-prefill jobs instead of vanishing — the cluster holds what
        the engine lost (payload bytes, encode recompute). Without
        recovery (or on the serial driver) they surface in
        ``report.lost`` exactly as before."""
        while eng.lost:
            lost = eng.lost.pop(0)
            if sched is not None and self.recovery and lost.output_tokens:
                lost.killed = False
                self.metrics.counter("continuous_harvests_total",
                                     source="swap_lost").inc()
                self._park_queued(lost)
                self._reroute_queue.append(lost)
            else:
                self.report.lost.append(lost)
                self.acc.close(lost.request_id)

    def _decode_iteration(self, done: List[Request], tl: StreamTimeline,
                          router: Router,
                          sched: Optional[IterationScheduler] = None) -> bool:
        """One lock-step decode iteration across every live instance —
        instances are separate devices, so the modeled stream advances
        by the SLOWEST instance's step, not the sum."""
        durs = []
        stepped = False
        for i in self.live_decode_indices():
            eng = self.decode_engines[i]
            if not (eng.n_active or eng.preempted):
                continue
            stepped = True
            if eng.n_active:
                batch = eng.n_active
                kv = sum(r.total_prompt_len + len(r.output_tokens)
                         for r in eng.slots if r is not None) / batch
                durs.append(self.cost.decode_step_time(batch, kv))
            for r, _t, d in eng.decode_step():
                if d:
                    done.append(r)
                    router.on_decode_leave(eng.name)
                    self.acc.close(r.request_id,
                                   n_output_tokens=len(r.output_tokens))
            for pr in eng.preempted:
                self.acc.set_state(pr.req.request_id, "queue")
            for r in eng.slots:
                if r is not None:
                    self.acc.set_state(r.request_id, "compute")
            self._harvest_engine_lost(eng, sched)
        if durs:
            tl.charge_decode(max(durs))
        return stepped

    def run_continuous(self, reqs: List[Request], *,
                       max_steps: int = 100_000,
                       max_live_prefills: Optional[int] = None,
                       chunk_budget_tokens: Optional[int] = None,
                       adaptive_chunking: bool = False,
                       on_step=None) -> List[Request]:
        """Serve ``reqs`` with iteration-level (continuous) batching:
        every device step executes one scheduler-produced
        :class:`BatchPlan` — ready prefill chunks from DIFFERENT
        requests interleave on the prefill stream, finished prefills
        admit into free decode slots (evicting via the engine's
        ``pick_preemption_victim`` path under pool pressure), and all
        active decodes advance lock-step — while a per-stage
        :class:`StreamTimeline` tracks the modeled makespan and a
        ground-truth :class:`Router` sees chunk-granular occupancy.
        Greedy outputs are bit-identical to the serial ``submit`` +
        ``run_until_done`` path: both drivers execute the same
        ``PrefillTask`` chunk sequence and the same forwards.

        The loop composes with the fault plane end-to-end: decode
        crashes harvest in-flight work back into the scheduler as
        re-prefill jobs, transfer faults park the failed admission
        behind a ``retry_at`` barrier, store faults take the §3.2
        retry/recompute arms as schedulable work, and swap losses the
        engine cannot rebuild re-enter ``waiting``. Completed greedy
        outputs stay bit-identical to the zero-fault run; ``lost`` is
        the only other exit. ``on_step(step)`` (when given) runs after
        every iteration — tests hook per-iteration leak audits there."""
        pe = self.prefill_engine
        tl = StreamTimeline()
        self.continuous_timeline = tl
        specs = [InstanceSpec(e.name, ("E",)) for e in self.encode_engines]
        specs.append(InstanceSpec(pe.name, ("P",)))
        specs += [InstanceSpec(e.name, ("D",)) for e in self.decode_engines]
        router = Router(Deployment("continuous", tuple(specs), len(specs)))
        if pe.prefix_cache is not None:
            router.register_prefix_cache(pe.name, pe.prefix_cache)
        self.router = router
        if max_live_prefills is None:
            if pe.paged:
                # size the live window to what the prefill pool can
                # actually hold in-flight at once (worst case: every
                # live task grows to max_len) — interleaving more would
                # only stall on alloc
                per_req = max(1, pe.max_len // pe.page_size)
                max_live_prefills = min(
                    4, max(1, (pe.pool.n_pages - 1) // per_req))
            else:
                # dense engines hold no pool pages mid-prefill
                # (monolithic jobs): the window only bounds fairness
                max_live_prefills = 4
        sched = IterationScheduler(max_live_prefills=max_live_prefills,
                                   chunk_budget_tokens=chunk_budget_tokens,
                                   adaptive_chunking=adaptive_chunking)
        # the engine's page_holders audits scheduler-held payloads
        # (ready-but-unadmitted prefills) through this reference; the
        # cluster-level handle lets benches/tests read step and stall
        # counts after the drain
        pe.scheduler = sched
        self.continuous_scheduler = sched
        for req in reqs:
            self.acc.open(req.request_id)
            self._submit_continuous(req, sched, tl, router)
        done: List[Request] = []
        steps = 0
        while (sched.has_work or self._reroute_queue
               or any(self.decode_engines[i].n_active
                      or self.decode_engines[i].preempted
                      for i in self.live_decode_indices())):
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"continuous drain made no progress in {max_steps} "
                    f"steps (stalls: {sched.stall_counts})")
            # mid-iteration failure domains first: a decode instance may
            # crash between any two steps — its in-flight + preempted
            # requests re-enter the scheduler as re-prefill jobs while
            # everything else keeps stepping (no global drain)
            if self.faults is not None:
                self._maybe_crash(steps)
            if self._reroute_queue:
                self._harvest_reroutes(sched, tl, router)
            free = sum(len(self.decode_engines[i].free_slots())
                       for i in self.live_decode_indices())
            active = sum(self.decode_engines[i].n_active
                         + len(self.decode_engines[i].preempted)
                         for i in self.live_decode_indices())
            plan = sched.plan(now=tl.t_prefill, free_slots=free,
                              active_decode=active)
            progressed = 0
            n_admitted = n_chunked = 0
            with self.tracer.span("sched.step", track="router",
                                  step=plan.step,
                                  n_chunks=len(plan.chunks),
                                  n_admit=len(plan.admit)):
                for job in plan.admit:
                    first, payload = job.result
                    # a crash-harvested job resumes the ORIGINAL request
                    # on the survivor: re-prefilled KV + insert with
                    # append_token=False at the exact decode position
                    resume = job.meta.get("resume")
                    req = resume[0] if resume is not None else job.req
                    tok = resume[1] if resume is not None else first
                    append = resume is None
                    try:
                        if self.faults is not None:
                            engine = self._admit_with_faults(
                                job, req, payload, tok, append, sched, tl)
                            if engine is None:
                                continue      # parked behind retry_at
                        else:
                            engine = self.transfer_and_insert(
                                req, payload, tok, append_token=append)
                    except (NoFreeSlot, PoolExhausted):
                        # insert raises before any mutation; the payload
                        # stays with the job for the next attempt
                        self.report.admission_denials += 1
                        sched.requeue_ready(job)
                        continue
                    except TransferError:
                        # retry + grouped replan exhausted (or recovery
                        # off): surface the loss — never a silent drop
                        if self.paged:
                            pe.release_payload(payload)
                        req.killed = True
                        self.report.lost.append(req)
                        self.acc.close(req.request_id)
                        progressed += 1
                        continue
                    if resume is not None:
                        self.report.reroutes += 1
                    p = self.report.kv_plans[-1]
                    # KV-transfer exposure is handshake round-trip
                    # latency, not link occupancy (wire bytes move in
                    # microseconds): it gates THIS request's decode
                    # join but does not keep the Decode device busy.
                    # The serial driver blocks on each transfer, so the
                    # fused baseline still pays it as device time. A
                    # parked job's retry_at barrier gates the join too.
                    tl.charge_decode(
                        0.0,
                        not_before=max(job.meta.get("prefill_done", 0.0),
                                       job.retry_at)
                        + max(0.0, p.exposed_latency))
                    router.on_decode_join(engine.name)
                    n_admitted += 1
                    progressed += 1
                for job in plan.chunks:
                    if self._advance_chunk(job, sched, tl, router):
                        n_chunked += 1
                        progressed += 1
                decoded = plan.decode and self._decode_iteration(
                    done, tl, router, sched)
                if decoded:
                    progressed += 1
            # same scheduler telemetry the fused-engine execute_plan
            # emits, labeled on the Prefill instance driving the loop
            M = self.metrics
            M.counter("sched_steps_total", engine=pe.name).inc()
            if n_chunked:
                M.counter("sched_chunks_total",
                          engine=pe.name).inc(n_chunked)
            if n_admitted:
                M.counter("sched_admissions_total",
                          engine=pe.name).inc(n_admitted)
            if n_chunked and (n_admitted or decoded):
                M.counter("sched_mixed_steps_total", engine=pe.name).inc()
            if not progressed:
                # nothing executed: either some job waits on a FUTURE
                # arrival (jump the modeled clock to the earliest one —
                # a pool-stalled job's elapsed barrier must not mask a
                # parked job's retry_at, or the retry never matures and
                # its payload pages deadlock the pool), or the prefill
                # pool is deadlocked by partial in-flight tasks (abort
                # the youngest and requeue it)
                t = sched.next_barrier_time(after=tl.t_prefill)
                if t is not None:
                    tl.t_prefill = t
                elif not self._restart_one_prefill(sched):
                    raise RuntimeError(
                        f"continuous scheduler deadlock at step "
                        f"{plan.step} (stalls: {sched.stall_counts})")
            self.acc.sync()
            for eng in self.decode_engines:
                eng.drain_notes()
            pe.drain_notes()
            if not sched.has_prefill_work:
                # prefill stream drained: collapse the Router's stale
                # busy_until so the replica reads idle again
                router.on_idle(pe.name, tl.t_prefill)
            if on_step is not None:
                on_step(steps)
        self._finalize(done)
        return done

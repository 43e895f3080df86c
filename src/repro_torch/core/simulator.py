"""End-to-end EPD-Serve simulator.

Executes a request trace against a deployment topology on the
discrete-event engine, with:

* modality-aware multi-path routing + least-loaded dispatch (scheduler),
* MM Store dedup + E->P async feature prefetching (ep_prefetch),
* P->D hierarchical grouped KV transmission (kv_transfer),
* physical co-location with operator-level interference (colocation),
* stage service times from the roofline cost model (costmodel).

Instance execution semantics:
* every instance runs ONE task at a time (its own serial stream);
* monolithic instances (TP1/TP2, 'PD', 'EP') put Encode/Prefill tasks and
  decode iterations in one queue — E/P tasks take priority, which is the
  vLLM-style behaviour that starves Decode under load (paper §1);
* co-located instances (same ``coloc_group``) run concurrently but pay
  the interference slowdown for whatever their chip-mates execute;
* Decode runs as back-to-back batched iterations, one token per request
  per iteration (continuous batching).

This is the scale model used for the paper's Tables 2/5 and Figs 8-17;
the REAL-compute path (actual PyTorch engines wired through the same MM
Store / scheduler / transfer planner) lives in repro_torch.core.cluster.
A copy of ``repro/core/simulator.py`` with its imports re-pointed: pure
Python, so both packages give the same metrics for the same inputs.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core import colocation
from repro_torch.core.costmodel import CostModel, Hardware, V5E
from repro_torch.core.deployment import Deployment, parse
from repro_torch.core.ep_prefetch import EPPrefetcher
from repro_torch.core.faults import (DEFAULT_RETRY, NO_RETRY, FaultInjector,
                               FaultPlan, RetryPolicy, TransferError)
from repro_torch.core.events import EventLoop
from repro_torch.core.kv_transfer import (emit_spans, plan as kv_plan,
                                    plan_chunked as kv_plan_chunked)
from repro_torch.core.telemetry import (NULL_TRACER, LatencyAccountant,
                                  MetricsRegistry, Tracer, quantile)
from repro_torch.core.mm_store import MMStore
from repro_torch.core.scheduler import (Router, VictimCandidate,
                                  pick_preemption_victim)
from repro_torch.models.frontend import encode_tokens_for_image
from repro_torch.serving.kv_pool import pages_for
from repro_torch.serving.request import Request


# ---------------------------------------------------------------------------
# Workload
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DatasetSpec:
    name: str
    mm_fraction: float
    resolution: Tuple[int, int]
    text_tokens_mean: float
    output_tokens: int = 64
    unique_images: int = 0        # 0 => every image unique (no dedup hits)
    # shared-prefix workload (system prompts / few-shot templates):
    # each request prepends one of `prefix_groups` shared prefixes of
    # `prefix_tokens` tokens to its (unique) tail. 0 => no shared prefixes.
    prefix_groups: int = 0
    prefix_tokens: int = 0


# paper §4.1
SHAREGPT_4O = DatasetSpec("ShareGPT-4o", 1.0, (802, 652), 9.6)
VISUALWEB = DatasetSpec("VisualWebInstruct", 0.5, (1280, 720), 63.1)


def gen_requests(spec: DatasetSpec, n: int, rate: float,
                 seed: int = 0) -> List[Request]:
    """Poisson arrivals at `rate` req/s; modality mix per the dataset."""
    rng = random.Random(seed)
    reqs = []
    t = 0.0
    mm_tokens = encode_tokens_for_image(spec.resolution)
    for i in range(n):
        t += rng.expovariate(rate)
        is_mm = rng.random() < spec.mm_fraction
        text_len = max(1, int(rng.gauss(spec.text_tokens_mean,
                                        spec.text_tokens_mean * 0.3)))
        payload = None
        ntok = 0
        if is_mm:
            img_id = (rng.randrange(spec.unique_images)
                      if spec.unique_images else i)
            payload = f"{spec.name}-img-{img_id}".encode()
            ntok = mm_tokens
        if spec.prefix_groups:
            g = rng.randrange(spec.prefix_groups)
            prompt = ([1_000_000 + g * spec.prefix_tokens + j
                       for j in range(spec.prefix_tokens)]
                      + [2_000_000 + i * 1024 + j for j in range(text_len)])
        else:
            # per-request-unique tokens: without them every prompt would
            # be a literal prefix of every longer one and a prefix-cache
            # run over a legacy dataset would report phantom hits
            prompt = [2_000_000 + i * 1024 + j for j in range(text_len)]
        reqs.append(Request(
            prompt_tokens=prompt,
            max_new_tokens=spec.output_tokens,
            mm_payload=payload, mm_tokens=ntok, t_arrival=t))
    return reqs


# ---------------------------------------------------------------------------
# Simulator
# ---------------------------------------------------------------------------

@dataclass
class SimConfig:
    deployment: str = "E-P-D"
    kv_scheme: str = "grouped"          # one_shot | layer_wise | grouped
    ep_async: bool = True
    decode_batch_max: int = 512
    replicas: int = 1
    hw: Hardware = V5E
    kv_page_tokens: int = 0             # paged KV pool page size (0 = dense)
    # per-Prefill-instance radix prefix caches + cache-aware routing;
    # prefill service time then covers only the uncached suffix.
    prefix_cache: bool = False
    cache_aware_routing: bool = True    # False: least-loaded only (ablation)
    # capacity of each pool-less sim tree (tokens, LRU-evicted): models a
    # bounded KV pool and keeps long simulations from growing one radix
    # node per unique prompt tail forever
    prefix_cache_tokens: int = 65536
    # chunked prefill + streaming P->D transfer: prefill runs in
    # fixed-size chunks whose KV ships while the next chunk computes
    # (kv_transfer.plan_chunked); prefill occupancy retires pending
    # tokens chunk by chunk (Router.on_prefill_progress). Each extra
    # chunk costs one launch overhead — the price of streaming.
    chunked_prefill: bool = False
    prefill_chunk_tokens: int = 256
    # Decode-side KV capacity + page-level preemption. decode_kv_pages
    # bounds each Decode instance's page pool (0 = unbounded, the
    # legacy behavior); admission then checks pages, not just batch
    # slots. When decode growth overflows the pool mid-stream:
    # preemption=False kills the victim (the pre-preemption baseline),
    # preemption=True swaps it to host (CostModel.swap_time charged in
    # the decode stream) and resumes it when pages free up — same
    # victim policy as the real engine (scheduler.pick_preemption_victim).
    decode_kv_pages: int = 0
    preemption: bool = False
    # failure-domain chaos layer: a seeded FaultPlan arms store-fetch
    # and P->D transfer faults; `retry` is the typed backoff policy the
    # recovery arms charge into latency; fault_recovery=False is the
    # losing baseline (any transfer fault kills the request).
    faults: Optional[FaultPlan] = None
    retry: Optional[RetryPolicy] = None
    fault_recovery: bool = True
    # observability plane (core.telemetry): pass a Tracer to get spans
    # on simulated time, a MetricsRegistry to share counters across
    # runs. None keeps the hot paths allocation-free (NULL_TRACER).
    tracer: Optional[Tracer] = None
    metrics: Optional[MetricsRegistry] = None


@dataclass
class SimMetrics:
    deployment: str
    n_chips: int
    requests: List[Request]
    makespan: float
    mean_ttft_ms: float
    p99_ttft_ms: float
    mean_tpot_ms: float
    p99_tpot_ms: float
    throughput_tok_s: float            # all output tokens / makespan
    store_hit_rate: float
    ep_overlap_ratio: float
    prefix_hit_rate: float = 0.0       # cached prefill tokens / text tokens
    completed_requests: int = 0        # finished with full output
    killed_requests: int = 0           # dropped by decode-OOM (no preemption)
    n_preemptions: int = 0             # page-level preempt/swap events
    # chaos layer: P->D transfer fault recovery accounting
    lost_requests: int = 0             # unrecoverable transfer losses
    transfer_retries: int = 0          # failed group attempts retried
    retry_time_ms: float = 0.0         # modeled backoff + resend time
    # observability: per-request latency attribution (components sum to
    # e2e on simulated time) + the metrics-registry snapshot
    attribution: Optional[Dict] = None
    telemetry: Optional[Dict] = None

    def slo_attainment(self, ttft_ms: float, tpot_ms: float) -> float:
        ok = sum(r.meets_slo(ttft_ms, tpot_ms) for r in self.requests)
        return ok / len(self.requests)

    def stage_breakdown_ms(self) -> Dict[str, float]:
        """Mean per-stage latency decomposition (production observability:
        shows WHERE the TTFT goes per deployment — queueing vs encode vs
        E->P dispatch vs prefill)."""
        agg: Dict[str, float] = {}
        for r in self.requests:
            for k, v in r.stage_breakdown().items():
                agg[k] = agg.get(k, 0.0) + v * 1e3
        return {k: v / len(self.requests) for k, v in agg.items()}

    def effective_throughput(self, ttft_ms: float, tpot_ms: float,
                             per_chip: bool = True) -> float:
        toks = sum(len(r.output_tokens) for r in self.requests
                   if r.meets_slo(ttft_ms, tpot_ms))
        t = toks / self.makespan if self.makespan > 0 else 0.0
        return t / self.n_chips if per_chip else t


class _Instance:
    def __init__(self, sim: "Simulator", spec):
        self.sim = sim
        self.spec = spec
        self.queue: List[Tuple[str, Request]] = []    # E / P tasks
        self.decode_batch: Dict[int, Tuple[Request, int]] = {}
        self.decode_wait: List[Request] = []
        # page-level preemption: (req, remaining) parked with their KV
        # swapped to host, FIFO resume; marks gate the starvation guard
        self.preempted: List[Tuple[Request, int]] = []
        self._resume_marks: Dict[int, int] = {}
        self._swap_penalty = 0.0      # host-link time owed by the next iter
        self._parked_at: Dict[int, float] = {}   # rid -> preempt time (spans)
        self._decode_iters = 0                   # decode-span sampling
        self.busy = False
        self.running_stage: Optional[str] = None

    # ---- task intake ----
    def enqueue(self, stage: str, req: Request) -> None:
        self.queue.append((stage, req))
        self.sim.router.on_enqueue(self.spec.name, req.total_prompt_len,
                                   rid=str(req.request_id))
        self._kick()

    # ---- decode KV-capacity accounting (paged pool model) ----
    def _held_pages(self, req: Request) -> int:
        page = self.sim.cfg.kv_page_tokens or 16
        return pages_for(req.total_prompt_len + len(req.output_tokens), page)

    def _pages_used(self) -> int:
        return sum(self._held_pages(r) for r, _ in self.decode_batch.values())

    def _can_admit(self, req: Request) -> bool:
        """Preemption-aware decode admission: a request joins the batch
        only when both a batch slot AND its KV pages are available —
        overflow waits instead of being force-fed into a full pool."""
        if len(self.decode_batch) >= self.sim.cfg.decode_batch_max:
            return False
        cap = self.sim.cfg.decode_kv_pages
        return not cap or self._pages_used() + self._held_pages(req) <= cap

    def join_decode(self, req: Request) -> None:
        cap = self.sim.cfg.decode_kv_pages
        if cap and self._held_pages(req) > cap:
            # bigger than the whole pool: unservable at this capacity in
            # EITHER mode — drop it now instead of head-of-line blocking
            # decode_wait forever (preemption can't shrink a request)
            req.killed = True
            req.t_done = self.sim.loop.now
            self.sim.n_killed += 1
            self.sim.metrics.counter("killed_requests_total").inc()
            self.sim.done.append(req)
            self.sim.acc.close(req.request_id, len(req.output_tokens))
            return
        if not self._can_admit(req):
            self.sim.acc.set_state(req.request_id, "queue")
            self.decode_wait.append(req)
            return
        self.decode_batch[req.request_id] = (req, req.max_new_tokens - 1)
        self.sim.acc.set_state(req.request_id, "compute")
        self.sim.router.on_decode_join(self.spec.name)
        self._kick()

    # ---- execution loop ----
    def _kick(self) -> None:
        if not self.busy:
            self._next()

    def _interference(self, stage: str) -> float:
        if self.spec.coloc_group < 0:
            return 1.0
        peers = [i for i in self.sim.instances.values()
                 if i.spec.coloc_group == self.spec.coloc_group
                 and i is not self and i.busy and i.running_stage]
        if not peers:
            return 1.0
        return colocation.stage_slowdown(stage, [p.running_stage for p in peers])

    def _next(self) -> None:
        sim = self.sim
        loop = sim.loop
        if self.queue:
            stage, req = self.queue.pop(0)
            self.busy, self.running_stage = True, stage
            if stage == "E":
                sim.router.on_start(self.spec.name, req.total_prompt_len,
                                    rid=str(req.request_id))
                dur = sim.cost.encode_time(req.mm_tokens, self.spec.chips,
                                           self.spec.tp)
                dur *= self._interference("E")
                req.t_encode_start = loop.now
                sim.acc.set_state(req.request_id, "compute")
                if sim.tracer.enabled:
                    sim.tracer.add("encode", loop.now, loop.now + dur,
                                   track=self.spec.name,
                                   request_id=req.request_id)
                loop.after(dur, lambda: self._finish_encode(req))
            else:
                cached = self._prefix_lookup(req)
                chunk_toks = self._chunk_tokens(req, cached)
                inter = self._interference("P")
                req.t_prefill_start = loop.now
                if chunk_toks is None:
                    sim.router.on_start(self.spec.name,
                                        req.total_prompt_len,
                                        rid=str(req.request_id))
                    dur = sim.cost.prefill_time(
                        req.total_prompt_len, self.spec.chips,
                        self.spec.tp, cached_prefix=cached) * inter
                    self._start_prefill(req, dur, cached, None)
                else:
                    # chunk-granular occupancy: the cached prefix
                    # retires immediately, computed tokens retire as
                    # each chunk finishes
                    rid = str(req.request_id)
                    sim.router.on_start(self.spec.name, cached, rid=rid)
                    times = [t * inter for t in sim.cost.chunk_prefill_times(
                        req.total_prompt_len, chunk_toks, self.spec.chips,
                        self.spec.tp, cached_prefix=cached)]
                    t_end = 0.0
                    name = self.spec.name
                    for c, dt in zip(chunk_toks, times):
                        t_end += dt
                        loop.after(t_end, lambda c=c:
                                   sim.router.on_prefill_progress(
                                       name, c, rid=rid))
                    dur = sum(times)
                    self._start_prefill(req, dur, cached,
                                        (chunk_toks, times))
            sim.router.on_busy_until(self.spec.name, loop.now + dur)
        elif self.decode_batch:
            self.busy, self.running_stage = True, "D"
            batch = len(self.decode_batch)
            kv = sum(r.total_prompt_len + len(r.output_tokens)
                     for r, _ in self.decode_batch.values()) / batch
            dur = sim.cost.decode_step_time(batch, kv, self.spec.chips,
                                            self.spec.tp)
            dur *= self._interference("D")
            # swap traffic owed by preempt/resume events serializes into
            # the decode stream (pages are unusable until the copy lands)
            dur += self._swap_penalty
            self._swap_penalty = 0.0
            self._decode_iters += 1
            if sim.tracer.want_decode_span(self._decode_iters):
                sim.tracer.add("decode.step", loop.now, loop.now + dur,
                               track=self.spec.name, batch=batch)
            loop.after(dur, self._finish_decode_iter)
            sim.router.on_busy_until(self.spec.name, loop.now + dur)
        else:
            self.busy, self.running_stage = False, None
            # drained: collapse the stale busy_until estimate so pick()
            # sees this replica as idle again
            sim.router.on_idle(self.spec.name, loop.now)

    def _chunk_tokens(self, req: Request, cached: float) -> Optional[list]:
        """Computed-token split of this request's prefill into fixed
        chunks, or None when chunked mode is off / the prompt fits in
        one chunk (chunking a single-chunk prompt only adds overhead).
        Mirrors the real engine's fallbacks: multimodal prompts and
        non-attention-only decoders are served monolithically, so the
        sim must not credit them streaming overlap."""
        cfg = self.sim.cfg
        model = self.sim.model
        if not cfg.chunked_prefill:
            return None
        if req.is_multimodal or model.encoder is not None \
                or model.ssm_layers:
            return None
        C = max(1, cfg.prefill_chunk_tokens)
        computed = max(1, int(req.total_prompt_len - cached))
        if computed <= C:
            return None
        out = [C] * (computed // C)
        if computed % C:
            out.append(computed % C)
        return out

    def _prefix_lookup(self, req: Request) -> float:
        """Cached-prefix tokens on THIS instance's radix tree (full pages
        only), recording hit stats and retaining the prompt for future
        requests. 0 for multimodal prompts (token-keyed cache)."""
        sim = self.sim
        cache = sim.router.prefix_caches.get(self.spec.name)
        if cache is None or req.is_multimodal:
            return 0.0
        m = cache.match_and_ref(req.prompt_tokens,
                                cap=len(req.prompt_tokens) - 1)
        cached = (m.n_tokens // cache.page) * cache.page
        cache.insert(req.prompt_tokens)
        sim.prefix_hit_tokens += cached
        sim.prefix_prompt_tokens += len(req.prompt_tokens)
        return float(cached)

    # ---- stage completions ----
    def _finish_encode(self, req: Request) -> None:
        sim = self.sim
        req.t_encode_done = sim.loop.now
        e_block = sim.finish_encode(self, req)
        if e_block > 0:
            sim.loop.after(e_block, self._next)   # sync push blocks E
        else:
            self._next()

    def _start_prefill(self, req: Request, base_dur: float, cached: float,
                       chunked: Optional[tuple]) -> None:
        sim = self.sim
        sim.acc.set_state(req.request_id, "compute")
        if sim.tracer.enabled:
            if chunked is not None:
                t = sim.loop.now
                for k, dt in enumerate(chunked[1]):
                    sim.tracer.add("prefill.chunk", t, t + dt,
                                   track=self.spec.name,
                                   request_id=req.request_id, chunk=k)
                    t += dt
            else:
                sim.tracer.add("prefill", sim.loop.now,
                               sim.loop.now + base_dur,
                               track=self.spec.name,
                               request_id=req.request_id)
        d_inst = sim.pick_decode_instance(req, prefer=self.spec.name)
        if d_inst is self:
            # fused PD: no transfer
            sim.loop.after(base_dur, lambda: self._finish_prefill(
                req, d_inst, join_delay=0.0))
            return
        if chunked is not None:
            # streaming: chunk k's pages ride the link under chunk k+1's
            # compute; a cached prefix ships at t=0 (zero compute).
            # Segment bytes are token-proportional slices of the SAME
            # kv_bytes total the serialized baseline plans (sliding-
            # window cap + SSM state included), so the A/B compares
            # schedules, not payload models.
            chunk_toks, times = chunked
            total_toks = cached + sum(chunk_toks)
            per_tok = sim.cost.kv_bytes(req.total_prompt_len) / total_toks
            p = kv_plan_chunked(
                chunk_bytes=[cached * per_tok]
                + [c * per_tok for c in chunk_toks],
                chunk_compute=[0.0] + list(times),
                handshake=sim.cfg.hw.handshake,
                link_bw=sim.cfg.hw.link_bw,
                page_bytes=sim.cost.kv_page_bytes())
        else:
            p = kv_plan(sim.cfg.kv_scheme,
                        n_layers=sim.model.n_layers,
                        bytes_per_layer=sim.cost.kv_bytes(
                            req.total_prompt_len) / sim.model.n_layers,
                        per_layer_compute=base_dur / sim.model.n_layers,
                        handshake=sim.cfg.hw.handshake,
                        link_bw=sim.cfg.hw.link_bw,
                        page_bytes=sim.cost.kv_page_bytes_per_layer())
        rec = None
        if sim.cfg.faults is not None:
            # deliver the plan through the fault plane: retry/backoff +
            # fresh replan of missing groups. TTFT inflation flows
            # naturally through the recovered plan's exposed tail; an
            # unrecoverable loss kills the request (surfaced in
            # lost_requests, never silently dropped).
            try:
                p, rec = sim.cost.recover_transfer(
                    p, sim.injector,
                    sim.retry if sim.cfg.fault_recovery else NO_RETRY,
                    key=req.request_id, replan=sim.cfg.fault_recovery)
                sim.n_transfer_retries += rec.retries
                sim.transfer_retry_time += rec.retry_time
                sim.metrics.counter("recovery_retries_total",
                                    site="transfer").inc(rec.retries)
                sim.metrics.counter("transfer_replans_total").inc(
                    rec.replanned_groups)
                sim.metrics.counter("retry_time_seconds_total",
                                    site="transfer").inc(rec.retry_time)
            except TransferError:
                req.killed = True
                sim.n_lost += 1
                sim.metrics.counter("lost_requests_total").inc()
        emit_spans(sim.tracer, p, base=sim.loop.now,
                   handshake=sim.cfg.hw.handshake,
                   compute_track=self.spec.name,
                   link_track=f"{self.spec.name}->{d_inst.spec.name}",
                   request_id=req.request_id, recovery=rec)
        sim.kv_plans.append(p)
        retry_t = rec.retry_time if rec is not None else 0.0
        # layer-wise blocking handshakes stretch prefill itself
        sim.loop.after(p.prefill_end, lambda: self._finish_prefill(
            req, d_inst, join_delay=max(0.0, p.total_done - p.prefill_end),
            retry_t=retry_t))

    def _finish_prefill(self, req: Request, d_inst: "_Instance",
                        join_delay: float, retry_t: float = 0.0) -> None:
        sim = self.sim

        def emit() -> None:
            if req.killed:
                # lost on the P->D fabric (recovery exhausted or off):
                # account and retire without a first token
                req.t_done = sim.loop.now
                sim.done.append(req)
                sim.acc.close(req.request_id)
                return
            # the exposed transfer tail the request just sat through
            # includes the recovery backoff: reclassify that slice of
            # the transfer component as retry (zero-sum, clamped)
            sim.acc.note(req.request_id, "retry", retry_t,
                         source="transfer")
            # first token gated on the Decode side holding the full KV
            # (kv_transfer's "TTFT gate"): the exposed transfer tail sits
            # on the TTFT critical path, which is what the grouped /
            # chunked streaming schemes shrink
            req.t_first_token = sim.loop.now
            sim.acc.mark_first_token(req.request_id)
            req.output_tokens.append(0)
            if req.max_new_tokens <= 1:
                req.t_done = sim.loop.now
                sim.done.append(req)
                sim.acc.close(req.request_id, len(req.output_tokens))
            else:
                d_inst.join_decode(req)

        if join_delay > 0:
            sim.acc.set_state(req.request_id, "transfer")
            sim.loop.after(join_delay, emit)
        else:
            emit()
        self._next()

    # ---- decode-OOM handling: preempt (swap) or kill ----
    def _pick_victim(self, guarded: bool) -> Optional[int]:
        cands = []
        for rid, (req, _rem) in self.decode_batch.items():
            mark = self._resume_marks.get(rid)
            cands.append(VictimCandidate(
                slot=rid, pages_lost=self._held_pages(req),
                priority=req.priority,
                made_progress=(mark is None
                               or len(req.output_tokens) > mark),
                preempt_count=req.n_preempts if guarded else 0))
        v = pick_preemption_victim(cands)
        return None if v is None else v.slot

    def _preempt(self, rid: int) -> None:
        req, remaining = self.decode_batch.pop(rid)
        self.sim.router.on_decode_leave(self.spec.name)
        req.n_preempts += 1
        self.sim.n_preempted += 1
        self.sim.metrics.counter("preemptions_total",
                                 engine=self.spec.name).inc()
        self._swap_penalty += self.sim.cost.swap_time(self._held_pages(req))
        self.sim.acc.set_state(rid, "queue")
        if self.sim.tracer.enabled:
            self._parked_at[rid] = self.sim.loop.now
        self.preempted.append((req, remaining))

    def _kill(self, rid: int) -> None:
        req, _ = self.decode_batch.pop(rid)
        self.sim.router.on_decode_leave(self.spec.name)
        req.killed = True
        req.t_done = self.sim.loop.now
        self.sim.n_killed += 1
        self.sim.metrics.counter("killed_requests_total").inc()
        self.sim.done.append(req)
        self.sim.acc.close(rid, len(req.output_tokens))

    def _finish_decode_iter(self) -> None:
        sim = self.sim
        finished = []
        for rid, (req, remaining) in list(self.decode_batch.items()):
            req.output_tokens.append(0)
            remaining -= 1
            if remaining <= 0:
                req.t_done = sim.loop.now
                finished.append(rid)
                sim.done.append(req)
                sim.acc.close(rid, len(req.output_tokens))
            else:
                self.decode_batch[rid] = (req, remaining)
        for rid in finished:
            del self.decode_batch[rid]
            self._resume_marks.pop(rid, None)
            sim.router.on_decode_leave(self.spec.name)
        # KV-capacity pressure from this iteration's growth: preempt
        # victims to host (resumable) or kill them (the baseline) —
        # never the last active request (it over-commits instead)
        cap = sim.cfg.decode_kv_pages
        while cap and self._pages_used() > cap and len(self.decode_batch) > 1:
            rid = self._pick_victim(guarded=sim.cfg.preemption)
            if rid is None:
                break                 # all starvation-guarded: over-commit
            if sim.cfg.preemption:
                self._preempt(rid)
            else:
                self._kill(rid)
        # resume preempted requests first (FIFO — they hold progress and
        # already paid for their pages once), then drain the admit queue
        while (self.preempted
               and len(self.decode_batch) < sim.cfg.decode_batch_max):
            req, remaining = self.preempted[0]
            if cap and self._pages_used() + self._held_pages(req) > cap:
                break
            self.preempted.pop(0)
            swap_t = sim.cost.swap_time(self._held_pages(req))
            self._swap_penalty += swap_t
            # the parked wait accrued as queue time; the out+in copies
            # of its pages are really swap traffic — reclassify
            sim.acc.note(req.request_id, "swap", 2 * swap_t,
                         source="queue")
            if sim.tracer.enabled:
                t0 = self._parked_at.pop(req.request_id, sim.loop.now)
                sim.tracer.add("preempt.parked", t0, sim.loop.now,
                               track=self.spec.name,
                               request_id=req.request_id)
            self.decode_batch[req.request_id] = (req, remaining)
            sim.acc.set_state(req.request_id, "compute")
            self._resume_marks[req.request_id] = len(req.output_tokens)
            sim.router.on_decode_join(self.spec.name)
        while self.decode_wait and self._can_admit(self.decode_wait[0]):
            self.join_decode(self.decode_wait.pop(0))
        self._next()


class Simulator:
    def __init__(self, model: ModelConfig, cfg: SimConfig):
        import dataclasses
        from repro_torch.core.deployment import scale
        self.model = model
        if cfg.decode_kv_pages and not cfg.kv_page_tokens:
            # capacity is counted in pages: the page size must be real so
            # held-page math and swap_time agree with the paged layout
            cfg = dataclasses.replace(cfg, kv_page_tokens=16)
        self.cfg = cfg
        dep = parse(cfg.deployment) if isinstance(cfg.deployment, str) \
            else cfg.deployment
        self.deployment = scale(dep, cfg.replicas)
        self.cost = CostModel(model, cfg.hw, page_tokens=cfg.kv_page_tokens)
        self.loop = EventLoop()
        self.router = Router(self.deployment)
        # telemetry plane: the accountant rides the event loop — every
        # simulated-time advance is charged to all open requests under
        # their current stage state, so the per-request components sum
        # to e2e by construction. The tracer (when given) is re-clocked
        # onto simulated time so spans land on the event-loop timeline.
        self.metrics = cfg.metrics if cfg.metrics is not None \
            else MetricsRegistry()
        self.tracer = cfg.tracer if cfg.tracer is not None else NULL_TRACER
        if cfg.tracer is not None:
            cfg.tracer.set_clock(lambda: self.loop.now)
        self.acc = LatencyAccountant()         # simulated time, no wall
        self.loop.on_advance = self.acc.advance
        # one seeded fault plane across the store and transfer domains.
        # With a fault plan configured, recovery defaults to the standard
        # backoff policy; without one, NO_RETRY keeps the legacy
        # single-attempt semantics exactly.
        self.injector = FaultInjector(cfg.faults, metrics=self.metrics)
        if cfg.retry is not None:
            self.retry = cfg.retry
        else:
            self.retry = DEFAULT_RETRY if cfg.faults is not None else NO_RETRY
        self.store = MMStore(injector=self.injector)
        self.prefetcher = EPPrefetcher(self.loop, self.store, self.cost,
                                       async_mode=cfg.ep_async)
        self.instances = {s.name: _Instance(self, s)
                          for s in self.deployment.instances}
        self.done: List[Request] = []
        self.kv_plans: list = []
        self.prefix_hit_tokens = 0.0
        self.prefix_prompt_tokens = 0.0
        self.n_preempted = 0
        self.n_killed = 0
        self.n_lost = 0
        self.n_transfer_retries = 0
        self.transfer_retry_time = 0.0
        if cfg.prefix_cache:
            from repro_torch.serving.prefix_cache import PrefixCache
            page = cfg.kv_page_tokens or 16
            self.router.cache_aware = cfg.cache_aware_routing
            for s in self.deployment.instances:
                if s.serves("P"):
                    self.router.register_prefix_cache(
                        s.name,
                        PrefixCache(page,
                                    max_tokens=cfg.prefix_cache_tokens))

    # ---- routing hooks ----
    def pick_decode_instance(self, req: Request, prefer: str) -> _Instance:
        st = self.router.pick("D", self.loop.now, prefer=prefer)
        return self.instances[st.spec.name]

    def submit(self, req: Request) -> None:
        self.loop.at(req.t_arrival, lambda: self._arrive(req))

    def _arrive(self, req: Request) -> None:
        self.acc.open(req.request_id)
        if req.is_multimodal:
            import hashlib
            key = hashlib.sha256(req.mm_payload).hexdigest()
            if self.store.get(key) is not None:   # counts hit/miss stats
                # cross-request reuse: skip Encode entirely (MM Store hit)
                req.t_encode_start = req.t_encode_done = self.loop.now
                self._to_prefill(req, key)
                return
            st = self.router.pick("E", self.loop.now)
            self.instances[st.spec.name].enqueue("E", req)
        else:
            st = self.router.pick("P", self.loop.now, req=req)
            self.instances[st.spec.name].enqueue("P", req)

    def finish_encode(self, inst: _Instance, req: Request) -> float:
        import hashlib
        key = hashlib.sha256(req.mm_payload).hexdigest()
        self.store.put(key, {"tokens": req.mm_tokens},
                       int(self.cost.feature_bytes(req.mm_tokens)))
        return self._to_prefill(req, key, from_instance=inst)

    def _to_prefill(self, req: Request, key: str,
                    from_instance: Optional[_Instance] = None) -> float:
        st = self.router.pick("P", self.loop.now,
                              prefer=(from_instance.spec.name
                                      if from_instance is not None and
                                      from_instance.spec.serves("P") else None),
                              req=req)
        inst = self.instances[st.spec.name]
        if from_instance is inst:
            inst.enqueue("P", req)           # same instance: no transfer
            return 0.0
        sched_hint = max(0.0, st.busy_until - self.loop.now) \
            + 0.001 * st.pending_tokens
        return self.prefetcher.notify(
            req.request_id, key, req.mm_tokens,
            on_ready=lambda _rec: inst.enqueue("P", req),
            scheduling_latency_hint=sched_hint)

    # ---- run ----
    def run(self, requests: List[Request]) -> SimMetrics:
        for r in requests:
            self.submit(r)
        self.loop.run()
        assert len(self.done) == len(requests), \
            f"stuck: {len(self.done)}/{len(requests)} finished"
        # lost requests never emitted a first token: they are accounted
        # in lost_requests, not in the latency percentiles
        ttfts = sorted(r.ttft * 1e3 for r in self.done
                       if r.t_first_token >= 0) or [0.0]
        tpots = sorted(r.tpot * 1e3 for r in self.done
                       if r.t_first_token >= 0) or [0.0]
        makespan = max(r.t_done for r in self.done) - min(
            r.t_arrival for r in self.done)
        toks = sum(len(r.output_tokens) for r in self.done)
        return SimMetrics(
            deployment=self.deployment.name,
            n_chips=self.deployment.n_chips,
            requests=list(self.done),
            makespan=makespan,
            mean_ttft_ms=sum(ttfts) / len(ttfts),
            p99_ttft_ms=quantile(ttfts, 0.99),
            mean_tpot_ms=sum(tpots) / len(tpots),
            p99_tpot_ms=quantile(tpots, 0.99),
            throughput_tok_s=toks / makespan if makespan > 0 else 0.0,
            store_hit_rate=self.store.stats.hit_rate,
            ep_overlap_ratio=self.prefetcher.mean_overlap_ratio,
            prefix_hit_rate=(self.prefix_hit_tokens / self.prefix_prompt_tokens
                             if self.prefix_prompt_tokens else 0.0),
            completed_requests=sum(not r.killed for r in self.done),
            killed_requests=self.n_killed,
            n_preemptions=self.n_preempted,
            lost_requests=self.n_lost,
            transfer_retries=self.n_transfer_retries,
            retry_time_ms=self.transfer_retry_time * 1e3,
            attribution=self.acc.report(),
            telemetry=self.metrics.snapshot(),
        )


def simulate(model: ModelConfig, deployment: str, dataset: DatasetSpec,
             *, rate: float, n_requests: int = 512, seed: int = 0,
             kv_scheme: str = "grouped", ep_async: bool = True,
             replicas: int = 1, hw: Hardware = V5E,
             per_chip_rate: bool = False,
             kv_page_tokens: int = 0,
             prefix_cache: bool = False,
             cache_aware_routing: bool = True,
             chunked_prefill: bool = False,
             prefill_chunk_tokens: int = 256,
             decode_kv_pages: int = 0,
             preemption: bool = False,
             faults: Optional[FaultPlan] = None,
             retry: Optional[RetryPolicy] = None,
             fault_recovery: bool = True,
             tracer: Optional[Tracer] = None,
             metrics: Optional[MetricsRegistry] = None) -> SimMetrics:
    """Run one deployment against a trace injected at ``rate`` req/s.

    per_chip_rate=True multiplies the rate by the deployment's chip count
    — the paper's figures 8-17 report a per-NPU x-axis so bigger
    deployments absorb proportionally more traffic; Table 5 compares
    deployments at one TOTAL rate (its effective-throughput arithmetic
    only closes under that reading).
    """
    cfg = SimConfig(deployment=deployment, kv_scheme=kv_scheme,
                    ep_async=ep_async, replicas=replicas, hw=hw,
                    kv_page_tokens=kv_page_tokens,
                    prefix_cache=prefix_cache,
                    cache_aware_routing=cache_aware_routing,
                    chunked_prefill=chunked_prefill,
                    prefill_chunk_tokens=prefill_chunk_tokens,
                    decode_kv_pages=decode_kv_pages,
                    preemption=preemption,
                    faults=faults, retry=retry,
                    fault_recovery=fault_recovery,
                    tracer=tracer, metrics=metrics)
    sim = Simulator(model, cfg)
    if per_chip_rate:
        rate = rate * sim.deployment.n_chips
    reqs = gen_requests(dataset, n_requests, rate, seed)
    return sim.run(reqs)

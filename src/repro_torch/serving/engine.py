"""Continuous-batching instance engine with real PyTorch execution.

One ``Engine`` is one serving instance (a Prefill, Decode or fused PD
instance in EPD-Serve terms). It owns a slot-based decode batch and a KV
cache; requests are prefillled one-at-a-time (batch 1) and inserted into a
free slot, then all active slots decode in lock-step — the standard
continuous-batching loop.

Two KV layouts:

* dense (default) — per-slot contiguous caches (batch, max_len, ...);
  insert copies the request's whole cache row into its slot.
* paged (``paged=True``) — attention KV lives in a shared page pool with
  per-slot block tables (serving.kv_pool, ref-counted pages). Prefill
  writes straight into pool pages, so insert on the SAME engine is a pure
  block-table handoff (zero KV bytes moved) and insert from ANOTHER
  engine moves only the request's pages. Decode attention gathers KV
  through the block table with per-slot length masking, so HBM traffic
  tracks actual lengths.
* paged + ``prefix_cache=True`` — a radix-tree prefix cache
  (serving.prefix_cache) indexes pool pages by their token content.
  ``prefill_request`` reuses the longest cached prefix by ref-counting
  its shared pages into the request's block table and computes only the
  unshared suffix; a match ending inside a page is copied on write so
  shared pages are never mutated. Finished prefills are retained in the
  tree and evicted LRU under pool pressure. Requires an attention-only
  decoder (no SSM state / cross-attention to reconstruct mid-sequence)
  and applies to text-only requests.
* paged + ``chunked_prefill=True`` — long prompts prefill in fixed-size
  chunks of ``prefill_chunk`` tokens (a page multiple): each chunk
  allocates only its own pages, scatters them into the pool as it
  finishes, and attends over chunks 0..k-1 through the block table (the
  same gather-prefix path the prefix cache uses, with the chunk start as
  ``pos_base`` and the tokens already resident as ``prefix_len``). The
  in-flight prefill window is O(chunk) instead of O(prompt), and the
  P->D payload records per-chunk segments so the transfer planner can
  stream chunk *k*'s pages while chunk *k+1* computes
  (kv_transfer.plan_chunked). Composes with the prefix cache — a cached
  prefix skips whole leading chunks. Same attention-only/text-only
  constraints as the prefix cache; multimodal requests fall back to the
  monolithic paged path.

* paged + ``preemption=True`` — KV pressure (decode growth past page
  boundaries, cross-engine insert admission) no longer kills with a pool
  error: a victim slot (lowest priority, fewest private pages lost,
  never the last active one, starvation-guarded) is preempted at page
  granularity — prefix-shared pages are unref'd back to the tree,
  private pages are swapped to the pool's host backing store — and the
  request parks until ``decode_step`` can re-fault it: shared pages are
  re-ref'd from the tree (or recomputed if evicted meanwhile), private
  pages swap back in, and decode resumes from the exact saved position.
  Greedy outputs are bit-identical to an uninterrupted run.

The EPD disaggregation layer (repro_torch.core) drives one or more Engines: the
Encode stage produces features into the MM Store, Prefill engines run
``prefill_request`` and export their caches, Decode engines import caches
via ``insert`` and run ``decode_step``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.batching import BatchPlan, IterationScheduler, PrefillJob
from repro_torch.core.faults import (FaultInjector, InstanceDown, NoFreeSlot,
                                     SwapLost)
from repro_torch.core.scheduler import VictimCandidate, pick_preemption_victim
from repro_torch.core.telemetry import (NULL_TRACER, LatencyAccountant,
                                        MetricsRegistry, Tracer)
from repro_torch.models import frontend as FE
from repro_torch.models.transformer import make_caches
from repro_torch.runtime import resolve_device
from repro_torch.serving.graphs import GraphStep, census
from repro_torch.serving.kv_pool import (PagePool, PagedKVPayload, PoolExhausted,
                                         SwapHandle)
from repro_torch.serving.prefix_cache import MatchResult, PrefixCache
from repro_torch.serving.request import Request
from repro_torch.serving.steps import (make_decode_fn, make_encode_fn,
                                       make_insert_fn, make_page_copy_fn,
                                       make_page_gather_fn, make_page_scatter_fn,
                                       make_paged_insert_fn,
                                       make_pool_page_copy_fn, make_prefill_fn)


@dataclass
class PreemptedRequest:
    """A decode request parked off-device by page-level preemption.

    handle         — swap ticket for the private pages (KV content on the
                     host; None when every page was tree-shared).
    n_shared_pages — leading block-table pages that were shared with the
                     prefix tree at preemption time: they were unref'd,
                     not swapped, and are re-ref'd (or recomputed, if the
                     tree evicted them meanwhile) on resume.
    n_pages        — total pages the block table held (shared + private).
    side           — host copies of the slot's side state (ssm/cross/len)
                     as batch-1 arrays, restored via the insert step.
    last_tok       — the token the next decode step must feed.
    """

    req: Request
    handle: Optional[SwapHandle]
    n_shared_pages: int
    n_pages: int
    side: Dict[str, Any] = field(default_factory=dict)
    last_tok: int = 0
    t_parked: float = 0.0             # tracer clock at park (parked span)


class PrefillTask:
    """One request's chunked prefill as a resumable state machine.

    The serial path (``Engine._prefill_chunked``) drives it to completion
    in a tight loop; the continuous path (``Engine.step`` /
    ``EPDCluster.run_continuous``) interleaves ``run_chunk`` calls across
    tasks so the device stays busy between one request's chunks. Either
    driver executes the exact same sequence of pool allocations and
    suffix-prefill calls for a given request, so greedy outputs
    are bit-identical by construction.

    Multimodal (scatter-path) requests carry the E->P feature-arrival
    barrier as task state: a chunk whose window lies entirely before the
    image run scatters nothing (``needs_features_next`` is False) and may
    run before the features land; the first chunk overlapping the run
    requires ``supply_features`` first. ``defer_features=True`` suppresses
    the init-time encode-skip validation for exactly that case — the
    barrier check in ``run_chunk`` enforces it instead.

    Lifecycle: construct (takes the prefix-cache match refs), zero or
    more ``run_chunk`` (each takes its own page refs; a
    :class:`PoolExhausted` from the allocator leaves the task state
    untouched and retryable), then exactly one of ``finish`` (refs move
    to the returned payload) or ``abort`` (every ref unwound). In-flight
    tasks register with the engine so ``page_holders`` audits their refs.
    """

    def __init__(self, eng: "Engine", req: Request, n_tokens: int,
                 mm_feats=None, mm_key=None, defer_features: bool = False):
        self.eng = eng
        self.req = req
        self.n_tokens = n_tokens
        self.mm_key = mm_key
        page = eng.page_size
        self.page = page
        self.C = eng.prefill_chunk if eng.chunked_prefill else eng.max_len
        width = eng.max_len // page
        # multimodal: the prefix-cache KEY splices a hash-derived
        # pseudo-token run over the image segment — (mm-content-hash,
        # token-run) — so identical image+prompt pairs match; the FEED
        # tokens carry placeholder 0s there (their embeddings are
        # overwritten by the mm_feats scatter, never looked at).
        p_toks = list(req.prompt_tokens)
        self.n_mm = n_tokens - len(p_toks) if mm_key is not None else 0
        if mm_key is not None:
            self.key_tokens = (p_toks[:req.mm_pos]
                               + FE.mm_key_run(mm_key, self.n_mm)
                               + p_toks[req.mm_pos:])
            self.feed_tokens = (p_toks[:req.mm_pos] + [0] * self.n_mm
                                + p_toks[req.mm_pos:])
        else:
            self.key_tokens = self.feed_tokens = p_toks
        if eng.prefix_cache is not None:
            # cap at n-1 so at least one token is computed (need logits)
            with eng.tracer.span("prefix.match", track=eng.name,
                                 request_id=req.request_id):
                self.m = eng.prefix_cache.match_and_ref(self.key_tokens,
                                                        cap=n_tokens - 1)
        else:
            self.m = MatchResult()
        if (mm_key is not None and mm_feats is None and not defer_features
                and self.m.n_tokens < req.mm_pos + self.n_mm):
            # the caller skipped the encode forward on the promise that
            # the cached prefix covers the whole image run; it must —
            # there are no features to scatter for the uncovered slice
            eng.pool.unref(self.m.page_ids)
            if self.m.cow_src is not None:
                eng.pool.unref([self.m.cow_src])
            raise ValueError(
                f"encode skipped but cached prefix covers only "
                f"{self.m.n_tokens} tokens of an image run ending at "
                f"{req.mm_pos + self.n_mm}")
        self.mm_args: tuple = ()
        if mm_feats is not None:
            self.mm_args = (eng._dev_feats(mm_feats), int(req.mm_pos))
        self.n_shared = self.m.n_full_pages
        self.cow_held = self.m.cow_src is not None
        self.row = np.zeros((1, width), np.int32)
        self.row[0, :self.n_shared] = self.m.page_ids
        self.chunks: List[Tuple[int, int]] = []  # (computed tokens, pages)
        if self.n_shared:
            self.chunks.append((0, self.n_shared))  # ready before compute
        self.held: List[np.ndarray] = []        # fresh pages, for unwind
        self.logits = None
        self._new = None                        # last chunk's side caches
        self.done = self.m.n_tokens             # tokens already in the pool
        self.pos = self.n_shared * page         # page-aligned window start
        self.k = 0
        self.closed = False
        eng._inflight_tasks.append(self)

    @property
    def finished(self) -> bool:
        return self.pos >= self.n_tokens

    @property
    def next_chunk_tokens(self) -> int:
        """Tokens the next ``run_chunk`` would compute (0 once finished)."""
        return max(0, min(self.pos + self.C, self.n_tokens) - self.done)

    def planned_chunk_tokens(self) -> List[int]:
        """Computed-token split of the REMAINING chunks (deterministic
        from the window arithmetic) — what a cost model should charge
        per executed chunk."""
        out, done, pos = [], self.done, self.pos
        while pos < self.n_tokens:
            end = min(pos + self.C, self.n_tokens)
            out.append(end - done)
            done = end
            pos += -(-end // self.page) * self.page - pos
        return out

    def needs_features_next(self) -> bool:
        """Does the next chunk's window overlap the image run with no
        features supplied yet? True means the E->P feature-arrival
        barrier gates this chunk: ``supply_features`` must happen first.
        A cached prefix covering the whole run clears it for free."""
        if self.mm_key is None or self.mm_args or not self.n_mm:
            return False
        if self.done >= self.req.mm_pos + self.n_mm:
            return False
        return min(self.pos + self.C, self.n_tokens) > self.req.mm_pos

    def supply_features(self, mm_feats) -> None:
        """Land the Encode stage's features (the barrier dependency)."""
        self.mm_args = (self.eng._dev_feats(mm_feats),
                        int(self.req.mm_pos))

    def held_pages(self) -> List[int]:
        """Every pool page this in-flight task holds a ref on (for
        ``assert_balanced`` leak audits)."""
        out = [int(p) for p in self.m.page_ids]
        if self.cow_held:
            out.append(int(self.m.cow_src))
        for ids in self.held:
            out.extend(int(p) for p in ids)
        return out

    def run_chunk(self) -> int:
        """Advance one chunk window; returns the tokens computed.

        A :class:`PoolExhausted` from the page allocator propagates with
        the task state UNTOUCHED (nothing mutated yet this chunk) — the
        scheduler stalls the job and retries after decode frees pages.
        Any other failure must be unwound by the caller via ``abort``."""
        eng = self.eng
        page = self.page
        req = self.req
        if self.finished:
            raise ValueError("prefill task already finished")
        if self.needs_features_next():
            raise ValueError(
                f"request {req.request_id}: chunk {self.k} overlaps the "
                f"image run at {req.mm_pos} but no features were "
                f"supplied (feature-arrival barrier violated)")
        end = min(self.pos + self.C, self.n_tokens)
        with eng.tracer.span("prefill.chunk", track=eng.name,
                             request_id=req.request_id, chunk=self.k,
                             tokens=end - self.done):
            win = -(-end // page) * page - self.pos  # page-aligned window
            ids = eng._alloc_pages(-(-end // page) - self.pos // page)
            self.held.append(ids)
            if self.cow_held:
                # never write a shared page: private copy, then
                # overwrite its unmatched tail during the scatter
                eng.caches["attn"] = eng._cow_copy(
                    eng.caches["attn"],
                    eng._idx([self.m.cow_src]), eng._idx([int(ids[0])]))
                eng.pool.unref([self.m.cow_src])
                self.cow_held = False
            self.row[0, self.pos // page:self.pos // page + len(ids)] = ids
            sfx = np.zeros((1, win), np.int32)
            sfx[0, self.done - self.pos:end - self.pos] = \
                self.feed_tokens[self.done:end]
            side = eng._side_caches()
            pcaches = {"attn": eng.caches["attn"],
                       "ssm": side["ssm"], "cross": side["cross"],
                       "len": side["len"], "pages": eng._idx(self.row)}
            # lengths = this chunk's end: positions past it are
            # dummies (masked scatter + position -1), so the window
            # never claims tokens a later chunk will compute
            self.logits, self._new = eng._prefill_suffix(
                eng.params, eng._idx(sfx), eng._idx([end]), pcaches,
                self.done, self.pos, *self.mm_args)
            eng.caches["attn"] = self._new["attn"]
        n = end - self.done
        self.chunks.append((n, len(ids)))
        self.done = end
        self.pos += win
        self.k += 1
        return n

    def finish(self):
        """Complete the prefill: first token from the last chunk's
        logits, radix retention, metrics — and every page ref moves to
        the returned ``(first_token, payload)``."""
        if self.closed:
            raise ValueError("prefill task already closed")
        if not self.finished:
            raise ValueError("prefill task still has chunks to run")
        eng = self.eng
        first = int(torch.argmax(self.logits[0]))
        n_pages = self.n_shared + sum(len(ids) for ids in self.held)
        ids = np.asarray(self.row[0, :n_pages], np.int32)
        if eng.prefix_cache is not None:
            eng.prefix_cache.insert(self.key_tokens, ids)
        eng._count_prefill(self.n_tokens, self.n_tokens - self.m.n_tokens)
        payload = PagedKVPayload(
            source=eng, page_ids=ids, n_tokens=self.n_tokens,
            side={"ssm": self._new["ssm"], "cross": self._new["cross"],
                  "len": self._new["len"]},
            kv_nbytes=len(ids) * eng._attn_kv_nbytes(eng.caches["attn"]),
            cached_tokens=self.m.n_tokens,
            chunks=self.chunks if eng.chunked_prefill else [])
        self._close()
        return first, payload

    def abort(self) -> None:
        """Unwind every ref this task took (match, CoW source, every
        chunk's fresh pages) so an abandoned prefill leaks nothing."""
        if self.closed:
            return
        eng = self.eng
        eng.pool.unref(self.m.page_ids)
        if self.cow_held:
            eng.pool.unref([self.m.cow_src])
        for ids in self.held:
            eng.pool.unref(ids)
        self._close()

    def _close(self) -> None:
        self.closed = True
        if self in self.eng._inflight_tasks:
            self.eng._inflight_tasks.remove(self)


class Engine:
    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 4,
                 max_len: int = 128, temperature: float = 0.0,
                 cache_dtype=None, kv_dtype=None, device="cuda",
                 paged: bool = False, page_size: int = 16,
                 n_pool_pages: Optional[int] = None,
                 prefix_cache: bool = False,
                 chunked_prefill: bool = False, prefill_chunk: int = 32,
                 preemption: bool = False,
                 faults: Optional[FaultInjector] = None,
                 name: str = "engine",
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 accountant: Optional[LatencyAccountant] = None):
        # resolve the device first: a default (CUDA) construction on a
        # machine without CUDA raises before anything is allocated
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        # telemetry plane: span tracer (no-op unless enabled), shared
        # metrics registry (private one when standalone, so the counter
        # properties below always have a backing store), and the
        # cluster's latency accountant for swap-time reclassification.
        self.name = name
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.accountant = accountant
        self.max_batch = max_batch
        self.max_len = max_len
        # caches default to the parameters' dtype (f32 params: the
        # reference's f32 default; bf16 params: bf16 KV)
        self.cache_dtype = (cache_dtype if cache_dtype is not None
                            else params["embed"].dtype)
        self.kv_dtype = kv_dtype          # e.g. torch.float8_e4m3fn
        self.paged = paged
        self.page_size = page_size
        self.chunked_prefill = chunked_prefill
        self.prefill_chunk = prefill_chunk
        if preemption and not paged:
            raise ValueError("preemption requires paged=True")
        self.preemption = preemption
        if chunked_prefill:
            if not paged:
                raise ValueError("chunked_prefill requires paged=True")
            if prefill_chunk <= 0 or prefill_chunk % page_size:
                raise ValueError(
                    f"prefill_chunk {prefill_chunk} must be a positive "
                    f"multiple of page {page_size}")
        self._decode = make_decode_fn(cfg, temperature)
        # encode-inline baseline for run_request: the SAME
        # frontend-projector forward the Encode stage runs, so the
        # monolithic path is bit-identical to disaggregated E->P->D
        self._encode_inline = (make_encode_fn(cfg)
                               if cfg.frontend is not None
                               and cfg.encoder is None else None)
        if paged:
            if max_len % page_size:
                raise ValueError(
                    f"max_len {max_len} not a multiple of page {page_size}")
            per_slot = max_len // page_size
            if n_pool_pages is None:
                # all slots full + one in-flight prefill, + trash page 0
                n_pool_pages = 1 + (max_batch + 1) * per_slot
            self.pool = PagePool(n_pool_pages, page_size, injector=faults,
                                 metrics=self.metrics, name=name)
            self.caches = make_caches(
                cfg, max_batch, max_len, dtype=self.cache_dtype,
                kv_dtype=kv_dtype, device=self.device, layout="paged",
                page_size=page_size,
                n_pages=n_pool_pages)
            self._prefill = make_prefill_fn(cfg)
            self._insert_side = make_paged_insert_fn(cfg)
            self._copy_pages = make_page_copy_fn()
            self._gather_pages = make_page_gather_fn()
            self._scatter_pages = make_page_scatter_fn()
            self._slot_pages: List[Optional[np.ndarray]] = [None] * max_batch
        else:
            if prefix_cache:
                raise ValueError("prefix_cache requires paged=True")
            self._prefill = make_prefill_fn(cfg)
            # the batch-1 cache every dense prefill fills from scratch
            # (the tensors its CUDA graph is captured over), made at the
            # first prefill: a decode-only engine never holds one
            self._prefill_caches = None
            self._insert = make_insert_fn(cfg)
            self.caches = make_caches(cfg, max_batch, max_len,
                                      dtype=self.cache_dtype,
                                      kv_dtype=kv_dtype, device=self.device)
        self.prefix_cache: Optional[PrefixCache] = None
        self._prefill_suffix = None
        if prefix_cache or chunked_prefill:
            if cfg.encoder is not None or cfg.ssm_layers:
                raise ValueError(
                    "prefix_cache/chunked_prefill need an attention-only "
                    "decoder: SSM state / cross-KV cannot be resumed "
                    "mid-sequence")
        # the suffix-prefill step serves the prefix-cache hit path AND
        # the recompute recovery arms (evicted-prefix re-fault, swap-loss
        # suffix recompute) — a preemption engine on an attention-only
        # decoder gets it even without a prefix cache, so a lost swap
        # handle is recoverable instead of fatal.
        if (prefix_cache or chunked_prefill
                or (preemption and cfg.encoder is None
                    and not cfg.ssm_layers)):
            self._prefill_suffix = make_prefill_fn(cfg, prefix=True)
            self._cow_copy = make_pool_page_copy_fn()
        if prefix_cache:
            self.prefix_cache = PrefixCache(page_size, self.pool)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self._last_tok = np.zeros((max_batch,), np.int32)
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        # Counters live in the metrics registry, labeled by engine name;
        # the historical attribute names (kv_insert_bytes_total,
        # refault_pages_total, ...) survive as read-through properties
        # below so existing tests/benchmarks read them unchanged.
        M = self.metrics
        # KV bytes moved by the most recent / all insert() calls — the
        # paged-vs-dense P->D handoff metric (benchmarks, acceptance).
        self._m_insert_bytes_last = M.gauge("kv_insert_bytes_last",
                                            engine=name)
        self._m_insert_bytes = M.counter("kv_insert_bytes_total",
                                         engine=name)
        # prefill work accounting: tokens the model actually computed vs
        # tokens requested — the prefix-cache savings metric.
        self._m_prefill_total = M.counter("prefill_tokens_total",
                                          engine=name)
        self._m_prefill_computed = M.counter("prefill_tokens_computed",
                                             engine=name)
        self._m_prefix_hit_rate = M.gauge("prefix_hit_rate", engine=name)
        # page-level preemption state: requests parked off-device, FIFO
        # resume order; marks record output length at resume for the
        # starvation guard (no second preemption before progress).
        self.preempted: List[PreemptedRequest] = []
        self._m_preempt = M.counter("preemptions_total", engine=name)
        self._m_resume = M.counter("resumes_total", engine=name)
        self._m_swap_out = M.counter("swap_out_pages_total", engine=name)
        self._m_swap_in = M.counter("swap_in_pages_total", engine=name)
        # prefix pages recomputed on resume
        self._m_refault = M.counter("refault_pages_total", engine=name)
        self._resume_marks: Dict[int, int] = {}
        # swap-loss recovery: resumes that had to recompute their private
        # pages because the host swap tier lost the handle, and requests
        # that could not be recovered (no suffix step / multimodal).
        self._m_swap_lost_rec = M.counter("swap_lost_recomputes_total",
                                          engine=name)
        self._m_lost = M.counter("lost_requests_total", engine=name)
        self.lost: List[Request] = []
        # a crashed instance is gone: serving calls raise InstanceDown
        # instead of silently running against a pool that no longer
        # exists. Set via mark_crashed() by the cluster's fault plane.
        self.crashed = False
        # swap/refault work done inside engine calls, to be reclassified
        # in the accountant's ledger by the cluster after its next
        # sync() (the time is already charged under the request's state;
        # note() moves it into the "swap" component, zero-sum).
        self._pending_notes: List[Tuple[int, str, float, str]] = []
        self._decode_steps = 0
        # iteration-level (continuous) batching: chunked prefills in
        # flight register here so leak audits see their page refs; the
        # scheduler is created lazily by the first submit(). The step
        # counters back the batching-smoke observability assertions.
        self._inflight_tasks: List[PrefillTask] = []
        self.scheduler: Optional[IterationScheduler] = None
        self._m_sched_steps = M.counter("sched_steps_total", engine=name)
        self._m_sched_chunks = M.counter("sched_chunks_total", engine=name)
        self._m_sched_admits = M.counter("sched_admissions_total",
                                         engine=name)
        self._m_sched_mixed = M.counter("sched_mixed_steps_total",
                                        engine=name)

    # -- telemetry back-compat properties ------------------------------------
    @property
    def kv_insert_bytes(self) -> int:
        return int(self._m_insert_bytes_last.value)

    @property
    def kv_insert_bytes_total(self) -> int:
        return int(self._m_insert_bytes.value)

    @property
    def prefill_tokens_total(self) -> int:
        return int(self._m_prefill_total.value)

    @property
    def prefill_tokens_computed(self) -> int:
        return int(self._m_prefill_computed.value)

    @property
    def preempt_count(self) -> int:
        return int(self._m_preempt.value)

    @property
    def resume_count(self) -> int:
        return int(self._m_resume.value)

    @property
    def swap_out_pages_total(self) -> int:
        return int(self._m_swap_out.value)

    @property
    def swap_in_pages_total(self) -> int:
        return int(self._m_swap_in.value)

    @property
    def refault_pages_total(self) -> int:
        return int(self._m_refault.value)

    @property
    def swap_lost_recomputes(self) -> int:
        return int(self._m_swap_lost_rec.value)

    def _count_prefill(self, n_total: int, n_computed: int) -> None:
        self._m_prefill_total.inc(n_total)
        self._m_prefill_computed.inc(n_computed)
        if self.prefix_cache is not None and self._m_prefill_total.value:
            self._m_prefix_hit_rate.set(
                1.0 - self._m_prefill_computed.value
                / self._m_prefill_total.value)

    def _note(self, request_id: int, component: str, dur: float,
              source: str) -> None:
        if self.accountant is not None and dur > 0:
            self._pending_notes.append((request_id, component, dur, source))

    def drain_notes(self) -> None:
        """Apply pending swap-time reclassifications to the accountant.
        The cluster calls this right after its wall-clock sync, so the
        source component has already been charged the interval the swap
        work happened in (note() is zero-sum and clamped)."""
        if self.accountant is not None:
            for rid, comp, amt, src in self._pending_notes:
                self.accountant.note(rid, comp, amt, src)
        self._pending_notes.clear()

    # -- compiled steps ------------------------------------------------------
    def graph_steps(self) -> List[Tuple[str, GraphStep]]:
        """This engine's CUDA-graph steps by name: the decode step and
        the dense prefill."""
        return [("decode", self._decode.graph),
                ("prefill", self._prefill.graph)]

    def graph_census(self) -> Dict[str, Any]:
        """``graphs.census`` of this engine's CUDA-graph steps; all 0 on
        the CPU."""
        return census(self.graph_steps())

    # -- capacity ------------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.slots)

    @staticmethod
    def _attn_kv_nbytes(attn) -> int:
        """Attention-KV bytes per unit of axis 1 across all layers: one
        physical page for a paged pool (axis 1 = n_pages), one slot row
        for a dense batch-1 prefill cache (axis 1 = batch)."""
        n = 0
        for e in attn:
            if e is None:
                continue
            n += 2 * (e.k.numel() // e.k.shape[1]) * e.k.element_size()
        return int(n)

    # -- paged-pool helpers ---------------------------------------------------
    def _alloc_pages(self, n: int) -> np.ndarray:
        """Pool alloc with prefix-cache backpressure: on exhaustion, evict
        LRU tree retentions until the request fits, then retry. Raises
        :class:`PoolExhausted` when even eviction cannot cover it; it
        never preempts (resume paths use it, and a resume stealing pages
        from another active slot would be swap ping-pong)."""
        try:
            return self.pool.alloc(n)
        except PoolExhausted:
            if self.prefix_cache is None:
                raise
            self.prefix_cache.evict(n - self.pool.n_free)
            return self.pool.alloc(n)

    def _alloc_pages_preempting(self, n: int) -> np.ndarray:
        """Admission-path alloc: evict tree retentions first, then
        preempt active slots — lowest priority, fewest-pages-lost-first,
        never the last active slot — until the allocation fits. Raises
        :class:`PoolExhausted` when no eligible victim remains (deny
        instead of thrash)."""
        while True:
            try:
                return self._alloc_pages(n)
            except PoolExhausted:
                if not self.preemption or not self._preempt_one():
                    raise

    def _side_caches(self):
        return make_caches(self.cfg, 1, self.max_len, dtype=self.cache_dtype,
                           kv_dtype=self.kv_dtype, device=self.device,
                           with_attn=False)

    def _idx(self, x) -> torch.Tensor:
        """Host ints / int array -> int32 tensor on this engine's device."""
        return torch.as_tensor(np.asarray(x, np.int32), device=self.device)

    def _dev_feats(self, feats) -> torch.Tensor:
        """Projected features or raw frames (numpy or tensor) -> f32 on
        this device."""
        return torch.as_tensor(feats, dtype=torch.float32,
                               device=self.device)

    def page_holders(self) -> List[Sequence[int]]:
        """Every holder of pool pages this engine knows about: one entry
        per active slot, the prefix-cache retentions, every in-flight
        chunked-prefill task, and finished-but-unadmitted continuous
        payloads (leak audits)."""
        holders: List[Sequence[int]] = [
            p for p in self._slot_pages if p is not None]
        if self.prefix_cache is not None:
            holders.append(self.prefix_cache.retained_pages())
        holders.extend(t.held_pages() for t in self._inflight_tasks)
        if self.scheduler is not None:
            holders.extend(job.result[1].page_ids
                           for job in self.scheduler.ready
                           if job.result is not None)
        return holders

    def assert_no_page_leaks(self, extra_holders: Sequence = ()) -> None:
        """Pool leak audit: every used page must be accounted for by an
        active slot, the radix tree, or a caller-supplied holder (e.g. an
        un-inserted payload), with exact per-page ref counts — and every
        host-swap entry by a preempted request's handle."""
        self.pool.assert_balanced(
            [*self.page_holders(), *extra_holders],
            swap_handles=[pr.handle for pr in self.preempted
                          if pr.handle is not None])

    # -- page-level preemption ------------------------------------------------
    def _preempt_one(self) -> bool:
        """Preempt one victim to relieve pool pressure. Returns False
        when nothing is eligible: fewer than two active slots (the last
        active request is never preempted — preempting it to serve
        itself or an incoming request is pure thrash), or every
        candidate is starvation-guarded."""
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if len(active) <= 1:
            return False
        cands = []
        for i in active:
            r = self.slots[i]
            pages = self._slot_pages[i]
            n_private = sum(1 for p in pages
                            if self.pool.refcount(int(p)) == 1)
            mark = self._resume_marks.get(r.request_id)
            cands.append(VictimCandidate(
                slot=i, pages_lost=n_private, priority=r.priority,
                made_progress=(mark is None
                               or len(r.output_tokens) > mark),
                preempt_count=r.n_preempts))
        v = pick_preemption_victim(cands)
        if v is None:
            return False
        self.preempt_slot(v.slot)
        return True

    def preempt_slot(self, slot: int) -> PreemptedRequest:
        """Evict one active decode slot to make room: tree-shared pages
        (the leading run with refcount > 1) are unref'd — their KV stays
        device-resident under the other holders' refs — and the private
        remainder (CoW copies, generated-token pages) is gathered to the
        host swap store. The request parks in ``self.preempted`` until
        ``try_resume`` re-admits it."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"slot {slot} is not active")
        pages = self._slot_pages[slot]
        t0 = time.perf_counter()
        n_shared = 0
        if self.prefix_cache is not None:
            while (n_shared < len(pages)
                   and self.pool.refcount(int(pages[n_shared])) > 1):
                n_shared += 1
        private = pages[n_shared:]
        handle = None
        with self.tracer.span("preempt.swap_out", track=self.name,
                              request_id=req.request_id,
                              n_private=len(private), n_shared=n_shared):
            if len(private):
                # a host copy, taken before the pool pages are reused
                data = tuple(
                    None if e is None else type(e)(*(t.cpu() for t in e))
                    for e in self._gather_pages(self.caches["attn"],
                                                self._idx(private)))
                handle = self.pool.swap_out(private, data)
                self._m_swap_out.inc(len(private))
            if n_shared:
                self.pool.unref(pages[:n_shared])

        # host copies of the slot's own side state (its SSM state and conv
        # tail, its cross-KV, its length): the lock-step decode keeps
        # writing the live batch tensors, and a resumed or new request
        # takes the slot's cross-KV, while the request is parked
        def take(e):
            return None if e is None else type(e)(*(
                t[:, slot:slot + 1].to("cpu", copy=True) for t in e))

        side = {"ssm": tuple(map(take, self.caches["ssm"])),
                "cross": take(self.caches["cross"]),
                "len": self.caches["len"][slot:slot + 1].cpu().clone()}
        pr = PreemptedRequest(req=req, handle=handle,
                              n_shared_pages=n_shared, n_pages=len(pages),
                              side=side, last_tok=int(self._last_tok[slot]))
        self.slots[slot] = None
        self._slot_pages[slot] = None
        # unmap the row: the parked slot's lock-step decode writes land
        # on the trash page, never on re-allocated pages
        self.caches["pages"][slot] = 0
        req.n_preempts += 1
        self._m_preempt.inc()
        if self.tracer.enabled:
            pr.t_parked = self.tracer.now()
        self._note(req.request_id, "swap", time.perf_counter() - t0,
                   source="compute")
        self.preempted.append(pr)
        return pr

    def try_resume(self) -> int:
        """Re-admit preempted requests in FIFO order while free slots
        and pages allow; stops at the first one that does not fit (FIFO
        keeps resume fair — no overtaking by smaller requests)."""
        n = 0
        while self.preempted and self.free_slots():
            if not self._resume(self.preempted[0], self.free_slots()[0]):
                break
            self.preempted.pop(0)
            n += 1
        return n

    def _resume(self, pr: PreemptedRequest, slot: int) -> bool:
        """Re-fault one preempted request into ``slot``: re-ref its
        shared prefix from the tree (recomputing any pages the tree
        evicted meanwhile into private copies), swap its private pages
        back in, and restore side state + block table. Returns False —
        with every ref unwound and the swap handle untouched — when the
        pool cannot cover it yet."""
        page = self.page_size
        row = np.zeros((self.max_len // page,), np.int32)
        n_shared = pr.n_shared_pages
        t0 = time.perf_counter()
        m = MatchResult()
        try:
            resident = 0
            if n_shared:
                m = self.prefix_cache.match_and_ref(
                    pr.req.prompt_tokens, cap=n_shared * page)
                if m.cow_src is not None:     # full pages only on resume
                    self.pool.unref([m.cow_src])
                    m.cow_src = None
                resident = m.n_full_pages
                row[:resident] = m.page_ids
            # reserve EVERYTHING still needed (evicted-prefix re-fault
            # pages + the swapped private set) in one atomic alloc, so a
            # failed attempt unwinds before any compute runs or the swap
            # handle is consumed — no repeated recompute, no double-
            # counted metrics across retries
            n_miss = n_shared - resident
            n_priv = pr.handle.n_pages if pr.handle is not None else 0
            ids_all = self._alloc_pages(n_miss + n_priv)
        except PoolExhausted:
            self.pool.unref(m.page_ids)
            return False
        if n_miss:
            # the tree evicted part of the shared prefix while this
            # request was parked: re-fault private copies by recomputing
            # those tokens' KV through the suffix step (prefix_len =
            # tokens still resident). Without this the block table would
            # dangle on freed/re-used pages.
            row[resident:n_shared] = ids_all[:n_miss]
            pos, end = resident * page, n_shared * page
            with self.tracer.span("preempt.refault", track=self.name,
                                  request_id=pr.req.request_id,
                                  n_pages=n_miss):
                sfx = np.asarray(pr.req.prompt_tokens[pos:end],
                                 np.int32)[None]
                side = self._side_caches()
                pcaches = {"attn": self.caches["attn"], "ssm": side["ssm"],
                           "cross": side["cross"], "len": side["len"],
                           "pages": self._idx(row[None])}
                _, new = self._prefill_suffix(
                    self.params, self._idx(sfx), self._idx([end]), pcaches,
                    pos, pos)
                self.caches["attn"] = new["attn"]
            self._m_refault.inc(n_miss)
        if pr.handle is not None:
            # hand the reserved pages back so swap_in (the only consumer
            # of the handle) re-pops exactly them — it cannot fail now
            # on pool pressure (it CAN still lose the handle's contents
            # when the swap-tier fault site fires, see below)
            self.pool.free(ids_all[n_miss:])
            try:
                ids, data = self.pool.swap_in(pr.handle)
            except SwapLost:
                return self._recover_swap_lost(pr, slot, row, n_shared, t0)
            with self.tracer.span("preempt.swap_in", track=self.name,
                                  request_id=pr.req.request_id,
                                  n_pages=len(ids)):
                row[n_shared:n_shared + len(ids)] = ids
                self.caches["attn"] = self._scatter_pages(
                    self.caches["attn"], data, self._idx(ids))
            self._m_swap_in.inc(len(ids))
        self.caches = self._insert_side(pr.side, self.caches,
                                        self._idx(row), slot)
        self._slot_pages[slot] = np.asarray(row[:pr.n_pages], np.int32)
        self.slots[slot] = pr.req
        self._last_tok[slot] = pr.last_tok
        self._resume_marks[pr.req.request_id] = len(pr.req.output_tokens)
        self._m_resume.inc()
        self._mark_resumed(pr, t0)
        return True

    def _mark_resumed(self, pr: PreemptedRequest, t0: float) -> None:
        """Shared resume bookkeeping: the parked gap becomes a span on
        this engine's track, and the re-fault work done inside this call
        is reclassified from the request's parked-queue time into its
        swap component."""
        if self.tracer.enabled:
            self.tracer.add("preempt.parked", pr.t_parked, self.tracer.now(),
                            track=self.name, request_id=pr.req.request_id,
                            n_pages=pr.n_pages)
        self._note(pr.req.request_id, "swap", time.perf_counter() - t0,
                   source="queue")

    def _recover_swap_lost(self, pr: PreemptedRequest, slot: int,
                           row: np.ndarray, n_shared: int,
                           t0: float) -> bool:
        """Swap-loss recovery arm: the host swap tier lost the handle's
        contents mid-``_resume`` (the handle is consumed — there is
        nothing left to retry against). The KV it held is nonetheless
        reconstructible: at preemption the cache covered
        ``prompt + output_tokens[:-1]`` (the final output token is
        ``last_tok``, still waiting to be fed), and greedy decode is
        deterministic — so recomputing exactly those token positions
        through the suffix-prefill step rebuilds bit-identical KV in
        fresh private pages, and decode resumes at the exact position.

        Engines without the suffix step (SSM / cross-attention decoders)
        or multimodal requests (their feature embeddings are not
        retained) cannot recompute: the request is killed, every page
        ref unwound, and the loss surfaced via ``self.lost`` — never a
        silent drop. Always returns True: the preempted entry is
        consumed either way (the handle no longer exists)."""
        req = pr.req
        page = self.page_size
        n_priv = pr.n_pages - n_shared
        if self._prefill_suffix is None or req.is_multimodal:
            if n_shared:
                self.pool.unref(row[:n_shared])
            req.killed = True
            self.lost.append(req)
            self._m_lost.inc()
            return True
        # the reservation freed just before swap_in is still on the free
        # list — reclaim it for the recomputed copies
        with self.tracer.span("recover.swap_lost", track=self.name,
                              request_id=req.request_id, n_pages=n_priv):
            ids = self._alloc_pages(n_priv)
            row[n_shared:n_shared + n_priv] = ids
            seq = list(req.prompt_tokens) + list(req.output_tokens[:-1])
            pos = n_shared * page
            win = n_priv * page
            sfx = np.zeros((1, win), np.int32)
            sfx[0, :len(seq) - pos] = seq[pos:]
            side = self._side_caches()
            pcaches = {"attn": self.caches["attn"], "ssm": side["ssm"],
                       "cross": side["cross"], "len": side["len"],
                       "pages": self._idx(row[None])}
            _, new = self._prefill_suffix(
                self.params, self._idx(sfx), self._idx([len(seq)]), pcaches,
                pos, pos)
            self.caches["attn"] = new["attn"]
        self._m_swap_lost_rec.inc()
        self._m_refault.inc(n_priv)
        self.caches = self._insert_side(pr.side, self.caches,
                                        self._idx(row), slot)
        self._slot_pages[slot] = np.asarray(row[:pr.n_pages], np.int32)
        self.slots[slot] = req
        self._last_tok[slot] = pr.last_tok
        self._resume_marks[req.request_id] = len(req.output_tokens)
        self._m_resume.inc()
        self._mark_resumed(pr, t0)
        return True

    # -- stages --------------------------------------------------------------
    def prefill_request(self, req: Request, mm_embeds=None,
                        enc_frames=None, mm_feats=None, mm_key=None):
        """Run Prefill for one request (batch=1). Returns (first_token,
        payload) — the payload is the P->D handoff unit: the prefilled
        cache dict (dense) or a PagedKVPayload naming pool pages.

        With the prefix cache enabled, text-only prompts reuse the
        longest cached prefix and compute only the suffix.

        Multimodal inputs arrive one of two ways:
        * ``mm_embeds`` — RAW frontend embeddings, projected and
          prepended inside the forward (the legacy fused path; falls
          back to monolithic prefill).
        * ``mm_feats`` + ``mm_key`` — the Encode-stage hand-off:
          features ALREADY projected to d_model (from the MM Store),
          scattered into the embedding stream at image-token positions
          [req.mm_pos, req.mm_pos + n_mm). ``mm_key`` (the content
          hash) extends the radix prefix-cache key with a pseudo-token
          run, so identical image+prompt pairs compose MM Store dedup
          with KV reuse — and composes with chunked prefill: text
          chunks proceed normally, the chunk overlapping the image run
          scatters exactly its slice. ``mm_feats=None`` with ``mm_key``
          set means the caller skipped the encode forward because the
          prefix cache covers the whole image run (verified here).
        """
        with self.tracer.span("prefill", track=self.name,
                              request_id=req.request_id,
                              tokens=len(req.prompt_tokens)):
            return self._prefill_request(req, mm_embeds, enc_frames,
                                         mm_feats, mm_key)

    def _prefill_request(self, req: Request, mm_embeds=None,
                         enc_frames=None, mm_feats=None, mm_key=None):
        cfg = self.cfg
        n_mm = 0
        if enc_frames is not None:
            enc_frames = self._dev_feats(enc_frames)
        if mm_feats is not None:
            mm_feats = self._dev_feats(mm_feats)
            n_mm = mm_feats.shape[1]
        elif mm_key is not None:
            n_mm = req.mm_tokens
        elif mm_embeds is not None and cfg.encoder is None:
            n_mm = mm_embeds.shape[1]
        toks = np.asarray(req.prompt_tokens, np.int32)[None]
        pad = self.max_len - n_mm - toks.shape[1]
        if pad < 0:
            raise ValueError(
                f"prompt ({toks.shape[1]}+{n_mm}) exceeds max_len {self.max_len}")
        n_tokens = len(req.prompt_tokens) + n_mm

        scatter = mm_feats is not None or mm_key is not None
        if ((self.chunked_prefill or self.prefix_cache is not None)
                and mm_embeds is None and enc_frames is None
                and (n_mm == 0 or scatter) and self.paged):
            return self._prefill_chunked(req, n_tokens, mm_feats, mm_key)
        if mm_key is not None and mm_feats is None:
            raise ValueError(
                "encode was skipped (mm_feats=None) but this engine has "
                "no prefix cache to supply the image run's KV")

        mm_start = None
        if scatter:
            # feed placeholder 0-tokens at image positions; the scatter
            # overwrites their embeddings with the projected features
            p = list(req.prompt_tokens)
            toks = np.asarray(p[:req.mm_pos] + [0] * n_mm + p[req.mm_pos:],
                              np.int32)[None]
            mm_start = int(req.mm_pos)
        # pad the TEXT width: a scatter-path toks already contains the
        # n_mm placeholders, a prepend-path toks grows them inside the
        # forward — either way the model sees max_len positions.
        lengths = self._idx([n_tokens])
        if not self.paged:
            toks = np.pad(toks, ((0, 0), (0, pad)))
            if self._prefill_caches is None:
                self._prefill_caches = make_caches(
                    cfg, 1, self.max_len, dtype=self.cache_dtype,
                    kv_dtype=self.kv_dtype, device=self.device)
            logits, caches = self._prefill(self.params, self._idx(toks),
                                           lengths, self._prefill_caches,
                                           mm_embeds, enc_frames, mm_feats,
                                           mm_start)
            first = int(torch.argmax(logits[0]))
            self._count_prefill(n_tokens, n_tokens)
            return first, caches

        # ---- paged: write KV straight into this engine's pool pages ----
        toks = np.pad(toks, ((0, 0), (0, pad)))
        ids = self._alloc_pages(self.pool.pages_for(n_tokens))
        row = np.zeros((1, self.max_len // self.page_size), np.int32)
        row[0, :len(ids)] = ids
        side = self._side_caches()
        pcaches = {"attn": self.caches["attn"], "ssm": side["ssm"],
                   "cross": side["cross"], "len": side["len"],
                   "pages": self._idx(row)}
        logits, new = self._prefill(self.params, self._idx(toks), lengths,
                                    pcaches, mm_embeds, enc_frames,
                                    mm_feats, mm_start)
        self.caches["attn"] = new["attn"]      # pool pages updated in place
        first = int(torch.argmax(logits[0]))
        self._count_prefill(n_tokens, n_tokens)
        payload = PagedKVPayload(
            source=self, page_ids=ids, n_tokens=n_tokens,
            side={"ssm": new["ssm"], "cross": new["cross"],
                  "len": new["len"]},
            kv_nbytes=len(ids) * self._attn_kv_nbytes(self.caches["attn"]))
        return first, payload

    def _prefill_chunked(self, req: Request, n_tokens: int,
                         mm_feats=None, mm_key=None):
        """Chunked prefill (text-only, batch 1): compute the prompt in
        fixed windows of ``prefill_chunk`` tokens. Chunk *k* allocates
        only its own pages, scatters its KV into the pool, and attends
        over chunks 0..k-1 via the block-table gather (``prefix_len`` =
        tokens already resident, ``pos_base`` = the chunk's page-aligned
        start) — so the in-flight window is O(chunk), not O(prompt).

        With the prefix cache enabled, the longest cached prefix is
        ref'd first and whole leading chunks are skipped; a match ending
        inside a page is copied on write so shared pages are never
        mutated. The payload records per-chunk (tokens, pages) segments
        so the P->D planner can stream chunk *k* while chunk *k+1*
        computes.

        This is ALSO the prefix-cache hit path of a non-chunked engine:
        with the window widened to the whole prompt, the loop runs once
        and degenerates to the monolithic suffix prefill (same trace
        bucket, same CoW/unwind protocol — one implementation to audit).
        Such payloads carry no segments, so the cluster plans their
        transfer monolithically.

        Implementation: a :class:`PrefillTask` driven to completion in
        a tight loop — the SAME state machine the iteration-level
        scheduler advances one chunk at a time, so the serial and
        continuous paths share one implementation to audit and are
        bit-identical by construction."""
        task = PrefillTask(self, req, n_tokens, mm_feats, mm_key)
        try:
            while not task.finished:
                task.run_chunk()
        except BaseException:
            # un-wind every ref this request took (match, CoW source,
            # every chunk's fresh pages) so a failed prefill leaks nothing
            task.abort()
            raise
        return task.finish()

    def insert(self, req: Request, prefilled, first_token: int,
               append_token: bool = True) -> int:
        """Attach a prefilled request to a free decode slot (P->D import).

        Dense: copy the batch-1 cache into batch slot ``slot``.
        Paged: adopt the payload's pages — a block-table write when the
        pages are already in this engine's pool, else an O(pages) copy.
        A failed paged insert (no free slot, destination pool full)
        raises before mutating anything: the payload stays retryable.
        Abandon one with ``release_payload`` or its pages leak.

        ``append_token=False`` skips recording ``first_token`` as a new
        output: a re-route/migration insert resumes a request whose
        ``output_tokens`` already contain it (the token is only the next
        decode input, not new progress).
        """
        if self.crashed:
            raise InstanceDown(self.name, 0)
        free = self.free_slots()
        if not free:
            raise NoFreeSlot()
        slot = free[0]
        with self.tracer.span("insert", track=self.name,
                              request_id=req.request_id):
            if self.paged:
                self._insert_paged(prefilled, slot)
            else:
                self.caches = self._insert(prefilled, self.caches, slot)
                nbytes = self._attn_kv_nbytes(prefilled["attn"])
                self._m_insert_bytes_last.set(nbytes)
                self._m_insert_bytes.inc(nbytes)
        self.slots[slot] = req
        self._last_tok[slot] = first_token
        if append_token:
            req.output_tokens.append(first_token)
        return slot

    def release_payload(self, payload: PagedKVPayload) -> None:
        """Drop an un-inserted paged payload, returning its pages to the
        source pool. A failed ``insert`` (no free slot / destination
        pool exhausted) leaves the payload intact and retryable; call
        this when abandoning it instead, or the pages leak until the
        source engine is rebuilt."""
        if len(payload.page_ids):
            payload.source.pool.free(payload.page_ids)
            payload.page_ids = np.zeros((0,), np.int32)

    def _insert_paged(self, payload: PagedKVPayload, slot: int) -> None:
        if payload.source is self:
            ids = payload.page_ids               # zero-copy handoff
            self._m_insert_bytes_last.set(0)
        else:
            ids = self._alloc_pages_preempting(payload.n_pages)
            self.caches["attn"] = self._copy_pages(
                payload.source.caches["attn"], self.caches["attn"],
                self._idx(payload.page_ids), self._idx(ids))
            payload.source.pool.free(payload.page_ids)
            self._m_insert_bytes_last.set(payload.kv_nbytes)
        self._m_insert_bytes.inc(self._m_insert_bytes_last.value)
        row = np.zeros((self.max_len // self.page_size,), np.int32)
        row[:len(ids)] = ids
        self.caches = self._insert_side(payload.side, self.caches,
                                        self._idx(row), slot)
        self._slot_pages[slot] = np.asarray(ids)
        # neutralize the payload: its refs now belong to the slot, so a
        # stray release_payload must be a no-op, not an unref of pages a
        # live slot (or the prefix tree) still owns
        payload.page_ids = np.zeros((0,), np.int32)

    def _grow_pages(self, lens: np.ndarray) -> None:
        """Map a fresh page for any slot whose next token crosses a page
        boundary (host-side allocator; one batched table update).

        The allocation is all-or-nothing: every slot's demand is summed
        and allocated in one pool call BEFORE any bookkeeping mutates,
        so a pool-exhaustion error leaves host state and device block
        tables consistent (the caller can drain slots and retry).

        With ``preemption=True``, exhaustion preempts a victim (fewest
        private pages lost, never the last active slot) and re-derives
        the demand — a preempted slot both frees pages and drops out of
        the demand list — repeating until the growth fits or no victim
        remains (then the typed :class:`PoolExhausted` propagates,
        which is the pre-preemption kill behavior)."""
        width = self.max_len // self.page_size
        while True:
            demand: List[Tuple[int, int, int]] = []    # (slot, have, n_new)
            for i, req in enumerate(self.slots):
                if req is None:
                    continue
                need = min(int(lens[i]) // self.page_size + 1, width)
                have = len(self._slot_pages[i])
                if need > have:
                    demand.append((i, have, need - have))
            if not demand:
                return
            try:
                ids = self._alloc_pages(sum(n for _, _, n in demand))
                break                                  # atomic
            except PoolExhausted:
                if not self.preemption or not self._preempt_one():
                    raise
        updates: List[Tuple[int, int, int]] = []
        off = 0
        for i, have, n in demand:
            new = ids[off:off + n]
            off += n
            self._slot_pages[i] = np.concatenate([self._slot_pages[i], new])
            updates.extend((i, have + j, int(p)) for j, p in enumerate(new))
        rows, cols, vals = zip(*updates)
        self.caches["pages"][self._idx(rows).long(),
                             self._idx(cols).long()] = self._idx(vals)

    def _release_slot(self, slot: int) -> None:
        if self._slot_pages[slot] is not None:
            self.pool.free(self._slot_pages[slot])
            self._slot_pages[slot] = None
        # unmap the row so stale entries can't alias re-allocated pages;
        # a freed slot's decode writes land on the trash page.
        self.caches["pages"][slot] = 0

    def mark_crashed(self) -> List[Request]:
        """The fault plane declared this instance dead: harvest every
        request it owned — active slots plus parked preemptees — for the
        cluster's re-route arm, and flip ``crashed`` so later serving
        calls raise :class:`InstanceDown` instead of quietly computing
        against a pool that no longer exists. Slot/pool state is NOT
        unwound (the device is gone, there is nothing to free into);
        leak audits exclude crashed instances."""
        self.crashed = True
        out = [r for r in self.slots if r is not None]
        out += [pr.req for pr in self.preempted]
        return out

    def decode_step(self) -> List[Tuple[Request, int, bool]]:
        """One lock-step decode over all slots. Returns (req, token, done)
        for every ACTIVE slot (inactive slots compute but are ignored).
        Preempted requests are re-admitted first (FIFO, page-permitting)
        so a resumed slot decodes in this very step.

        Decode spans are SAMPLED: one ``decode.step`` span every
        ``tracer.decode_sample`` steps (this is the highest-frequency
        phase; per-step spans at production rates would dominate the
        trace)."""
        if self.crashed:
            raise InstanceDown(self.name, 0)
        self._decode_steps += 1
        if self.tracer.want_decode_span(self._decode_steps):
            with self.tracer.span("decode.step", track=self.name,
                                  step=self._decode_steps,
                                  batch=self.n_active):
                return self._decode_step_inner()
        return self._decode_step_inner()

    def _decode_step_inner(self) -> List[Tuple[Request, int, bool]]:
        if self.paged and self.preempted:
            self.try_resume()
        if self.n_active == 0:
            # idle-batch early-out: with zero active slots the
            # forward would compute only trash-page rows — skip the
            # dispatch AND the device->host len sync entirely. (Checked
            # after try_resume so a successful re-admission still
            # decodes this very step.)
            return []
        # single device->host sync per step (not per slot); a copy,
        # since the step advances "len" in place and on the CPU .cpu()
        # is the tensor itself
        lens = self.caches["len"].cpu().numpy().copy()
        if self.paged:
            self._grow_pages(lens)
        toks, self.caches = self._decode(
            self.params, self._idx(self._last_tok), self.caches, self._gen)
        toks = toks.cpu().numpy()
        out = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            t = int(toks[i])
            self._last_tok[i] = t
            req.output_tokens.append(t)
            # lens[i] is the PRE-step resident length: this step's KV
            # landed at index lens[i], so the cache now holds lens[i]+1
            # tokens and the next step would write at lens[i]+1 — done
            # exactly when that would spill past max_len (the cache can
            # fill to the last position, no give-away row).
            done = (t == req.eos_token or
                    len(req.output_tokens) >= req.max_new_tokens or
                    int(lens[i]) + 1 >= self.max_len)
            if done:
                self.slots[i] = None
                self._resume_marks.pop(req.request_id, None)
                if self.paged:
                    self._release_slot(i)
            out.append((req, t, done))
        return out

    # -- continuous batching (iteration-level scheduling, fused PD) -----------
    def start_prefill_task(self, req: Request, mm_feats=None, mm_key=None,
                           defer_features: bool = False) -> PrefillTask:
        """Create (without running) the resumable chunk state machine
        for one request's prefill — the unit the iteration scheduler
        advances. Requires the paged suffix-prefill path; multimodal
        only via the scatter hand-off (``mm_feats``/``mm_key``)."""
        if not self.paged or self._prefill_suffix is None:
            raise ValueError(
                "continuous batching needs a paged engine with the "
                "suffix-prefill step (chunked_prefill / prefix_cache on "
                "an attention-only decoder)")
        n_mm = 0
        if mm_feats is not None:
            n_mm = mm_feats.shape[1]
        elif mm_key is not None:
            n_mm = req.mm_tokens
        n_tokens = len(req.prompt_tokens) + n_mm
        if n_tokens > self.max_len:
            raise ValueError(
                f"prompt ({n_tokens}) exceeds max_len {self.max_len}")
        return PrefillTask(self, req, n_tokens, mm_feats, mm_key,
                           defer_features=defer_features)

    def submit(self, req: Request, *, mm_feats=None, mm_key=None,
               ready_at: float = 0.0,
               feature_ready_at: float = 0.0) -> PrefillJob:
        """Queue one request for continuous (iteration-level) serving on
        this fused engine; ``step()`` drains the queue. The scheduler is
        created on first use — engines never pay for it otherwise."""
        if self.scheduler is None:
            self.scheduler = IterationScheduler()
        n_mm = mm_feats.shape[1] if mm_feats is not None else (
            req.mm_tokens if mm_key is not None else 0)
        job = PrefillJob(
            req=req, n_tokens=len(req.prompt_tokens) + n_mm,
            chunk=self.prefill_chunk if self.chunked_prefill
            else self.max_len,
            ready_at=ready_at, feature_ready_at=feature_ready_at)
        job.meta["mm_feats"] = mm_feats
        job.meta["mm_key"] = mm_key
        return self.scheduler.submit(job)

    def step(self, now: float = 0.0) -> List[Tuple[Request, int, bool]]:
        """One continuous-batching iteration: execute the scheduler's
        batch plan — admit finished prefills into free decode slots,
        advance one chunk of each scheduled prefill, then run one
        lock-step decode over every active slot. Returns the decode
        outputs (same shape as ``decode_step``)."""
        sched = self.scheduler
        if sched is None:
            return (self.decode_step()
                    if self.n_active or self.preempted else [])
        plan = sched.plan(now=now, free_slots=len(self.free_slots()),
                          active_decode=self.n_active
                          + len(self.preempted))
        return self.execute_plan(plan)

    def execute_plan(self, plan: BatchPlan) -> List[Tuple[Request, int, bool]]:
        """Carry out one batch plan against this fused engine. Split
        from ``step`` so tests can drive hand-built plans."""
        sched = self.scheduler
        self._m_sched_steps.inc()
        with self.tracer.span("sched.step", track=self.name,
                              step=plan.step, n_chunks=len(plan.chunks),
                              n_admit=len(plan.admit),
                              batch=self.n_active):
            for job in plan.admit:
                first, payload = job.result
                try:
                    self.insert(job.req, payload, first)
                except (NoFreeSlot, PoolExhausted):
                    sched.requeue_ready(job)
                    continue
                self._m_sched_admits.inc()
            for job in plan.chunks:
                if job.task is None:
                    job.task = self.start_prefill_task(
                        job.req, job.meta.get("mm_feats"),
                        job.meta.get("mm_key"),
                        defer_features=job.feature_ready_at > 0)
                try:
                    job.task.run_chunk()
                except PoolExhausted:
                    # allocator left the task untouched: stall + retry
                    # once decode drain / preemption frees pages
                    sched.note_stall(job, "pool")
                    continue
                self._m_sched_chunks.inc()
                if job.task.finished:
                    job.result = job.task.finish()
                    sched.mark_ready(job)
            out = []
            if plan.decode and (self.n_active or self.preempted):
                if plan.chunks:
                    self._m_sched_mixed.inc()
                out = self.decode_step()
        return out

    def drain_continuous(self, max_steps: int = 10_000,
                         now_fn=None) -> List[Tuple[Request, int, bool]]:
        """Step until every submitted request has prefetched, admitted,
        and decoded to completion. ``now_fn`` supplies the modeled clock
        for barrier checks (default: barriers already satisfied)."""
        out: List[Tuple[Request, int, bool]] = []
        steps = 0
        while ((self.scheduler is not None and self.scheduler.has_work)
               or self.n_active or self.preempted):
            out.extend(self.step(now=now_fn() if now_fn else 0.0))
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"continuous drain made no progress in {max_steps} "
                    f"steps (stalls: "
                    f"{self.scheduler.stall_counts if self.scheduler else {}})")
        return out

    # -- monolithic convenience (the vLLM-style baseline) ---------------------
    def run_request(self, req: Request) -> List[int]:
        """Serial E->P->D for one request on this single engine. VLM
        requests run encode-inline-with-prefill: the frontend forward
        happens here, serialized before prefill, through the same
        projector the Encode stage uses — so greedy outputs match the
        disaggregated path bit-for-bit."""
        mm = None
        enc = None
        mm_feats = None
        mm_key = None
        cfg = self.cfg
        if req.is_multimodal and cfg.frontend is not None:
            feats = FE.stub_embeddings(cfg, req.mm_payload,
                                       req.mm_tokens or None)
            if cfg.encoder is not None:
                enc = feats[None]
            else:
                mm_key = FE.content_hash(req.mm_payload)
                mm_feats = self._encode_inline(self.params, feats)[None]
        first, caches = self.prefill_request(req, mm, enc, mm_feats, mm_key)
        self.insert(req, caches, first)
        while any(s is req for s in self.slots):
            self.decode_step()
        return req.output_tokens

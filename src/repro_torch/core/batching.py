"""Iteration-level batch composition — continuous batching for all stages.

Production inference engines (vLLM, sglang's hybrid coordinator) never
serve one request at a time: every device iteration a scheduler composes
a batch from the READY prefill chunks of *different* requests plus every
ongoing decode, admits finished prefills against free decode capacity,
and keeps the device saturated between one request's chunks instead of
blocking on its serial chunk loop. This module is that composer for the
EPD cluster: the :class:`IterationScheduler` produces one
:class:`BatchPlan` per step, and an executor (``Engine.step`` for a
fused engine, ``EPDCluster.run_continuous`` for the disaggregated
cluster) carries it out against real engines.

Scheduling state lives in :class:`PrefillJob` wrappers so the scheduler
stays decoupled from the execution layer: the executor attaches the
engine-side ``PrefillTask`` (the resumable chunk state machine extracted
from ``Engine._prefill_chunked``) on first touch, and dependency edges —
the E->P feature-arrival barrier of the async overlap arm, the
whole-request barrier of the sync arm — are plain ``ready_at`` clocks
the plan respects: a job whose next chunk would cross an unmet barrier
is reported as *stalled* and other jobs' chunks fill the iteration.

The :class:`StreamTimeline` is the modeled clock for disaggregated
throughput accounting: the Prefill device and the Decode device are
separate streams, so a serial driver's makespan is the SUM of both
streams' work while the continuous scheduler's is their MAX (plus
unhidden barriers). ``fused=True`` collapses it to one clock — exactly
the serial chunk-loop baseline the benchmark compares against.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

from repro_torch.serving.request import Request


@dataclass
class PrefillJob:
    """One request's prefill as the scheduler sees it.

    ``task`` (the engine-side chunk state machine) and ``result`` (the
    ``(first_token, payload)`` pair once the prefill finished) are
    attached by the executor; the scheduler only reads them.

    Barrier clocks (modeled time, same timebase as ``plan(now=...)``):
    ``ready_at``          — nothing of this job may run earlier (the
                            sync-arm E->P push, or request arrival);
    ``feature_ready_at``  — the async-arm feature arrival: chunks whose
                            window stays before the image run ignore it,
                            the chunk overlapping the run waits for it;
    ``retry_at``          — a READY job parked after a failed decode
                            admission (e.g. a transfer fault): the
                            capped retry backoff as a dependency edge —
                            admission skips the job until the clock
                            reaches it, other ready jobs may overtake.
    """

    req: Request
    n_tokens: int = 0                  # prompt + mm tokens (prefill width)
    chunk: int = 0                     # the engine's chunk window (tokens)
    ready_at: float = 0.0
    feature_ready_at: float = 0.0
    retry_at: float = 0.0
    task: Any = None
    result: Optional[Tuple[int, Any]] = None
    meta: Dict[str, Any] = field(default_factory=dict)

    def blocked_reason(self, now: float) -> Optional[str]:
        """Why this job cannot advance a chunk at modeled time ``now``
        (None = schedulable). Before the task exists the feature barrier
        is judged from the request shape alone: the first chunk window
        is [0, chunk), so it needs features iff the image run starts
        inside it — conservative only when a prefix hit would have
        skipped past the run, which the task-attached check repairs on
        the next plan."""
        if self.ready_at > now:
            return "sync_barrier"
        if self.feature_ready_at > now:
            if self.task is not None:
                if self.task.needs_features_next():
                    return "feature_barrier"
            elif (self.req.is_multimodal and self.req.mm_tokens
                  and self.req.mm_pos < min(self.chunk or self.n_tokens,
                                            self.n_tokens)):
                return "feature_barrier"
        return None

    def barrier_time(self) -> float:
        """Earliest modeled time the next chunk could run (for idle
        jumps when every job is barrier-stalled)."""
        t = self.ready_at
        if self.feature_ready_at and (
                self.task.needs_features_next() if self.task is not None
                else True):
            t = max(t, self.feature_ready_at)
        return t


@dataclass
class BatchPlan:
    """What one device iteration executes.

    ``chunks``  — jobs to advance by ONE prefill chunk each, in order
                  (round-robin across requests, so a long prompt never
                  monopolizes the prefill stream);
    ``admit``   — finished prefills to insert into free decode slots
                  (FIFO over the ready queue, capped at ``free_slots``);
    ``decode``  — run one lock-step decode iteration over active slots;
    ``stalled`` — (job, reason) pairs that could not be scheduled this
                  step: unmet barriers, the live-prefill cap, or a pool
                  stall carried over from execution.
    """

    step: int
    chunks: List[PrefillJob] = field(default_factory=list)
    admit: List[PrefillJob] = field(default_factory=list)
    decode: bool = False
    stalled: List[Tuple[PrefillJob, str]] = field(default_factory=list)

    @property
    def prefill_tokens(self) -> int:
        return sum(j.task.next_chunk_tokens if j.task is not None
                   else min(j.chunk or j.n_tokens, j.n_tokens)
                   for j in self.chunks)

    @property
    def empty(self) -> bool:
        return not (self.chunks or self.admit or self.decode)


class IterationScheduler:
    """Composes one :class:`BatchPlan` per device iteration.

    Queues: ``waiting`` (submitted, prefill not started — holds no pool
    pages yet), ``live`` (prefill in flight, bounded by
    ``max_live_prefills`` so concurrent chunk state cannot eat the page
    pool), ``ready`` (prefill finished, awaiting decode admission — the
    payload holds its pages until the insert lands).

    Admission policy: ready prefills admit FIFO against the executor-
    reported free decode slots; an insert denied by the decode pool
    (``requeue_ready``) returns to the queue head and retries next
    iteration — decode drain / preemption frees pages between steps.
    ``chunk_budget_tokens`` caps the prefill tokens composed into one
    iteration (None = one chunk from every schedulable live job, the
    max-interleave default).
    """

    def __init__(self, *, max_live_prefills: int = 4,
                 chunk_budget_tokens: Optional[int] = None,
                 adaptive_chunking: bool = False,
                 min_chunk_budget: int = 16,
                 max_chunk_budget: int = 1 << 20):
        if max_live_prefills < 1:
            raise ValueError("need max_live_prefills >= 1")
        self.max_live_prefills = max_live_prefills
        self.chunk_budget_tokens = chunk_budget_tokens
        # adaptive chunk sizing (behind a flag): the per-iteration
        # prefill-token budget shrinks when decode slots starve (ready
        # prefills queue against zero free slots — decode drain is the
        # bottleneck, so composing more prefill only grows the held-page
        # working set) and grows back while the decode pool has headroom
        # and no admission backlog exists. Scheduling-only: greedy
        # outputs are bit-identical at any budget.
        self.adaptive_chunking = adaptive_chunking
        self.min_chunk_budget = min_chunk_budget
        self.max_chunk_budget = max_chunk_budget
        self._budget: Optional[int] = chunk_budget_tokens
        self.budget_shrinks = 0
        self.budget_grows = 0
        self.waiting: Deque[PrefillJob] = deque()
        self.live: List[PrefillJob] = []
        self.ready: Deque[PrefillJob] = deque()
        self._rr = 0
        self.steps = 0
        self.stall_counts: Dict[str, int] = {}

    # ---- intake / state transitions (executor-driven) ----
    def submit(self, job: PrefillJob) -> PrefillJob:
        self.waiting.append(job)
        return job

    def mark_ready(self, job: PrefillJob) -> None:
        """Executor: ``job``'s last chunk ran and ``job.result`` is set."""
        if job.result is None:
            raise ValueError("mark_ready before the job has a result")
        self.live.remove(job)
        self.ready.append(job)

    def requeue_ready(self, job: PrefillJob) -> None:
        """Executor: decode admission was denied — retry next iteration
        from the queue head (FIFO fairness, no overtaking)."""
        self.ready.appendleft(job)
        self.note_stall(job, "admission")

    def park_ready(self, job: PrefillJob, retry_at: float,
                   reason: str = "retry_wait") -> None:
        """Executor: admission FAILED in a retryable way (a transfer
        fault drew on the P->D hand-off). The job returns to the queue
        head with a ``retry_at`` barrier: the plan composes around it —
        younger ready jobs may admit first — and ``next_barrier_time``
        exposes the clock so an otherwise-idle loop jumps straight to
        the retry instead of spinning."""
        job.retry_at = retry_at
        self.ready.appendleft(job)
        self.note_stall(job, reason)

    def note_stall(self, job: PrefillJob, reason: str) -> None:
        self.stall_counts[reason] = self.stall_counts.get(reason, 0) + 1

    # ---- introspection ----
    @property
    def has_prefill_work(self) -> bool:
        return bool(self.waiting or self.live)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.live or self.ready)

    def next_barrier_time(self, after: Optional[float] = None,
                          ) -> Optional[float]:
        """Earliest barrier among jobs that could actually run — the
        idle-jump target when a plan came back empty because every job
        is stalled on a future arrival. Waiting jobs count only while
        the live window has headroom: with the window full their
        barriers are unreachable until a live job finishes, so jumping
        to one would stall the clock in the past. Parked READY jobs
        (admission retry backoff) count too: their ``retry_at`` is the
        earliest the re-admission may run.

        ``after`` drops barriers at or before that clock: a pool-stalled
        live job's ELAPSED barrier must not mask a parked job's future
        ``retry_at`` — jumping to the retry releases the parked payload
        and un-deadlocks the pool, where restarting in place never
        advances the clock."""
        jobs = list(self.live)
        if len(self.live) < self.max_live_prefills:
            jobs += list(self.waiting)
        ts = [j.barrier_time() for j in jobs]
        ts += [j.retry_at for j in self.ready if j.retry_at > 0.0]
        if after is not None:
            ts = [t for t in ts if t > after]
        return min(ts) if ts else None

    def _effective_budget(self, free_slots: int) -> Optional[int]:
        """The prefill-token budget this iteration. Static unless
        ``adaptive_chunking``: then decode starvation (finished prefills
        queued against zero free slots) halves it down to
        ``min_chunk_budget`` and admission headroom (free slots, no
        ready backlog) doubles it back up to ``max_chunk_budget``."""
        if not self.adaptive_chunking:
            return self.chunk_budget_tokens
        if free_slots == 0 and self.ready:
            cur = self._budget
            if cur is None:
                # unlimited so far: seed from the widest live chunk so
                # the first shrink is meaningful
                cur = max((j.task.next_chunk_tokens if j.task is not None
                           else min(j.chunk or j.n_tokens, j.n_tokens))
                          for j in self.live) * len(self.live)
            nxt = max(self.min_chunk_budget, cur // 2)
            if nxt != cur:
                self.budget_shrinks += 1
            self._budget = nxt
        elif free_slots > 0 and not self.ready \
                and self._budget is not None:
            nxt = min(self.max_chunk_budget, self._budget * 2)
            if nxt != self._budget:
                self.budget_grows += 1
            self._budget = nxt
        return self._budget

    # ---- the per-iteration composer ----
    def plan(self, *, now: float = 0.0, free_slots: int = 0,
             active_decode: int = 0) -> BatchPlan:
        """Compose one iteration: admissions first (a freed slot is
        ground truth the executor just reported), then promote waiting
        jobs into the live window, then one chunk from each schedulable
        live job starting at the round-robin cursor. ``decode`` is set
        whenever ongoing decodes exist or an admission will create one
        this step."""
        self.steps += 1
        plan = BatchPlan(step=self.steps)
        n = max(0, free_slots)
        if n and self.ready:
            # admission skips jobs parked on a future retry_at (the
            # transfer-fault backoff edge): the plan composes around
            # them — later ready jobs may overtake — and they rejoin
            # FIFO order once the clock reaches the barrier.
            keep: List[PrefillJob] = []
            while self.ready and len(plan.admit) < n:
                job = self.ready.popleft()
                if job.retry_at > now:
                    keep.append(job)
                    plan.stalled.append((job, "retry_wait"))
                    self.note_stall(job, "retry_wait")
                    continue
                plan.admit.append(job)
            for job in reversed(keep):
                self.ready.appendleft(job)
        while self.waiting and len(self.live) < self.max_live_prefills:
            self.live.append(self.waiting.popleft())
        if self.live:
            budget = self._effective_budget(free_slots)
            order = [self.live[(self._rr + i) % len(self.live)]
                     for i in range(len(self.live))]
            self._rr = (self._rr + 1) % max(len(self.live), 1)
            for job in order:
                why = job.blocked_reason(now)
                if why is not None:
                    plan.stalled.append((job, why))
                    self.note_stall(job, why)
                    continue
                ntok = (job.task.next_chunk_tokens if job.task is not None
                        else min(job.chunk or job.n_tokens, job.n_tokens))
                if budget is not None and plan.chunks and ntok > budget:
                    plan.stalled.append((job, "budget"))
                    continue
                plan.chunks.append(job)
                if budget is not None:
                    budget -= ntok
        plan.decode = bool(active_decode or plan.admit)
        return plan


@dataclass
class StreamTimeline:
    """Modeled two-stream clock for disaggregated continuous batching.

    The Prefill device and the Decode device(s) are separate hardware:
    each charge advances its own stream, ``not_before`` expresses a
    dependency edge (a request's first decode cannot start before its
    prefill + exposed transfer; a barrier chunk cannot start before its
    feature arrives), and the makespan is the latest stream. A serial
    driver runs the same operations on one python thread with each
    stage blocking the next, so ``fused=True`` serializes every charge
    onto a single clock — the baseline the throughput benchmark divides
    by."""

    fused: bool = False
    t_encode: float = 0.0
    t_prefill: float = 0.0
    t_decode: float = 0.0

    def _charge(self, attr: str, dur: float, not_before: float) -> float:
        if self.fused:
            t = max(self.t_encode, self.t_prefill, self.t_decode,
                    not_before) + dur
            self.t_encode = self.t_prefill = self.t_decode = t
            return t
        t = max(getattr(self, attr), not_before) + dur
        setattr(self, attr, t)
        return t

    def charge_encode(self, dur: float, not_before: float = 0.0) -> float:
        return self._charge("t_encode", dur, not_before)

    def charge_prefill(self, dur: float, not_before: float = 0.0) -> float:
        return self._charge("t_prefill", dur, not_before)

    def charge_decode(self, dur: float, not_before: float = 0.0) -> float:
        return self._charge("t_decode", dur, not_before)

    @property
    def makespan(self) -> float:
        return max(self.t_encode, self.t_prefill, self.t_decode)

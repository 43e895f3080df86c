"""Modality-aware multi-path scheduling + instance-level load balancing
(paper §3.4), with cache-aware Prefill dispatch.

The Router keeps a global instance status table (queue length, pending
work, busy-until estimates) updated by the simulator / engines, routes
multimodal requests down the E->P->D path and text-only requests down the
P->D path, and dispatches each stage task to the least-loaded instance
serving that stage.

Prefill dispatch is additionally *cache-aware* when Prefill instances
register their prefix caches (``register_prefix_cache``): a cached
prefix is credited against an instance's load at the same per-token
weight as pending prefill work, so a text-only request prefers the
instance holding the longest matching prefix — keeping same-prefix
requests together compounds the hit rate instead of spraying a hot
system prompt across every replica — but a deep backlog still spills
the request to an idle replica rather than pinning one instance.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.core.deployment import Deployment, InstanceSpec
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.request import Request


# load-metric weight of one queued prompt token; cached-prefix tokens
# are credited at the same weight in cache-aware dispatch
PENDING_TOKEN_WEIGHT = 1e-3


# ---------------------------------------------------------------------------
# Page-level preemption: victim selection
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class VictimCandidate:
    """One active decode request considered for page-level preemption.

    slot          — engine slot index (or request id in the simulator);
                    the deterministic tiebreak.
    pages_lost    — device pages released if this request is preempted:
                    the private pages that must be swapped to host and
                    re-faulted later (tree-shared pages cost nothing —
                    they are merely unref'd). This is the preemption
                    COST, not the reclaim estimate.
    priority      — the request's priority (higher survives longer).
    made_progress — has it produced at least one token since its last
                    resume (always True for a never-preempted request)?
    preempt_count — how many times it has been preempted already.
    """

    slot: int
    pages_lost: int
    priority: int = 0
    made_progress: bool = True
    preempt_count: int = 0


def pick_preemption_victim(cands: Sequence[VictimCandidate]
                           ) -> Optional[VictimCandidate]:
    """Choose which active request to preempt when a page allocation
    cannot be satisfied (engine decode growth / admission, simulator
    decode capacity).

    Policy: lowest request priority first, then fewest-pages-lost-first
    (the victim whose eviction costs the least swap traffic and
    re-fault work), slot index as the deterministic tiebreak.

    Starvation guard: a request that was already preempted and has not
    produced a single token since its last resume is exempt — preempting
    it again would undo a resume that never ran (swap ping-pong), and
    under sustained pressure it would never finish. Returns None when no
    candidate is eligible; the caller must then deny the allocation
    (raise/queue) instead of thrashing."""
    eligible = [c for c in cands
                if c.made_progress or c.preempt_count == 0]
    if not eligible:
        return None
    return min(eligible, key=lambda c: (c.priority, c.pages_lost, c.slot))


@dataclass
class InstanceStatus:
    spec: InstanceSpec
    queue_len: int = 0             # tasks waiting (all stages)
    active_decode: int = 0         # requests in the decode batch
    pending_tokens: float = 0.0    # queued prompt tokens (work estimate)
    busy_until: float = 0.0        # latest known completion estimate
    down: bool = False             # instance crashed; never dispatch to it
    # per-request pending ledger: rid -> tokens still outstanding. Guards
    # the aggregate against double-retirement when both on_start and
    # chunk-granular on_prefill_progress report the same work.
    pending_by_req: Dict[str, float] = field(default_factory=dict)

    def load(self, now: float) -> float:
        """Scalar load metric for least-loaded-first dispatch."""
        backlog = max(0.0, self.busy_until - now)
        return (backlog + PENDING_TOKEN_WEIGHT * self.pending_tokens
                + 0.01 * self.queue_len + 0.002 * self.active_decode)


class Router:
    def __init__(self, deployment: Deployment):
        self.deployment = deployment
        self.status: Dict[str, InstanceStatus] = {
            i.name: InstanceStatus(i) for i in deployment.instances}
        self.prefix_caches: Dict[str, PrefixCache] = {}
        # cache-aware Prefill dispatch; False = pure least-loaded (the
        # ablation baseline — prefix caches still populate and count hits)
        self.cache_aware = True

    # -- multi-path routing ----------------------------------------------------
    def path(self, req: Request) -> List[str]:
        """Stage path for a request: E->P->D for multimodal, P->D for text."""
        return ["E", "P", "D"] if req.is_multimodal else ["P", "D"]

    def register_prefix_cache(self, name: str, cache: PrefixCache) -> None:
        """Make instance ``name``'s prefix cache visible to dispatch —
        enables cache-aware Prefill routing for text-only requests."""
        if name not in self.status:
            raise KeyError(f"unknown instance {name}")
        self.prefix_caches[name] = cache

    def cached_prefix_tokens(self, name: str, req: Request) -> int:
        """Tokens of ``req``'s prompt cached on instance ``name`` (full
        pages only — what a prefill there could actually skip)."""
        cache = self.prefix_caches.get(name)
        if cache is None or req.is_multimodal:
            return 0
        n = cache.match_len(req.prompt_tokens, cap=len(req.prompt_tokens) - 1)
        return (n // cache.page) * cache.page

    def pick(self, stage: str, now: float, prefer: Optional[str] = None,
             req: Optional[Request] = None) -> InstanceStatus:
        """Dispatch an instance serving ``stage``. ``prefer`` pins affinity
        (e.g. keep P and D on the same instance when it serves both).
        For Prefill with registered prefix caches and a text-only ``req``,
        cached-prefix tokens are credited against load at the pending-
        token weight: the longest match wins among comparably loaded
        instances, but never outweighs a deep backlog."""
        cands = [self.status[i.name]
                 for i in self.deployment.stage_instances(stage)
                 if not self.status[i.name].down]
        if not cands:
            raise ValueError(
                f"deployment {self.deployment.name} has no live "
                f"{stage} instance")
        if prefer is not None:
            for c in cands:
                if c.spec.name == prefer:
                    return c
        if (stage == "P" and req is not None and self.prefix_caches
                and self.cache_aware):
            return min(cands, key=lambda c: c.load(now) -
                       PENDING_TOKEN_WEIGHT *
                       self.cached_prefix_tokens(c.spec.name, req))
        return min(cands, key=lambda c: c.load(now))

    # -- status updates (called by the execution layer) --------------------------
    def _retire(self, st: InstanceStatus, tokens: float,
                rid: Optional[str]) -> None:
        """Retire pending tokens, capped by the request's own ledger
        when a ``rid`` is known: retiring more than ``rid`` ever
        enqueued (e.g. on_start(tokens=N) followed by per-chunk
        on_prefill_progress for the same N) cannot drag the aggregate
        below the other requests' outstanding work."""
        if tokens <= 0.0:
            return
        if rid is not None:
            owed = st.pending_by_req.get(rid, 0.0)
            tokens = min(tokens, owed)
            if tokens <= 0.0:
                return
            owed -= tokens
            if owed <= 1e-9:
                st.pending_by_req.pop(rid, None)
            else:
                st.pending_by_req[rid] = owed
        st.pending_tokens = max(0.0, st.pending_tokens - tokens)

    def on_enqueue(self, name: str, tokens: float = 0.0,
                   rid: Optional[str] = None) -> None:
        st = self.status[name]
        st.queue_len += 1
        st.pending_tokens += tokens
        if rid is not None and tokens > 0.0:
            st.pending_by_req[rid] = st.pending_by_req.get(rid, 0.0) + tokens

    def on_start(self, name: str, tokens: float = 0.0,
                 rid: Optional[str] = None) -> None:
        st = self.status[name]
        st.queue_len = max(0, st.queue_len - 1)
        self._retire(st, tokens, rid)

    def on_prefill_progress(self, name: str, tokens: float,
                            rid: Optional[str] = None) -> None:
        """Chunk-granular prefill occupancy: a chunked prefill retires
        its pending tokens one chunk at a time (instead of all at
        start), so the load metric tracks the work actually remaining
        on the instance mid-prefill."""
        self._retire(self.status[name], tokens, rid)

    def on_busy_until(self, name: str, t: float) -> None:
        st = self.status[name]
        st.busy_until = max(st.busy_until, t)

    def on_idle(self, name: str, now: float) -> None:
        """An instance drained its queue at ``now``: collapse any stale
        ``busy_until`` estimate so the load metric returns to ~0 instead
        of biasing pick() away from an idle replica forever (busy_until
        is otherwise only ever max'd upward)."""
        st = self.status[name]
        st.busy_until = min(st.busy_until, now)

    def on_decode_join(self, name: str) -> None:
        self.status[name].active_decode += 1

    def on_decode_leave(self, name: str) -> None:
        st = self.status[name]
        st.active_decode = max(0, st.active_decode - 1)

    def on_instance_down(self, name: str) -> None:
        """The fault plane killed instance ``name``: zero its occupancy
        (its queue, batch, and backlog died with it — the harvested
        requests re-enqueue elsewhere and must not double-count here)
        and mark it down so dispatch never picks it again."""
        st = self.status[name]
        st.down = True
        st.queue_len = 0
        st.active_decode = 0
        st.pending_tokens = 0.0
        st.busy_until = 0.0
        st.pending_by_req.clear()

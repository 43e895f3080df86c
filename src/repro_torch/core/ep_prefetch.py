"""E->P asynchronous feature prefetching (paper §3.2).

Mechanism: when Encode finishes, only the *feature hash* is pushed to the
target Prefill instance (cheap, ~O(100 B)). The Prefill listener then
pulls the feature from the MM Store in the background while the request
sits in Prefill's queue / while earlier requests compute — so transfer
latency is hidden under scheduling latency. On a store miss (fault), the
Prefill instance recomputes the feature locally (fault tolerance).

``overlap_ratio`` reproduces the paper's Table 3 metric:
    hidden = min(transfer_latency, scheduling_latency)
    ratio  = hidden / transfer_latency
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

from repro_torch.core.costmodel import CostModel
from repro_torch.core.events import EventLoop
from repro_torch.core.mm_store import MMStore


@dataclass
class PrefetchRecord:
    request_id: int
    transfer_latency: float
    scheduling_latency: float
    recomputed: bool = False
    evicted_in_flight: bool = False

    @property
    def hidden(self) -> float:
        return min(self.transfer_latency, self.scheduling_latency)

    @property
    def exposed(self) -> float:
        return max(0.0, self.transfer_latency - self.scheduling_latency)

    @property
    def overlap_ratio(self) -> float:
        if self.transfer_latency <= 0:
            return 1.0
        return self.hidden / self.transfer_latency


class EPPrefetcher:
    """Event-driven E->P feature mover; one per Prefill instance."""

    def __init__(self, loop: EventLoop, store: MMStore, cost: CostModel,
                 *, async_mode: bool = True, pin: bool = True):
        self.loop = loop
        self.store = store
        self.cost = cost
        self.async_mode = async_mode
        # pin=True holds a refcount on the feature between announce and
        # fire so an interleaved eviction cannot vanish it mid-prefetch;
        # pin=False falls back to the fire-time re-check + recompute arm.
        self.pin = pin
        self.records: List[PrefetchRecord] = []
        self.inflight_evictions = 0

    def notify(self, request_id: int, key: str, n_tokens: int,
               on_ready: Callable[[bool], None],
               scheduling_latency_hint: float = 0.0) -> float:
        """Encode-side: announce feature availability by hash.

        on_ready(recomputed) fires when the Prefill instance can start
        consuming the feature. Returns the time the ENCODE instance stays
        blocked: in the synchronous baseline the feature is pushed E->P on
        E's stream (stretching E's effective service time and compounding
        queueing); in async mode only the hash is sent and E is free
        immediately while P's listener pulls from the MM Store in the
        background.
        """
        nbytes = self.cost.feature_bytes(n_tokens)
        transfer = self.cost.feature_transfer_time(nbytes)
        # dispatch (scheduler tick + batch formation + local cache write)
        # happens regardless of mode; the async transfer hides behind it
        # and behind any Prefill queue backlog.
        sched = max(self.cost.dispatch_latency(nbytes),
                    scheduling_latency_hint)
        found = self.store.get(key, record=False) is not None
        pinned = bool(self.pin and found and self.store.pin(key))
        recompute = 0.0
        if not found:
            # fault-tolerant recomputation on the Prefill instance
            recompute = self.cost.encode_time(n_tokens)
            transfer = 0.0
        rec = PrefetchRecord(request_id, transfer, sched,
                             recomputed=not found)
        self.records.append(rec)
        if self.async_mode:
            # transfer overlaps the dispatch path: only the EXPOSED part
            # delays Prefill, and E is not blocked at all
            delay = max(sched, transfer) + recompute
            e_block = 0.0
        else:
            # synchronous baseline: the feature push is serial with
            # dispatch AND sits on the Encode instance's stream
            delay = sched + transfer + recompute
            e_block = transfer

        def _fire() -> None:
            # Presence was checked at ANNOUNCE time but on_ready fires
            # `delay` later — an eviction in that window would hand
            # Prefill a vanished entry. Release any pin, then re-check:
            # a gap here routes through the same recompute arm a store
            # miss does (charged as extra delay before on_ready).
            if pinned:
                self.store.unpin(key)
            if found and not self.store.contains(key):
                rec.evicted_in_flight = True
                rec.recomputed = True
                self.inflight_evictions += 1
                self.loop.after(self.cost.encode_time(n_tokens),
                                lambda: on_ready(True))
                return
            on_ready(rec.recomputed)

        self.loop.after(delay, _fire)
        return e_block

    # -- metrics ---------------------------------------------------------------
    @property
    def mean_overlap_ratio(self) -> float:
        xfers = [r for r in self.records if not r.recomputed]
        if not xfers:
            return 1.0
        return sum(r.overlap_ratio for r in xfers) / len(xfers)

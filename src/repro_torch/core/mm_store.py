"""MM Store — the shared multimodal feature cache pool (paper §3.2).

Content-hash keyed: key = hash(multimodal input), value = encoded feature
tensor (or, in simulation, its metadata). Supports cross-request reuse
(dedup), LRU eviction under a byte budget, and fault injection so the
fault-tolerant recomputation path is testable.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from repro_torch.core.faults import SITE_STORE_FETCH, FaultInjector, StoreMiss


@dataclass
class StoreStats:
    puts: int = 0
    hits: int = 0
    misses: int = 0
    dedup_puts: int = 0          # put of an already-present key
    evictions: int = 0
    rejected_puts: int = 0       # entry alone exceeds capacity
    faults_injected: int = 0
    bytes_stored: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class MMStore:
    """Hash-keyed feature pool with LRU eviction."""

    def __init__(self, capacity_bytes: Optional[int] = None,
                 injector: Optional[FaultInjector] = None):
        self.capacity = capacity_bytes
        self._data: "collections.OrderedDict[str, Tuple[Any, int]]" = \
            collections.OrderedDict()
        self.stats = StoreStats()
        # pinned entries (refcounted) are exempt from eviction: the E->P
        # prefetcher pins a feature between announce and fire so the
        # Prefill consumer never races an interleaved eviction.
        self._pins: Dict[str, int] = {}
        # All fault decisions route through the (possibly shared) fault
        # plane; a private injector with an empty plan means "no faults"
        # until someone arms one via inject_fault.
        self.injector = injector if injector is not None else FaultInjector()

    # -- core API -------------------------------------------------------------
    def put(self, key: str, value: Any, nbytes: int) -> None:
        if key in self._data:
            # dedup put of a known key: the key is content-addressed so
            # the VALUE is semantically identical, but a recompute may
            # re-put under the same hash with a different representation
            # (or corrected size) — adopt the new tuple and reconcile
            # byte accounting instead of silently keeping the stale one.
            self.stats.dedup_puts += 1
            old_nb = self._data[key][1]
            self._data[key] = (value, nbytes)
            self.stats.bytes_stored += nbytes - old_nb
            self._data.move_to_end(key)
            self._evict()
            return
        if self.capacity is not None and nbytes > self.capacity:
            # an entry that alone exceeds capacity can never fit the
            # budget: admitting it would pin ``bytes_stored`` above
            # ``capacity`` forever (the old `len > 1` eviction guard did
            # exactly that). Reject the put outright — the caller holds
            # the value it just computed, so nothing is lost.
            self.stats.rejected_puts += 1
            return
        self.stats.puts += 1
        self._data[key] = (value, nbytes)
        self.stats.bytes_stored += nbytes
        self._evict()

    def get(self, key: str, record: bool = True,
            attempt: int = 0) -> Optional[Any]:
        """record=False: internal fetch (e.g. the P-side prefetcher pulling
        a feature the E stage just produced) — served but not counted in
        the hit/miss statistics, which track cross-request dedup.
        ``attempt`` keys the injector's deterministic draw: a *retry* of
        the same fetch re-draws, so transient faults heal under the
        store-fetch retry arm."""
        if self.injector.should_fail(SITE_STORE_FETCH, key=key,
                                     attempt=attempt):
            # injected fault: behaves like a lost entry (paper §3.2 FT path)
            self.stats.faults_injected += 1
            if record:
                self.stats.misses += 1
            return None
        if key in self._data:
            if record:
                self.stats.hits += 1
            self._data.move_to_end(key)
            return self._data[key][0]
        if record:
            self.stats.misses += 1
        return None

    def contains(self, key: str) -> bool:
        return key in self._data

    def nbytes(self, key: str) -> int:
        return self._data[key][1] if key in self._data else 0

    def resident_bytes(self) -> int:
        """Ground-truth sum of resident entry sizes (audits: must always
        equal ``stats.bytes_stored``)."""
        return sum(nb for _, nb in self._data.values())

    # -- pinning --------------------------------------------------------------
    def _pinned(self, key: str) -> bool:
        return self._pins.get(key, 0) > 0

    def pin(self, key: str) -> bool:
        """Refcounted eviction exemption for an in-flight consumer (the
        E->P prefetcher between announce and fire). Returns False when
        the key is not resident (nothing to pin)."""
        if key not in self._data:
            return False
        self._pins[key] = self._pins.get(key, 0) + 1
        return True

    def unpin(self, key: str) -> None:
        n = self._pins.get(key, 0)
        if n <= 1:
            self._pins.pop(key, None)
        else:
            self._pins[key] = n - 1
        # release may leave the store above budget (pins can hold it
        # there); reconverge now that the entry is evictable again
        self._evict()

    def _evict(self) -> None:
        if self.capacity is None:
            return
        while self.stats.bytes_stored > self.capacity:
            # LRU order, skipping pinned entries. A single oversized
            # entry is evicted too (the old `len > 1` guard kept it
            # forever with bytes_stored > capacity never reconverging).
            victim = next((k for k in self._data if not self._pinned(k)),
                          None)
            if victim is None:
                return                     # everything pinned: hold over
            _, nb = self._data.pop(victim)
            self.stats.bytes_stored -= nb
            self.stats.evictions += 1

    def fetch(self, key: str, attempt: int = 0) -> Any:
        """Typed fetch: like ``get`` but a lost/faulted/absent entry
        raises :class:`StoreMiss` (carrying the key and attempt number)
        instead of returning None — what the retry-then-recompute arm
        catches."""
        val = self.get(key, attempt=attempt)
        if val is None:
            raise StoreMiss(key, attempts=attempt + 1)
        return val

    # -- fault injection --------------------------------------------------------
    def inject_fault(self, key: str) -> None:
        """Legacy one-shot hook, kept as a shim: arms exactly one
        store-fetch fault for ``key`` on the shared injector."""
        self.injector.arm(SITE_STORE_FETCH, key=key)

    def __len__(self) -> int:
        return len(self._data)

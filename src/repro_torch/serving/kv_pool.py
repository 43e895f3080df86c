"""Paged KV-cache page pool (vLLM-style block allocator, ref-counted).

The device-side KV pool is a flat array of fixed-size pages shared by
every decode slot: ``(n_repeats, n_pages, page_size, n_kv, head_dim)``
per attention pattern position (see ``layers.PagedAttnCache``). This
module is the HOST-side bookkeeping around it:

* :class:`PagePool` — a ref-counted free-list allocator over physical
  page ids. ``alloc`` hands out pages at refcount 1; ``ref`` adds a
  holder (prefix sharing: the radix tree and every request retaining a
  shared prompt page each hold one ref); ``free``/``unref`` drops one
  and returns the page to the free list only when the last holder lets
  go. Physical page 0 is reserved as the *trash page*: unmapped
  block-table entries point at it, so decode writes from inactive slots
  and prefill writes past a request's last page land somewhere harmless
  instead of corrupting live pages.
* :class:`PagedKVPayload` — the P->D handoff unit. Instead of a full
  cache pytree it names the request's physical pages in the *source*
  engine's pool plus the small per-slot side state (SSM state, cross-KV,
  length). Inserting into the same engine is a pure block-table update
  (zero KV bytes moved); inserting into another engine gathers/scatters
  only those pages — O(one request's pages), never O(pool). Payload
  pages may be shared (prefix-cache hits): the payload holds ONE ref per
  page, released on insert-into-another-engine or ``release_payload``.

* :class:`SwapHandle` — the preemption unit. ``swap_out`` moves a set of
  pages' *contents* to a host-side (``np``) backing store and returns the
  pages to the free list; the handle is the ticket that gets them back.

  Swap-handle lifecycle: a handle is born in ``swap_out`` (the caller —
  the engine preempting a decode slot — gathers the pages' KV off the
  device and hands it over together with its page refs). From then on
  exactly one of two things consumes it: ``swap_in`` (re-fault: allocates
  the same number of fresh device pages, pops the host copy and returns
  both so the caller can scatter the KV back — on ``PoolExhausted`` the
  handle stays valid and retryable) or ``swap_free`` (the preempted
  request was abandoned; the host copy is dropped). A handle that is
  never consumed is a leak: ``assert_balanced(swap_handles=...)`` checks
  the outstanding handle set against the preempted requests the caller
  knows about, exactly like device pages are checked against holders.

Leak auditing: ``assert_balanced`` cross-checks the allocator against
the holders the caller believes exist (slots, radix-tree retentions,
swap handles of preempted requests) — engine/cluster tests call it
after draining.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.faults import SITE_SWAP_IN, FaultInjector, SwapLost
from repro_torch.core.telemetry import MetricsRegistry

TRASH_PAGE = 0


class PoolExhausted(RuntimeError):
    """Typed pool-exhaustion error: ``requested`` pages were asked for
    with only ``n_free`` free. Subclasses RuntimeError so pre-existing
    callers keep working; new callers (the preemption trigger, tests)
    can catch/assert on the type instead of string-matching. Note that
    ``n_free`` counts pages on the free list — a pool can be "full"
    while most pages are merely retained by the prefix tree or shared
    by other requests (fragmented-by-refs), which is exactly the state
    preemption and tree eviction reclaim from."""

    def __init__(self, requested: int, n_free: int, n_usable: int):
        self.requested = int(requested)
        self.n_free = int(n_free)
        self.n_usable = int(n_usable)
        super().__init__(
            f"KV page pool exhausted: requested {requested} pages, "
            f"{n_free}/{n_usable} free")


@dataclass(frozen=True)
class SwapHandle:
    """Ticket for pages swapped out to the pool's host backing store.

    ``handle_id`` indexes the pool's store; ``n_pages`` is what
    ``swap_in`` will re-allocate. The handle carries no KV itself — the
    host copy lives in the pool — so it is safe to stash on a preempted
    request and to audit by identity."""

    handle_id: int
    n_pages: int


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` (at least one)."""
    return max(1, -(-int(n_tokens) // page_size))


class PagePool:
    """Ref-counted allocator over the physical pages of one engine's pool.

    Page ids are ints in [1, n_pages); page 0 is the reserved trash page
    and is never handed out. A page is *used* while any holder refs it;
    ``_refs`` doubles as the O(1) membership check that used to scan the
    free list (the old O(n^2) double-free check).
    """

    def __init__(self, n_pages: int, page_size: int,
                 injector: Optional[FaultInjector] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 name: str = "pool"):
        if n_pages < 2:
            raise ValueError("need n_pages >= 2 (page 0 is reserved)")
        if page_size < 1:
            raise ValueError("page_size must be positive")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        # occupancy gauges + high-water mark live in the (possibly
        # shared) metrics registry, labeled by the owning engine's name;
        # `peak_used` stays readable under its historical attribute name
        # via the property below.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._m_used = self.metrics.gauge("pool_used_pages", pool=name)
        self._m_occ = self.metrics.gauge("pool_occupancy", pool=name)
        self._m_peak = self.metrics.gauge("pool_peak_used_pages", pool=name)
        # fault plane for the host swap tier (SITE_SWAP_IN); a private
        # empty-plan injector means swap_in never faults.
        self.injector = injector if injector is not None else FaultInjector()
        self.swap_lost_total = 0
        # LIFO free list: recently freed pages are re-used first (their
        # contents are most likely still resident in cache hierarchies).
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._refs: Dict[int, int] = {}
        # host-side swap space: handle_id -> (n_pages, host KV pytree).
        # Contents parked here have no device pages; SwapHandle is the
        # only way back in (see the module docstring for the lifecycle).
        self._swap: Dict[int, Tuple[int, Any]] = {}
        self._handle_seq = itertools.count(1)
        self.swapped_out_pages_total = 0
        self.swapped_in_pages_total = 0

    @property
    def peak_used(self) -> int:
        """High-water mark of used pages (benchmarks: chunked-prefill
        memory accounting). Backed by the registry gauge."""
        return int(self._m_peak.value)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    def _track_occupancy(self) -> None:
        used = self.n_used
        self._m_used.set(used)
        self._m_occ.set(used / max(1, self.n_pages - 1))
        self._m_peak.max(used)

    def pages_for(self, n_tokens: int) -> int:
        return pages_for(n_tokens, self.page_size)

    def refcount(self, page: int) -> int:
        return self._refs.get(int(page), 0)

    def alloc(self, n: int) -> np.ndarray:
        """Pop ``n`` physical page ids at refcount 1; raises
        :class:`PoolExhausted` (a RuntimeError) when the free list is
        shorter than ``n``."""
        if n <= 0:
            return np.zeros((0,), np.int32)
        if n > len(self._free):
            raise PoolExhausted(n, len(self._free), self.n_pages - 1)
        out = self._free[-n:][::-1]
        del self._free[-n:]
        for p in out:
            self._refs[p] = 1
        self._track_occupancy()
        return np.asarray(out, np.int32)

    def ref(self, pages: Sequence[int]) -> None:
        """Add one holder to each (already-allocated) page."""
        for p in pages:
            p = int(p)
            if p not in self._refs:
                raise ValueError(f"ref of unallocated page {p}")
            self._refs[p] += 1

    def free(self, pages: Sequence[int]) -> None:
        """Drop one holder per page; a page returns to the free list when
        its last holder releases it (``unref`` is an alias)."""
        for p in pages:
            p = int(p)
            if p == TRASH_PAGE:
                raise ValueError("cannot free the reserved trash page")
            if not (0 < p < self.n_pages):
                raise ValueError(f"page id {p} out of range")
            if p not in self._refs:
                raise ValueError(f"double free of page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)
        self._track_occupancy()

    unref = free

    # -- host swap space (page-level preemption) ------------------------------

    @property
    def n_swapped_pages(self) -> int:
        """Pages whose contents currently live in the host backing store."""
        return sum(n for n, _ in self._swap.values())

    def swap_out(self, pages: Sequence[int], data: Any = None) -> SwapHandle:
        """Park ``pages``' contents in the host backing store.

        ``data`` is the gathered page KV (any host pytree — the caller
        owns the device->host copy; bookkeeping-only users may pass
        None). Drops ONE ref per page — the caller's holdership moves
        from the device pages to the returned handle — so a page shared
        with other holders (prefix tree, other slots) survives on
        device while this caller's private pages return to the free
        list. See the module docstring for the handle lifecycle."""
        pages = [int(p) for p in pages]
        if not pages:
            raise ValueError("swap_out of an empty page set")
        h = SwapHandle(next(self._handle_seq), len(pages))
        self.free(pages)               # validates refs; raises before store
        self._swap[h.handle_id] = (len(pages), data)
        self.swapped_out_pages_total += len(pages)
        return h

    def swap_in(self, handle: SwapHandle) -> Tuple[np.ndarray, Any]:
        """Re-fault a swapped set: allocate ``handle.n_pages`` fresh
        device pages (refcount 1) and pop the host copy. Returns
        ``(new_page_ids, data)`` for the caller to scatter back. On
        :class:`PoolExhausted` the handle remains valid and retryable;
        on success it is consumed and must not be reused."""
        if handle.handle_id not in self._swap:
            raise ValueError(f"unknown or already-consumed swap "
                             f"handle {handle.handle_id}")
        if self.injector.should_fail(SITE_SWAP_IN, key=handle.handle_id):
            # host swap tier lost the contents: the entry is gone for
            # good (the handle is consumed — there is nothing to retry
            # against), so the caller must take the suffix-recompute
            # arm. Raised BEFORE alloc: no device pages were taken.
            del self._swap[handle.handle_id]
            self.swap_lost_total += 1
            raise SwapLost(handle.handle_id, handle.n_pages)
        ids = self.alloc(handle.n_pages)       # may raise: handle intact
        _, data = self._swap.pop(handle.handle_id)
        self.swapped_in_pages_total += handle.n_pages
        return ids, data

    def swap_free(self, handle: SwapHandle) -> None:
        """Drop a swapped set without re-faulting it (the preempted
        request was abandoned). Idempotence is NOT provided — freeing a
        consumed handle raises, matching the double-free check."""
        if handle.handle_id not in self._swap:
            raise ValueError(f"double free of swap handle "
                             f"{handle.handle_id}")
        del self._swap[handle.handle_id]

    def assert_balanced(self, holders: Iterable[Sequence[int]] = (),
                        swap_handles: Iterable[SwapHandle] = ()) -> None:
        """Leak assertion: the allocator's view must match the holders the
        caller knows about (each element of ``holders`` is one holder's
        page-id list — a slot's block-table row, a payload, the radix
        tree's retained pages), and the host swap store must match the
        ``swap_handles`` the caller knows about (the preempted requests'
        tickets). Raises AssertionError on any leaked page, ref-count
        mismatch, free-list corruption, or leaked/dangling swap entry."""
        expect: Dict[int, int] = {}
        for h in holders:
            for p in h:
                p = int(p)
                if p != TRASH_PAGE:
                    expect[p] = expect.get(p, 0) + 1
        assert len(self._free) + len(self._refs) == self.n_pages - 1, (
            f"pool accounting broken: {len(self._free)} free + "
            f"{len(self._refs)} used != {self.n_pages - 1}")
        assert len(set(self._free)) == len(self._free), \
            "free list contains duplicates"
        assert not (set(self._free) & set(self._refs)), \
            "page both free and referenced"
        leaked = {p: r for p, r in self._refs.items() if p not in expect}
        assert not leaked, f"leaked pages (refs with no holder): {leaked}"
        for p, want in expect.items():
            got = self._refs.get(p, 0)
            assert got == want, (
                f"page {p}: {got} refs but {want} holders")
        expect_swap = {}
        for h in swap_handles:
            assert h.handle_id not in expect_swap, \
                f"swap handle {h.handle_id} claimed twice"
            expect_swap[h.handle_id] = h.n_pages
        got_swap = {hid: n for hid, (n, _) in self._swap.items()}
        leaked_swap = {h: n for h, n in got_swap.items()
                       if h not in expect_swap}
        assert not leaked_swap, (
            f"leaked swap entries (no preempted holder): {leaked_swap}")
        for hid, want in expect_swap.items():
            assert hid in got_swap, (
                f"dangling swap handle {hid}: holder exists but the "
                f"host store has no entry (consumed or never created)")
            assert got_swap[hid] == want, (
                f"swap handle {hid}: store holds {got_swap[hid]} pages "
                f"but the handle claims {want}")


@dataclass
class PagedKVPayload:
    """One prefilled request's KV, by reference into the source pool.

    source        — the Engine whose pool holds the pages.
    page_ids      — (n_pages,) physical ids in the source pool, in sequence
                    order (page j holds tokens [j*page, (j+1)*page)). Pages
                    shared via the prefix cache appear here too; the payload
                    owns one ref on every listed page.
    n_tokens      — true KV length (prompt + multimodal tokens).
    side          — batch-1 slot state pytree: {"ssm", "cross", "len"}.
    kv_nbytes     — attention-KV bytes these pages occupy across all layers
                    (what a cross-engine insert actually moves).
    cached_tokens — prompt tokens served from the prefix cache (prefill
                    computed only the remaining suffix).
    chunks        — streaming segments of a CHUNKED prefill, in order:
                    (computed_tokens, n_pages) per segment. A leading
                    (0, n) entry is the cached-prefix segment (ready
                    before any compute). Empty for monolithic prefill.
                    Sum of n_pages == len(page_ids); the transfer
                    planner uses it to ship segment k while segment k+1
                    computes (kv_transfer.plan_chunked).
    """

    source: Any
    page_ids: np.ndarray
    n_tokens: int
    side: Dict[str, Any] = field(default_factory=dict)
    kv_nbytes: int = 0
    cached_tokens: int = 0
    chunks: List[tuple] = field(default_factory=list)

    @property
    def n_pages(self) -> int:
        return len(self.page_ids)

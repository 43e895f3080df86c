"""Radix-tree prefix cache over the paged KV pool (SGLang-style).

Shared prompt prefixes (system prompts, few-shot templates, multi-turn
history) dominate prefill cost in high-concurrency chat workloads. With
the paged KV layout, a shared prefix is nothing but a ref-count on the
physical pages that already hold its KV — this module is the host-side
index that finds them:

* :class:`RadixNode` — one edge of the tree: a page-aligned token run
  (length a multiple of ``page_size``) mapping to the physical pages
  holding that run's KV. Children are keyed by their first page's token
  tuple, so the radix property (at most one child continues a match)
  holds at page granularity and node splits always land on page
  boundaries.
* :class:`PrefixCache` — match / insert / evict over the tree:

  - ``match_and_ref`` returns the longest cached prefix of a prompt:
    whole shared pages are ref-counted for the caller (the request holds
    them for its lifetime), and when the match ends *inside* a page the
    partially-matched page is returned as a copy-on-write source — the
    engine device-copies it into a private page and recomputes only from
    the divergence point, never writing a shared page.
  - ``insert`` retains a finished prefill's full pages in the tree (one
    ref per retained page), splitting existing edges at page boundaries.
  - ``evict`` walks LRU leaves under pool pressure and drops retentions
    whose pages the tree is the last holder of; pages still held by live
    requests are never freed (their nodes are skipped — evicting them
    reclaims nothing).

The tree also runs pool-less (``pool=None``): pure token-prefix
matching with no page bookkeeping, which is what the simulator and the
cache-aware router use to model per-instance prefix locality.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.kv_pool import PagePool


class RadixNode:
    __slots__ = ("tokens", "pages", "children", "parent", "last_access")

    def __init__(self, tokens: Tuple[int, ...],
                 pages: Optional[np.ndarray],
                 parent: Optional["RadixNode"]):
        self.tokens = tokens                  # page-aligned run
        self.pages = pages                    # (len(tokens)//page,) or None
        self.children: Dict[Tuple[int, ...], RadixNode] = {}
        self.parent = parent
        self.last_access = 0

    def __repr__(self) -> str:  # debugging aid
        return (f"RadixNode(run={len(self.tokens)}tok, "
                f"pages={None if self.pages is None else list(self.pages)}, "
                f"kids={len(self.children)})")


@dataclass
class MatchResult:
    """Longest cached prefix of one prompt.

    n_tokens — matched tokens (full pages + any intra-page partial run).
    page_ids — physical ids of the fully-matched pages, ref'd for the
               caller (one ref each; release with pool.unref or hand to
               the slot/payload).
    cow_src  — physical id of the partially-matched page when the match
               ends inside a page (ref'd for the caller, who must copy it
               and then unref), else None.
    """

    n_tokens: int = 0
    page_ids: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), np.int32))
    cow_src: Optional[int] = None

    @property
    def n_full_pages(self) -> int:
        return len(self.page_ids)


@dataclass
class CacheStats:
    lookups: int = 0
    hits: int = 0                  # lookups matching at least one token
    hit_tokens: int = 0
    lookup_tokens: int = 0
    inserted_pages: int = 0
    evicted_pages: int = 0

    @property
    def hit_rate(self) -> float:
        """Token-weighted hit rate: cached tokens / prompt tokens seen."""
        return self.hit_tokens / self.lookup_tokens if self.lookup_tokens \
            else 0.0


class PrefixCache:
    def __init__(self, page_size: int, pool: Optional[PagePool] = None,
                 max_tokens: Optional[int] = None):
        """``pool`` binds retentions to real pages (engine mode; capacity
        is then the pool itself). Pool-less mode (simulator / router
        probes) has no physical backing, so ``max_tokens`` caps the tree
        by LRU leaf eviction instead — without it a long-lived sim grows
        one node per unique prompt tail, unbounded."""
        if pool is not None and pool.page_size != page_size:
            raise ValueError(
                f"page_size {page_size} != pool page {pool.page_size}")
        self.page = int(page_size)
        self.pool = pool
        self.max_tokens = max_tokens
        self.root = RadixNode((), None, None)
        self.stats = CacheStats()
        self._clock = itertools.count(1)
        self._tokens = 0                       # cached tokens, kept in sync

    # -- internal walk -------------------------------------------------------

    def _touch(self, node: RadixNode) -> None:
        t = next(self._clock)
        while node is not None:
            node.last_access = t
            node = node.parent

    def _match_pages(self, tokens: Sequence[int], pos: int, cap: int,
                     run: Tuple[int, ...]) -> int:
        """Pages of ``run`` matched by tokens[pos:cap], given the first
        page already matched (the shared per-node match loop of the walk
        and of insert)."""
        page = self.page
        n = len(run) // page
        j = 1
        while (j < n and pos + (j + 1) * page <= cap and
               tuple(tokens[pos + j * page:pos + (j + 1) * page])
               == run[j * page:(j + 1) * page]):
            j += 1
        return j

    def _walk_full(self, tokens: Sequence[int], cap: int
                   ) -> Tuple[RadixNode, int, int, List[int]]:
        """Follow full-page matches. Returns (node, pages_into_node,
        matched_tokens, matched_page_ids). ``pages_into_node`` > 0 means
        the walk ended mid-node (matched that many of node's pages)."""
        page = self.page
        node = self.root
        pos = 0
        pages: List[int] = []
        while pos + page <= cap:
            child = node.children.get(tuple(tokens[pos:pos + page]))
            if child is None:
                return node, 0, pos, pages
            j = self._match_pages(tokens, pos, cap, child.tokens)
            if child.pages is not None:
                pages.extend(int(p) for p in child.pages[:j])
            pos += j * page
            if j < len(child.tokens) // page:
                return child, j, pos, pages
            node = child
        return node, 0, pos, pages

    def _partial_tail(self, tokens: Sequence[int], cap: int,
                      node: RadixNode, pages_into: int, pos: int
                      ) -> Tuple[int, Optional[int], Optional[RadixNode]]:
        """Longest intra-page match past ``pos`` (< one page of tokens).
        Returns (extra_tokens, cow_page_id_or_None, source_node_or_None —
        the child supplying the partial page when the walk stopped at a
        node boundary, so callers can refresh its LRU stamp)."""
        page = self.page
        limit = min(cap - pos, page)
        if limit <= 0:
            return 0, None, None
        best, best_page, best_node = 0, None, None

        def common(run: Tuple[int, ...], page_id, src) -> None:
            nonlocal best, best_page, best_node
            n = 0
            while n < min(limit, len(run)) and tokens[pos + n] == run[n]:
                n += 1
            if n > best:
                best = n
                best_page = None if page_id is None else int(page_id)
                best_node = src
        if pages_into:                     # diverged mid-node: next page of run
            run = node.tokens[pages_into * page:(pages_into + 1) * page]
            common(run, None if node.pages is None
                   else node.pages[pages_into], None)
        else:                              # node boundary: any child's 1st page
            for key, child in node.children.items():
                common(key, None if child.pages is None else child.pages[0],
                       child)
        return best, best_page, best_node

    # -- public API ----------------------------------------------------------

    def match_len(self, tokens: Sequence[int],
                  cap: Optional[int] = None) -> int:
        """Read-only longest-prefix length in tokens (full pages + partial).
        No refs taken, no stats recorded — the router's probe."""
        cap = len(tokens) if cap is None else min(cap, len(tokens))
        node, into, pos, _ = self._walk_full(tokens, cap)
        extra, _, _ = self._partial_tail(tokens, cap, node, into, pos)
        return pos + extra

    def match_and_ref(self, tokens: Sequence[int],
                      cap: Optional[int] = None) -> MatchResult:
        """Longest cached prefix of ``tokens`` (capped at ``cap`` tokens —
        pass len-1 to force at least one computed token so prefill still
        produces logits). Fully-matched pages and the CoW source page are
        ref'd on behalf of the caller before returning, so no interleaved
        eviction can free them."""
        cap = len(tokens) if cap is None else min(cap, len(tokens))
        node, into, pos, pages = self._walk_full(tokens, cap)
        extra, cow, cow_node = self._partial_tail(tokens, cap, node, into,
                                                  pos)
        self._touch(node)
        if cow_node is not None:           # CoW source child is hot too
            self._touch(cow_node)
        self.stats.lookups += 1
        self.stats.lookup_tokens += len(tokens)
        n = pos + extra
        if n:
            self.stats.hits += 1
            self.stats.hit_tokens += n
        ids = np.asarray(pages, np.int32)
        if self.pool is not None:
            self.pool.ref(ids)
            if cow is not None:
                self.pool.ref([cow])
        return MatchResult(n_tokens=n, page_ids=ids, cow_src=cow)

    def insert(self, tokens: Sequence[int],
               page_ids: Optional[Sequence[int]] = None) -> int:
        """Retain a prefilled prompt's full pages in the tree. ``page_ids``
        must cover ceil(len(tokens)/page) pages (the request's block-table
        row); only the full-page prefix is cached. Newly retained pages
        get one tree ref. Returns the number of pages newly retained."""
        page = self.page
        n_full = len(tokens) // page
        if n_full == 0:
            return 0
        tokens = tuple(int(t) for t in tokens[:n_full * page])
        if self.pool is not None:
            if page_ids is None or len(page_ids) < n_full:
                raise ValueError(
                    f"need >= {n_full} pages for {len(tokens)} tokens")
        node = self.root
        pos = 0
        retained = 0
        while pos < len(tokens):
            key = tuple(tokens[pos:pos + page])
            child = node.children.get(key)
            if child is None:
                run = tokens[pos:]
                pg = None
                if self.pool is not None:
                    pg = np.asarray(
                        [int(p) for p in
                         page_ids[pos // page:n_full]], np.int32)
                    self.pool.ref(pg)
                    retained += len(pg)
                new = RadixNode(run, pg, node)
                node.children[key] = new
                self._tokens += len(run)
                self._touch(new)
                break
            j = self._match_pages(tokens, pos, len(tokens), child.tokens)
            if j < len(child.tokens) // page:
                # split child at the page boundary j
                upper = RadixNode(child.tokens[:j * page],
                                  None if child.pages is None
                                  else child.pages[:j], node)
                child.tokens = child.tokens[j * page:]
                if child.pages is not None:
                    child.pages = child.pages[j:]
                child.parent = upper
                upper.children[tuple(child.tokens[:page])] = child
                upper.last_access = child.last_access
                node.children[key] = upper
                node = upper
            else:
                node = child
            pos += j * page
            if pos >= len(tokens):
                self._touch(node)
        self.stats.inserted_pages += retained
        if self.pool is None and self.max_tokens is not None:
            while self._tokens > self.max_tokens:
                if not self._evict_lru_leaf():
                    break
        return retained

    # -- eviction ------------------------------------------------------------

    def _leaves(self) -> List[RadixNode]:
        out: List[RadixNode] = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            kids = list(n.children.values())
            if not kids and n is not self.root:
                out.append(n)
            stack.extend(kids)
        return out

    def _drop_leaf(self, leaf: RadixNode) -> None:
        del leaf.parent.children[tuple(leaf.tokens[:self.page])]
        leaf.parent = None
        self._tokens -= len(leaf.tokens)

    def _evict_lru_leaf(self) -> int:
        """Pool-less capacity eviction: drop the LRU leaf outright (no
        page bookkeeping to respect). Returns tokens dropped (0 = empty
        tree)."""
        leaves = self._leaves()
        if not leaves:
            return 0
        leaf = min(leaves, key=lambda n: n.last_access)
        n = len(leaf.tokens)
        self._drop_leaf(leaf)
        return n

    def evict(self, n_pages: int) -> int:
        """Drop LRU leaf retentions until >= ``n_pages`` physical pages
        returned to the free list (or nothing evictable remains). Leaves
        whose pages are all still held by live requests are skipped —
        evicting them reclaims no memory. Returns pages actually freed
        (== stats.evicted_pages growth; in-use pages merely lose their
        tree retention and are not counted as reclaimed)."""
        if self.pool is None:
            return 0
        freed = 0
        # One DFS; afterwards only an evicted leaf's parent can become a
        # new leaf, and refcounts only change through our own unrefs (a
        # retained page belongs to exactly one node), so gains computed
        # at pop time stay valid.
        heap = [(leaf.last_access, i, leaf)
                for i, leaf in enumerate(self._leaves())]
        heapq.heapify(heap)
        seq = len(heap)
        while freed < n_pages and heap:
            _, _, leaf = heapq.heappop(heap)
            g = sum(1 for p in leaf.pages if self.pool.refcount(p) == 1)
            if g == 0:
                continue                   # fully in use: reclaims nothing
            self.pool.unref(leaf.pages)
            freed += g
            self.stats.evicted_pages += g
            parent = leaf.parent
            self._drop_leaf(leaf)
            if parent is not self.root and not parent.children:
                heap_entry = (parent.last_access, seq, parent)
                heapq.heappush(heap, heap_entry)
                seq += 1
        return freed

    # -- introspection --------------------------------------------------------

    def retained_pages(self) -> List[int]:
        """All physical pages currently retained by the tree (leak audit)."""
        out: List[int] = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n.pages is not None:
                out.extend(int(p) for p in n.pages)
            stack.extend(n.children.values())
        return out

    @property
    def n_cached_tokens(self) -> int:
        return self._tokens

"""Cross-request KV prefix cache: a radix index over the page pool
with per-page refcounts, copy-on-write, and LRU eviction.

The port's copy of ``paddle_tpu/inference/prefix_cache.py`` (pure
Python; it moves page ids, never tensor data), importing the port's
errors and fault sites.

At serving scale most traffic shares long system prompts and few-shot
prefixes, yet an uncached engine re-prefills every admission from token
zero — and preempt-and-requeue even recomputes prefill work the engine
already did once.  Because the ragged paged-attention kernel treats
block tables and lengths as DATA, mapping a shared prefix onto
already-written pages is purely a block-table indirection: no kernel
change, and the attended values are
bitwise-identical to the ones this request's own prefill would have
written (KV at position ``p`` is a deterministic function of tokens
``[0..p]`` under causal attention and eval-mode determinism).

Design — three layers over one page pool:

* **Radix/trie index, page-granular.**  Each trie edge is the exact
  token content of ONE full page (``page_size`` tokens, keyed by their
  bytes), so a path from the root spells a prefix and each node maps
  it to the immutable KV page holding those positions.  Only FULLY
  written pages are ever published; partial tail pages stay private.
  Matching walks the request's tokens page-by-page and stops at the
  first miss — prefill then starts at the first uncached token.
* **Per-page refcounts layered onto the free list.**  Every page is in
  exactly one of three states: FREE (on the engine's free list),
  IN USE (``ref > 0``: referenced by one or more resident slots — a
  private page has ref 1, a shared prefix page ref = #residents using
  it), or CACHED (``ref == 0`` but owned by a trie node: reclaimable).
  ``acquire``/``retain``/``release`` move pages between states;
  conservation (``in_use + free + cached == total - 1``, page 0 is the
  engine's reserved null page) is checkable at every step via
  :meth:`PrefixCache.check` and drilled by the randomized property
  test of the JAX package.
* **LRU eviction, leaf-first.**  Under pool pressure ``acquire``
  reclaims the least-recently-used ref-0 cached page before the engine
  resorts to preempting a resident.  Only trie LEAVES are evicted (an
  interior page's descendants would become unreachable garbage);
  because a matched path is retained root-to-tip, a ref-0 node's whole
  subtree is ref-0, so every cached page is eventually reclaimable by
  repeated leaf eviction and ``available()`` may count all of them.

Copy-on-write sits at the divergence page: when a request's ENTIRE
(page-aligned) token sequence is cached there is nothing left to
prefill, yet the engine still needs the last position's logits — so the
last matched page is not shared but COPIED (device-side, one dispatch,
see ``ContinuousBatchingEngine._cow_page``) and the one recomputed
token's KV write lands on the private copy, never on the shared page.
Every other case starts prefill at a page boundary past the matched
prefix, so shared pages are never write targets (the engine's write
path routes by ``block_table[slot, pos // page_size]``).

``enabled=False`` (the ``serving_prefix_cache`` flag's ``off`` value)
keeps the refcount bookkeeping — one code path, same invariants — but
never indexes or matches, which restores the uncached engine bitwise.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from ..core.errors import CacheIntegrityError
from ..resilience import faults
from ..resilience.serving import SITE_CACHE_EVICT

__all__ = ["PrefixCache"]


class _Node:
    """One radix-tree node: a full page of tokens (edge label = their
    bytes, held by the parent's ``children`` dict) mapped to the KV
    page that holds their positions."""

    __slots__ = ("page", "parent", "key", "children")

    def __init__(self, page, parent, key):
        self.page = page          # page id (cache-owned while linked)
        self.parent = parent      # _Node | None (root)
        self.key = key            # bytes of this page's tokens
        self.children: dict[bytes, _Node] = {}


class PrefixCache:
    """Radix index + refcounted page accounting over the engine's free
    list (the ``deque`` is shared with the engine, not copied — the
    existing free-list discipline stays observable).

    The engine calls: :meth:`match` at admission (then :meth:`retain`
    to pin the matched pages), :meth:`acquire` wherever it used to pop
    the free list, :meth:`publish` at retirement/preemption, and
    :meth:`release` wherever it used to extend the free list back.
    """

    def __init__(self, page_size: int, free_pages: deque, *,
                 enabled: bool = True, total_pages: int | None = None):
        self.page_size = int(page_size)
        self.free = free_pages
        self.enabled = bool(enabled)
        # total pool size for the conservation check; the free list at
        # construction holds every usable page, so default from it
        self.total_pages = (1 + len(free_pages) if total_pages is None
                            else int(total_pages))
        self.root = _Node(0, None, b"")
        self._ref: dict[int, int] = {}        # page -> resident refs
        self._page_node: dict[int, _Node] = {}  # cache-owned pages
        self._lru: dict[int, int] = {}        # ref-0 cached: page->tick
        self._tick = 0
        # the one counter the engine folds into its stats snapshot
        # (hit accounting lives in the engine: its numbers are
        # COW-adjusted tokens-not-recomputed, not raw match length)
        self.evictions = 0       # cached pages reclaimed under pressure

    # ------------------------------------------------------ gauges ----
    @property
    def cached_pages(self) -> int:
        """Ref-0 pages held only by the index (reclaimable)."""
        return len(self._lru)

    def cached_page_ids(self):
        return sorted(self._lru)

    def available(self) -> int:
        """Pages an allocation could obtain without preempting anyone:
        the free list plus every evictable cached page."""
        return len(self.free) + len(self._lru)

    def _touch(self):
        self._tick += 1
        return self._tick

    # --------------------------------------------------- allocation ---
    def acquire(self, key: str = "") -> int | None:
        """One page for a resident slot (ref starts at 1): from the
        free list, else by evicting the LRU cached page.  ``None`` when
        both are dry (the engine preempts then).  The deterministic
        ``engine_cache_evict`` drill (``key`` = requesting rid) forces
        the eviction path while free pages remain."""
        if faults.check(SITE_CACHE_EVICT, key=str(key)) and self._lru:
            self._evict_lru()
        if not self.free:
            if not self._lru or self._evict_lru() < 0:
                return None
            if not self.free:       # defensive: eviction must feed it
                return None
        pg = self.free.popleft()
        if self._ref.get(pg, 0) != 0:
            raise CacheIntegrityError(
                f"page {pg} on the free list with refcount "
                f"{self._ref[pg]} [{CacheIntegrityError.error_code}]")
        self._ref[pg] = 1
        return pg

    def retain(self, pages) -> None:
        """Pin matched pages for a resident slot (ref++); a ref-0
        cached page leaves the LRU pool (no longer evictable)."""
        for pg in pages:
            self._ref[pg] = self._ref.get(pg, 0) + 1
            self._lru.pop(pg, None)

    def release(self, pages) -> None:
        """Drop one resident reference per page: a zero-ref page
        returns to the LRU pool when the index owns it, else to the
        free list.  The ONLY way pages leave a slot."""
        for pg in pages:
            ref = self._ref.get(pg, 0)
            if ref <= 0:
                raise CacheIntegrityError(
                    f"double-free: page {pg} released with refcount "
                    f"{ref} [{CacheIntegrityError.error_code}]")
            self._ref[pg] = ref - 1
            if ref == 1:
                if pg in self._page_node:
                    self._lru[pg] = self._touch()
                else:
                    self.free.append(pg)

    # ------------------------------------------------------- index ----
    def _chunks(self, ids, n_pages):
        ids = np.asarray(ids, np.int32)
        ps = self.page_size
        for i in range(n_pages):
            yield ids[i * ps:(i + 1) * ps].tobytes()

    def match(self, ids) -> list[int]:
        """Walk the trie over ``ids`` page-by-page; returns the pages
        of the longest cached prefix (NOT yet retained — the engine
        pins them with :meth:`retain` once it commits the admission).
        Matching refreshes the path's LRU recency."""
        if not self.enabled:
            return []
        n = int(np.asarray(ids).size) // self.page_size
        node, pages = self.root, []
        for key in self._chunks(ids, n):
            child = node.children.get(key)
            if child is None:
                break
            pages.append(child.page)
            if child.page in self._lru:
                self._lru[child.page] = self._touch()
            node = child
        return pages

    def publish(self, ids, pages, n_tokens) -> int:
        """Index a retiring/preempted slot's FULL pages: ``ids`` are
        the tokens whose KV is resident, ``pages`` the slot's page list
        (positional), ``n_tokens`` how many positions are actually
        written.  Pages adopted by a new trie node become cache-owned
        (they go to the LRU pool when the slot releases them); a path
        segment already indexed — by this request's own earlier
        preemption or by a concurrent twin — keeps the incumbent page
        and the slot's duplicate stays private (freed on release).
        Returns the number of newly indexed pages."""
        if not self.enabled:
            return 0
        n = min(int(n_tokens) // self.page_size, len(pages))
        node, new = self.root, 0
        for i, key in enumerate(self._chunks(ids, n)):
            child = node.children.get(key)
            if child is None:
                pg = int(pages[i])
                if pg in self._page_node:   # already owned elsewhere
                    break                   # (same bytes can't own 2x)
                child = _Node(pg, node, key)
                node.children[key] = child
                self._page_node[pg] = child
                new += 1
            node = child
        return new

    # ---------------------------------------------------- eviction ----
    def _evict_lru(self) -> int:
        """Reclaim the least-recently-used EVICTABLE cached page (a
        trie leaf — interior pages wait until their subtree drains) and
        put it on the free list."""
        page = min(
            (pg for pg in self._lru if not self._page_node[pg].children),
            key=self._lru.__getitem__, default=None)
        if page is None:       # only interior ref-0 pages: cannot
            return -1          # happen (subtrees of ref-0 are ref-0)
        node = self._page_node.pop(page)
        node.parent.children.pop(node.key, None)
        self._lru.pop(page)
        self._ref.pop(page, None)
        self.free.append(page)
        self.evictions += 1
        return page

    # ------------------------------------------------- invariants -----
    def check(self) -> None:
        """Page-conservation audit; raises :class:`CacheIntegrityError`
        (PDT-E019) on any violation.  Cheap enough for tests to call
        after every mutation (the randomized property test does)."""
        free = list(self.free)
        free_set = set(free)
        code = CacheIntegrityError.error_code
        if len(free) != len(free_set):
            raise CacheIntegrityError(
                f"free list holds duplicates [{code}]")
        if 0 in free_set or 0 in self._page_node or 0 in self._lru:
            raise CacheIntegrityError(
                f"null page 0 entered the allocator [{code}]")
        in_use = {p for p, r in self._ref.items() if r > 0}
        if in_use & free_set:
            raise CacheIntegrityError(
                f"pages both free and referenced: "
                f"{sorted(in_use & free_set)} [{code}]")
        cached = set(self._lru)
        if cached & free_set or cached & in_use:
            raise CacheIntegrityError(
                f"cached pages overlap free/in-use [{code}]")
        for pg in cached:
            if pg not in self._page_node:
                raise CacheIntegrityError(
                    f"LRU page {pg} not owned by the index [{code}]")
        total = len(in_use) + len(free_set) + len(cached)
        if total != self.total_pages - 1:
            raise CacheIntegrityError(
                f"page conservation broken: {len(in_use)} in use + "
                f"{len(free_set)} free + {len(cached)} cached != "
                f"{self.total_pages - 1} usable pages [{code}]")
        # every owned page is either pinned by a resident or in the LRU
        for pg, node in self._page_node.items():
            if self._ref.get(pg, 0) == 0 and pg not in self._lru:
                raise CacheIntegrityError(
                    f"owned ref-0 page {pg} missing from the LRU pool "
                    f"[{code}]")
            if node.parent.children.get(node.key) is not node:
                raise CacheIntegrityError(
                    f"trie link broken for page {pg} [{code}]")

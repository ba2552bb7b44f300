"""Radix-tree prefix cache over physical KV pages.

SGLang's RadixAttention adapted to the paged pool (``runtime/paged.py``):
one tree node = one ``page_size``-aligned token chunk backed by exactly
ONE physical page, so matching, insertion and eviction are all
page-granular. The tree stores only page *ids* plus an LRU stamp — the
KV bytes live in the device pool and refcounts live in the PageTable
(each resident node holds one ``pin`` on its page).

Ownership protocol (driven by Engine.stitch/donate_prefix/radix_evict):

- ``match`` is read-only: the longest cached chunk path for a token
  sequence, plus at most one *partial* boundary node whose first ``q``
  tokens match (the engine copies that page before the new slot writes
  its tail into it — copy-on-write).
- ``insert`` walks/creates nodes for a finished request's full-page
  chunks and returns the nodes it newly created; the engine pins those
  nodes' pages (chunks already present keep the tree's original page and
  the donor's duplicate page is simply freed by its release).
- ``evict`` pops least-recently-used LEAF nodes one page at a time —
  children always leave before parents, so every resident path stays
  contiguous from the root — skipping pages some slot still maps.

Every node here lives in device memory (``tier == 0``, ``page`` a live
pool page). The nodes keep the reference's ``tier`` and ``host`` fields
(tier 1: the page's bytes spilled to a host arena, ``page == -1``), and
``match`` and ``insert`` treat them as the reference does, so a host
tier can be added without a rewrite; the spill and promotion
transitions that would drive them are not part of this copy.

A logical clock (bumped per match/insert) orders recency; no wall time.

The tree itself never frees a page: eviction hands page ids back to the
engine, whose ``unpin`` routes any refcount-zero page through the
PageTable's epoch fence, so a page an un-retired decode dispatch may
still read sits in quarantine until that dispatch is waited on.

A copy of ``ollama_operator_tpu/runtime/radix.py`` without the host-tier
transitions (``spill_lru``, ``mark_spilled``, ``mark_promoted``,
``remove``, ``drop_host_lru``) and the snapshot and KV-import helpers
(``child``, ``insert_host``, ``insert_page``, ``walk``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple


class _Node:
    __slots__ = ("chunk", "page", "parent", "children", "stamp", "tier",
                 "host")

    def __init__(self, chunk: Tuple[int, ...], page: int,
                 parent: Optional["_Node"], stamp: int):
        self.chunk = chunk
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.stamp = stamp
        self.tier = 0
        self.host = None  # HostEntry when tier == 1


class RadixCache:
    """Trie keyed on page_size token chunks; nodes hold physical pages."""

    def __init__(self, page_size: int):
        assert page_size >= 1
        self.page_size = page_size
        self._root = _Node((), -1, None, 0)
        self._clock = 0
        self._n = 0       # all resident nodes (any tier)
        self._n_t0 = 0    # tier-0 nodes == pages the tree pins in HBM
        # host entries orphaned by insert() promotions, drained by the
        # engine (take_dropped_hosts) so the arena accounting stays exact
        self._dropped_hosts: List[object] = []

    @property
    def n_nodes(self) -> int:
        """Resident nodes across all tiers."""
        return self._n

    @property
    def n_pages(self) -> int:
        """Tier-0 nodes == physical pages the tree pins (one each)."""
        return self._n_t0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, ids: Sequence[int], limit: int, bump: bool = True
              ) -> Tuple[List[_Node], Optional[_Node], int]:
        """Longest cached prefix of ``ids`` within ``limit`` tokens:
        ``(full_nodes, partial_node, partial_len)`` — full-chunk path
        nodes in order, then optionally ONE boundary node whose first
        ``partial_len`` (1 ≤ q < page_size) tokens extend the match.
        Nodes of any tier are returned; the caller splits by ``tier``.
        ``bump=False`` probes without touching LRU recency."""
        ps = self.page_size
        limit = min(limit, len(ids))
        node = self._root
        full: List[_Node] = []
        pos = 0
        while pos + ps <= limit:
            child = node.children.get(tuple(int(t) for t in ids[pos:pos + ps]))
            if child is None:
                break
            full.append(child)
            node = child
            pos += ps
        part, part_q = None, 0
        room = min(ps, limit - pos)
        if room > 0:
            head = [int(t) for t in ids[pos:pos + room]]
            for chunk, child in node.children.items():
                q = 0
                while q < room and chunk[q] == head[q]:
                    q += 1
                if q > part_q:
                    part, part_q = child, q
        if bump and (full or part is not None):
            stamp = self._tick()
            for n in full:
                n.stamp = stamp
            if part is not None:
                part.stamp = stamp
        return full, part, part_q

    def insert(self, ids: Sequence[int], pages: Sequence[int]) -> List[_Node]:
        """Walk/create the chunk path for ``ids`` (page-aligned,
        ``len(pages)`` chunks); chunk ``i`` is backed by ``pages[i]`` when
        newly created. Returns the nodes that ADOPTED the donor's page —
        the caller must pin those pages. Chunks already resident at
        tier 0 keep the tree's existing page; a chunk resident at
        tier 1 is *promoted*: it adopts the donor's page (also returned
        for pinning) and its host entry lands in ``take_dropped_hosts``
        for the engine to release from the arena."""
        ps = self.page_size
        assert len(ids) >= len(pages) * ps
        node = self._root
        stamp = self._tick()
        adopted: List[_Node] = []
        for i, pg in enumerate(pages):
            chunk = tuple(int(t) for t in ids[i * ps:(i + 1) * ps])
            child = node.children.get(chunk)
            if child is None:
                child = _Node(chunk, int(pg), node, stamp)
                node.children[chunk] = child
                self._n += 1
                self._n_t0 += 1
                adopted.append(child)
            elif child.tier != 0:
                # promotion: the donor hands the tree a live HBM copy of
                # a chunk currently spilled — adopt the page, retire the
                # host bytes (donor path visits parents first, so the
                # tier0*-then-tier1* path invariant is preserved)
                child.page = int(pg)
                child.tier = 0
                self._n_t0 += 1
                if child.host is not None:
                    self._dropped_hosts.append(child.host)
                    child.host = None
                adopted.append(child)
            child.stamp = stamp
            node = child
        return adopted

    def take_dropped_hosts(self) -> List[object]:
        """Host entries orphaned since the last call (insert promotions);
        the engine frees them from the arena."""
        dropped, self._dropped_hosts = self._dropped_hosts, []
        return dropped

    def evict(self, n_pages: int, evictable: Callable[[int], bool]
              ) -> List[int]:
        """Pop up to ``n_pages`` least-recently-used tier-0 leaves whose
        page satisfies ``evictable`` (e.g. no slot maps it). Page-by-page:
        each removal may expose its parent as the next leaf. Returns the
        evicted page ids (caller unpins them)."""
        freed: List[int] = []
        while len(freed) < n_pages:
            lru: Optional[_Node] = None
            stack = [self._root]
            while stack:
                node = stack.pop()
                for child in node.children.values():
                    if child.children:
                        stack.append(child)
                    elif child.tier == 0 and evictable(child.page) and (
                            lru is None or child.stamp < lru.stamp):
                        lru = child
            if lru is None:
                break
            del lru.parent.children[lru.chunk]
            self._n -= 1
            self._n_t0 -= 1
            freed.append(lru.page)
        return freed

    def reset(self) -> List[int]:
        """Drop every node; returns all resident TIER-0 pages (caller
        unpins). Tier-1 host entries die with their nodes — the engine
        clears the arena's accounting wholesale."""
        pages: List[int] = []
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            if node.tier == 0:
                pages.append(node.page)
            stack.extend(node.children.values())
        self._root.children.clear()
        self._n = 0
        self._n_t0 = 0
        self._dropped_hosts = []
        return pages

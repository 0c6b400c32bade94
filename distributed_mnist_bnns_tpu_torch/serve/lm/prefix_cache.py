"""Radix prefix index over the paged KV pool: copy-on-write prompt
sharing for the continuous-batching LM engine.

Counterpart of the JAX package's ``serve/lm/prefix_cache.py``, a copy
with its lock discipline (host Python there too). A full page of K/V is
an immutable function of the ``page_size`` tokens that produced it and
everything before them, so a page can be shared read-only between
sequences, at page granularity.

Structure: a trie whose edges are page-size token blocks. A node holds
the page id of its block's K/V, and the cache owns one allocator
reference to it (``PageAllocator`` refcounts). The engine:

  * at admission, walks the longest matching chain of full blocks
    (capped at ``prompt_len - 1``: at least one suffix token must
    prefill, so admission has log-probs to sample the first token from),
    ``fork``s the hit pages into the new sequence's page table, and
    prefills only the uncached suffix;
  * at eviction, publishes the sequence's full pages back into the trie
    (the page reference moves from the sequence to the cache; blocks
    already present release the duplicate);
  * under pool pressure, evicts leaves in LRU order, only those whose
    page refcount is 1 (held by the cache alone): a page a live sequence
    still maps is never freed from under it.

Only full pages are shared: divergence past a shared prefix starts at
the next page boundary, so the forking sequence never writes a forked
page.

Thread-safety: the engine's scheduler thread is the only mutator; the
lock gives the HTTP handlers' ``stats()`` reads (``/healthz``) a
consistent snapshot.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...ops.paged_kv import PageAllocator

__all__ = ["PrefixCache"]


class _Node:
    """One cached page: the K/V of ``block`` (a page_size token tuple)
    given the path from the root."""

    __slots__ = ("block", "page", "children", "parent", "last_used")

    def __init__(self, block: Tuple[int, ...], page: int,
                 parent: Optional["_Node"]):
        self.block = block
        self.page = int(page)
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.last_used = 0


class PrefixCache:
    def __init__(self, allocator: PageAllocator, page_size: int):
        self.allocator = allocator
        self.page_size = int(page_size)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[int, ...], _Node] = {}  # root edges
        self._entries = 0
        self._clock = 0          # monotonic touch counter (LRU order)
        self.hits = 0
        self.misses = 0

    # -- queries -------------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": self._entries,
                "pages": self._entries,        # one page per entry
                "hits": self.hits,
                "misses": self.misses,
            }

    @property
    def entries(self) -> int:
        with self._lock:
            return self._entries

    # -- admission: longest cached prefix ------------------------------------

    def lookup(self, tokens: np.ndarray, max_tokens: int
               ) -> Tuple[int, List[int]]:
        """Longest cached full-block prefix of ``tokens``, capped at
        ``max_tokens`` (callers cap at ``len(tokens) - 1`` so at least
        one position is left to prefill). Hit pages are ``fork``ed —
        the caller owns one reference per returned page and must
        ``free`` them (directly, or through the sequence's normal page
        lifetime). Returns ``(cached_tokens, pages)``."""
        ps = self.page_size
        toks = np.asarray(tokens).reshape(-1)
        limit = min(int(max_tokens), len(toks)) // ps
        pages: List[int] = []
        with self._lock:
            children = self._children
            for b in range(limit):
                block = tuple(int(t) for t in toks[b * ps:(b + 1) * ps])
                node = children.get(block)
                if node is None:
                    break
                self._clock += 1
                node.last_used = self._clock
                pages.append(node.page)
                children = node.children
            if pages:
                # Fork inside the lock: eviction (same scheduler
                # thread today, but the invariant should not depend on
                # that) cannot free a page between match and fork.
                self.allocator.fork(pages)
        return len(pages) * ps, pages

    def note_result(self, hit: bool) -> None:
        """Record one admission's hit/miss. Separate from ``lookup``
        deliberately: an admission that cannot get its suffix pages
        releases the fork and retries on a later scheduler pass, and
        those retries must not inflate the hit rate."""
        with self._lock:
            if hit:
                self.hits += 1
            else:
                self.misses += 1

    # -- eviction-time publication -------------------------------------------

    def insert(self, tokens: np.ndarray, pages: List[int]) -> int:
        """Publish a finished sequence's pages. ``tokens`` is the
        written token sequence (prompt + emitted tokens whose K/V was
        written); ``pages`` its page-table prefix in order. Ownership
        of EVERY page reference in ``pages`` transfers here: full-block
        pages new to the trie are kept (the sequence's reference
        becomes the cache's), duplicates of already-cached blocks and
        the partial tail page are released. Returns the number of
        newly published pages."""
        ps = self.page_size
        toks = np.asarray(tokens).reshape(-1)
        full = len(toks) // ps
        published = 0
        release: List[int] = []
        with self._lock:
            children = self._children
            parent: Optional[_Node] = None
            for b in range(min(full, len(pages))):
                block = tuple(int(t) for t in toks[b * ps:(b + 1) * ps])
                node = children.get(block)
                if node is None:
                    node = _Node(block, pages[b], parent)
                    children[block] = node
                    self._entries += 1
                    published += 1
                else:
                    # Same block already cached (possibly the very page
                    # this sequence forked at admission): release the
                    # duplicate reference, keep the canonical node.
                    release.append(pages[b])
                self._clock += 1
                node.last_used = self._clock
                children = node.children
                parent = node
            release.extend(pages[min(full, len(pages)):])
        if release:
            self.allocator.free(release)
        return published

    # -- pool pressure --------------------------------------------------------

    def evict(self, need: int) -> int:
        """Free up to ``need`` pages by dropping leaf entries in LRU
        order. Only entries whose page refcount is 1 (cache-only
        holders) are evictable — a page a live sequence forked stays.
        Returns the number of pages actually freed."""
        freed = 0
        with self._lock:
            while freed < need:
                victim = self._lru_evictable_leaf()
                if victim is None:
                    break
                self._unlink(victim)
                self.allocator.free([victim.page])
                freed += 1
        return freed

    def clear(self) -> int:
        """Release every cache-held page reference (drain/teardown, and
        the dispatch-failure path — rebuilt pools make every cached
        page's contents garbage). Pages still forked by live sequences
        just lose the cache's reference."""
        cleared = 0
        with self._lock:
            stack = list(self._children.values())
            pages: List[int] = []
            while stack:
                node = stack.pop()
                pages.append(node.page)
                stack.extend(node.children.values())
            self._children = {}
            self._entries = 0
            cleared = len(pages)
            if pages:
                self.allocator.free(pages)
        return cleared

    # -- internals (lock held) ------------------------------------------------

    def _lru_evictable_leaf(self) -> Optional[_Node]:  # holds-lock: _lock
        best: Optional[_Node] = None
        stack = list(self._children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
                continue
            if self.allocator.refcount(node.page) != 1:
                continue               # a live sequence still maps it
            if best is None or node.last_used < best.last_used:
                best = node
        return best

    def _unlink(self, node: _Node) -> None:  # holds-lock: _lock
        siblings = (
            node.parent.children if node.parent is not None
            else self._children
        )
        siblings.pop(node.block, None)
        self._entries -= 1

"""Token-trie prefix index over paged host-KV spans.

A :class:`PrefixIndex` maps page-aligned token blocks to shared, read-only
KV pages from :mod:`repro_torch.memory.paged_kv`.  Each trie node covers exactly
one page (``page_size`` tokens); its key chains the parent's key with a
stable hash of the node's token block, so the deepest node's key identifies
the whole span.  Nodes are refcounted by the sequences bound to them:
``acquire``/``release`` walk the chain root-ward so an inner node can never
be evicted while a descendant span is live.

Eviction is LRU over zero-ref *leaves* only and cascades: once a leaf goes,
its parent may become a zero-ref leaf and is a candidate on the next pass.
Dropping a node releases the index's reference to its page arrays — with no
live sequence bound (refs == 0 is the precondition) that frees the host
memory too.

The index is engine-local (one per :class:`HostKVStore`).  ``graft`` adopts
a chain from a peer store's index during MIGRATE: nodes already present are
reused (the span's bytes move zero times for siblings that migrated
earlier); missing nodes are re-created around the *same* read-only page
arrays, so a span crosses the wire once no matter how many forks ride it.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

_MASK = 0xFFFFFFFFFFFFFFFF


def block_key(parent_key: int, block: Sequence[int]) -> int:
    """Stable chained hash of one page-aligned token block (FNV-style)."""
    h = (parent_key * 0x100000001B3 + 0x9E3779B97F4A7C15) & _MASK
    for t in block:
        h = ((h ^ (int(t) & 0xFFFFFFFF)) * 0x100000001B3) & _MASK
    return h


class PrefixNode:
    """One shared page: ``page_size`` tokens plus their KV page per leaf."""

    __slots__ = ("key", "block", "parent", "children", "pages", "refs",
                 "tick")

    def __init__(self, key: int, block: tuple, parent: Optional["PrefixNode"]):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[int, "PrefixNode"] = {}
        self.pages: Dict[str, np.ndarray] = {}
        self.refs = 0
        self.tick = 0

    def chain(self) -> List["PrefixNode"]:
        """Root-to-self node list (excluding the sentinel root)."""
        out: List[PrefixNode] = []
        nd: Optional[PrefixNode] = self
        while nd is not None and nd.parent is not None:
            out.append(nd)
            nd = nd.parent
        out.reverse()
        return out

    def nbytes(self) -> int:
        return sum(int(p.nbytes) for p in self.pages.values())


class PrefixIndex:
    """Refcounted trie of shared KV page spans with LRU eviction."""

    def __init__(self, page_size: int, max_pages: int = 4096):
        self.page_size = page_size
        self.max_pages = max_pages
        self.root = PrefixNode(0, (), None)
        self.num_pages = 0
        self.cached_nbytes = 0      # bytes of page arrays held by the trie
        self._tick = 0
        self.stats = {"hits": 0, "hit_tokens": 0, "inserted_pages": 0,
                      "evicted_pages": 0, "acquires": 0, "releases": 0}

    # -- lookup / insert ----------------------------------------------------

    def match(self, tokens: Sequence[int]) -> List[PrefixNode]:
        """Longest chain of full-page blocks of ``tokens`` present in the
        trie.  Does NOT acquire — callers bind via ``acquire``."""
        P = self.page_size
        cur, chain = self.root, []
        for i in range(len(tokens) // P):
            block = tuple(int(t) for t in tokens[i * P:(i + 1) * P])
            nxt = cur.children.get(block_key(cur.key, block))
            if nxt is None or nxt.block != block:
                break
            chain.append(nxt)
            cur = nxt
        if chain:
            self.stats["hits"] += 1
            self.stats["hit_tokens"] += len(chain) * P
        return chain

    def extend(self, chain: List[PrefixNode], tokens: Sequence[int],
               pages_for: Optional[Callable[[int], Dict[str, np.ndarray]]]
               = None) -> List[PrefixNode]:
        """Insert nodes for the full-page blocks of ``tokens`` beyond
        ``chain`` (a ``match`` result).  ``pages_for(page_idx)`` supplies
        the page arrays for a new node — they are frozen read-only here so
        every holder copy-on-writes.  ``None`` inserts metadata-only nodes
        (SimEngine).  Returns the full chain covering the prompt's pages."""
        P = self.page_size
        cur = chain[-1] if chain else self.root
        out = list(chain)
        for i in range(len(out), len(tokens) // P):
            block = tuple(int(t) for t in tokens[i * P:(i + 1) * P])
            key = block_key(cur.key, block)
            nd = cur.children.get(key)
            if nd is None or nd.block != block:
                nd = PrefixNode(key, block, cur)
                if pages_for is not None:
                    for name, page in pages_for(i).items():
                        page.flags.writeable = False
                        nd.pages[name] = page
                cur.children[key] = nd
                self.num_pages += 1
                self.cached_nbytes += nd.nbytes()
                self.stats["inserted_pages"] += 1
            out.append(nd)
            cur = nd
        self._maybe_evict()
        return out

    def graft(self, src_node: PrefixNode) -> tuple:
        """Adopt a peer index's chain (MIGRATE dst side).  Returns
        ``(chain, new_bytes)`` where ``new_bytes`` counts only pages this
        store did not already hold — a sibling's earlier migrate makes the
        span free."""
        cur, chain, new_bytes = self.root, [], 0
        for nd in src_node.chain():
            child = cur.children.get(nd.key)
            if child is None or child.block != nd.block:
                child = PrefixNode(nd.key, nd.block, cur)
                child.pages = dict(nd.pages)
                cur.children[nd.key] = child
                self.num_pages += 1
                self.cached_nbytes += child.nbytes()
                self.stats["inserted_pages"] += 1
                new_bytes += child.nbytes()
            chain.append(child)
            cur = child
        return chain, new_bytes

    # -- refcounts ----------------------------------------------------------

    def acquire(self, node: Optional[PrefixNode]) -> None:
        if node is None:
            return
        self.stats["acquires"] += 1
        self._tick += 1
        nd: Optional[PrefixNode] = node
        while nd is not None and nd.parent is not None:
            nd.refs += 1
            nd.tick = self._tick
            nd = nd.parent

    def release(self, node: Optional[PrefixNode]) -> None:
        if node is None:
            return
        self.stats["releases"] += 1
        nd: Optional[PrefixNode] = node
        while nd is not None and nd.parent is not None:
            if nd.refs <= 0:
                raise AssertionError("prefix span refcount underflow")
            nd.refs -= 1
            nd = nd.parent
        self._maybe_evict()

    def live_refs(self) -> int:
        """Sum of refcounts over the whole trie (0 == no bound sequences)."""
        total, stack = 0, list(self.root.children.values())
        while stack:
            nd = stack.pop()
            total += nd.refs
            stack.extend(nd.children.values())
        return total

    # -- eviction -----------------------------------------------------------

    def _evictable(self) -> List[PrefixNode]:
        out, stack = [], list(self.root.children.values())
        while stack:
            nd = stack.pop()
            if not nd.children and nd.refs == 0:
                out.append(nd)
            stack.extend(nd.children.values())
        return out

    def _evict(self, victim: PrefixNode) -> None:
        del victim.parent.children[victim.key]
        self.cached_nbytes -= victim.nbytes()
        victim.pages.clear()    # cascade: frees the host-store pages
        self.num_pages -= 1
        self.stats["evicted_pages"] += 1

    def evict_lru(self) -> bool:
        """Evict the LRU zero-ref leaf regardless of ``max_pages`` — the
        entry point of the host-store byte-budget cascade
        (``HostKVStore.enforce_budget``).  Returns False when every span
        is live-referenced (nothing evictable)."""
        victims = self._evictable()
        if not victims:
            return False
        self._evict(min(victims, key=lambda nd: nd.tick))
        return True

    def _maybe_evict(self) -> None:
        while self.num_pages > self.max_pages:
            victims = self._evictable()
            if not victims:
                return              # every span is live-referenced
            self._evict(min(victims, key=lambda nd: nd.tick))

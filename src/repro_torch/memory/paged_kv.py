"""Paged KV storage: host store (single source of truth) + device slot pool.

Paper §5.2: host memory holds parameters and the KV cache of *every*
sequence scheduled to a node; the device holds only the active working set.
YIELD checkpoints a sequence's device state to host pages; COMBINE restores
it into a free device slot.  Token-indexed cache leaves (k/v/ckv/kr) are
paged at ``page_size`` tokens; fixed-size state (SSM state, conv stubs,
ring caches) is stored whole.

Shared-prefix reuse rides the page granularity: a sequence may *share* its
leading full pages with other sequences through the node's
:class:`~repro_torch.prefix.index.PrefixIndex`.  Shared pages are frozen
(``writeable = False``) and refcounted by the index; every write path here
copy-on-writes — a private page is allocated at the first divergent write
and the shared original is untouched.  ``drop`` releases the sequence's
span reference exactly once (the SeqState is popped, so a second drop is a
no-op), and MIGRATE moves a span's bytes once per span via ``adopt``, not
once per sequence.

On this CPU container "host" is NumPy and "device" is the jax array holding
the engine's dense decode cache; on a real TPU deployment the same classes
wrap pinned host buffers + device_put/device_get with async staging through
the ring buffer (memory/buffers.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.prefix.index import PrefixIndex, PrefixNode

PAGED_LEAVES = ("k", "v", "ckv", "kr")  # token-indexed (dim 1 = position)


@dataclasses.dataclass
class SeqState:
    """Host-resident state of one sequence (paged).

    ``prefix_node`` is the deepest trie node of the shared span this
    sequence rides (``None`` = fully private); the span covers the first
    ``prefix_len`` tokens (always a multiple of the page size)."""
    seq_id: int
    length: int = 0                       # tokens represented in KV
    pages: Dict[str, List[np.ndarray]] = dataclasses.field(default_factory=dict)
    whole: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    prefix_node: Optional[PrefixNode] = None
    prefix_len: int = 0

    def nbytes(self) -> int:
        n = sum(p.nbytes for ps in self.pages.values() for p in ps)
        return n + sum(w.nbytes for w in self.whole.values())

    def private_nbytes(self) -> int:
        """Bytes owned by this sequence alone (shared span excluded)."""
        n = 0
        for ps in self.pages.values():
            n += sum(p.nbytes for p in ps if p.flags.writeable)
        return n + sum(w.nbytes for w in self.whole.values())


class HostKVStore:
    """Per-node unified host store; page granularity = P tokens."""

    def __init__(self, page_size: int = 64, enable_prefix: bool = True,
                 max_prefix_pages: int = 4096,
                 budget_bytes: Optional[int] = None):
        self.page_size = page_size
        self.seqs: Dict[int, SeqState] = {}
        self.prefix_index: Optional[PrefixIndex] = (
            PrefixIndex(page_size, max_prefix_pages) if enable_prefix
            else None)
        self.cow_copies = 0
        # host-spill byte budget (None = unbounded): exceeding it cascades
        # to prefix-span LRU eviction (enforce_budget); a store still over
        # budget afterwards is the job tier's throttle signal
        self.budget_bytes = budget_bytes
        self.budget_evictions = 0       # spans evicted by the byte budget
        # incrementally-maintained mirror of the nbytes() dedup walk —
        # the governor polls it every round, so it must be O(1)
        self._nbytes = 0
        self._page_refs: Dict[int, int] = {}    # id(page) -> list refs

    # -- incremental byte accounting ----------------------------------------
    def _ref_page(self, p: np.ndarray) -> None:
        k = id(p)
        c = self._page_refs.get(k, 0)
        if c == 0:
            self._nbytes += int(p.nbytes)
        self._page_refs[k] = c + 1

    def _unref_page(self, p: np.ndarray) -> None:
        k = id(p)
        c = self._page_refs.get(k, 0)
        if c <= 1:
            self._page_refs.pop(k, None)
            if c == 1:
                self._nbytes -= int(p.nbytes)
        else:
            self._page_refs[k] = c - 1

    def _ref_state(self, st: SeqState) -> None:
        for ps in st.pages.values():
            for p in ps:
                self._ref_page(p)
        self._nbytes += sum(int(w.nbytes) for w in st.whole.values())

    def _unref_state(self, st: SeqState) -> None:
        for ps in st.pages.values():
            for p in ps:
                self._unref_page(p)
        self._nbytes -= sum(int(w.nbytes) for w in st.whole.values())

    def _set_whole(self, st: SeqState, name: str, arr: np.ndarray) -> None:
        old = st.whole.get(name)
        if old is not None:
            self._nbytes -= int(old.nbytes)
        st.whole[name] = arr
        self._nbytes += int(arr.nbytes)

    # -- bookkeeping --------------------------------------------------------
    def has(self, seq_id: int) -> bool:
        return seq_id in self.seqs

    def nbytes(self) -> int:
        """Resident bytes; a page shared by N sequences counts once.
        O(1): reads the incrementally-maintained counter (see
        ``nbytes_walk`` for the recomputed ground truth)."""
        return self._nbytes

    def nbytes_walk(self) -> int:
        """Recompute resident bytes by walking every SeqState (dedup by
        page identity) — the invariant ``nbytes() == nbytes_walk()`` is
        asserted in tests; production callers use the O(1) counter."""
        seen, n = set(), 0
        for s in self.seqs.values():
            for ps in s.pages.values():
                for p in ps:
                    if id(p) not in seen:
                        seen.add(id(p))
                        n += p.nbytes
            n += sum(w.nbytes for w in s.whole.values())
        return n

    def host_bytes(self) -> int:
        """Total host KV footprint the byte budget governs: sequence-
        resident bytes plus span pages cached in the prefix trie.
        Conservative: a page both sequence-bound and trie-resident counts
        in both terms, so the budget can never under-estimate."""
        n = self._nbytes
        if self.prefix_index is not None:
            n += self.prefix_index.cached_nbytes
        return n

    def over_budget(self) -> bool:
        return (self.budget_bytes is not None
                and self.host_bytes() > self.budget_bytes)

    def enforce_budget(self) -> int:
        """Byte-budget cascade: evict LRU zero-ref prefix spans until the
        footprint fits (or the trie has nothing evictable).  Returns spans
        evicted.  A store still over budget afterwards carries only live
        sequence state — the job tier throttles admissions instead of
        dying."""
        if self.budget_bytes is None or self.prefix_index is None:
            return 0
        evicted = 0
        while self.host_bytes() > self.budget_bytes:
            if not self.prefix_index.evict_lru():
                break
            evicted += 1
        self.budget_evictions += evicted
        return evicted

    def num_pages(self, seq_id: int) -> int:
        s = self.seqs[seq_id]
        return max((len(ps) for ps in s.pages.values()), default=0)

    def drop(self, seq_id: int):
        """Span-aware release: pops the SeqState and drops its span
        reference exactly once — a duplicate drop (forked teardown racing a
        recovery path) finds nothing to pop and touches no refcount."""
        st = self.seqs.pop(seq_id, None)
        if st is not None:
            self._unref_state(st)
            if st.prefix_node is not None and self.prefix_index is not None:
                self.prefix_index.release(st.prefix_node)
                st.prefix_node = None

    def pop_state(self, seq_id: int) -> Optional[SeqState]:
        """MIGRATE src side: detach a SeqState without touching its span
        refcount (the caller releases the span only after the destination
        adopted it, so shared ancestors never transit refcount zero
        mid-move)."""
        st = self.seqs.pop(seq_id, None)
        if st is not None:
            self._unref_state(st)
        return st

    # -- shared-prefix spans -------------------------------------------------
    def publish_prefix(self, seq_id: int, tokens) -> Optional[List[PrefixNode]]:
        """Register a freshly prefilled sequence's full prompt pages in the
        prefix index and bind the sequence to the span.  Pages entering the
        trie are frozen read-only; pages already in the trie (an identical
        prompt published earlier) replace this sequence's private copies, so
        duplicate submits dedupe to one canonical span."""
        if self.prefix_index is None or len(tokens) < self.page_size:
            return None
        st = self.seqs[seq_id]
        idx = self.prefix_index

        def pages_for(i: int) -> Dict[str, np.ndarray]:
            return {name: ps[i] for name, ps in st.pages.items()
                    if i < len(ps)}

        chain = idx.extend(idx.match(tokens), tokens, pages_for)
        for i, nd in enumerate(chain):
            for name, page in nd.pages.items():
                if name in st.pages and i < len(st.pages[name]):
                    old = st.pages[name][i]
                    if old is not page:     # dedupe to the canonical object
                        self._ref_page(page)
                        self._unref_page(old)
                    st.pages[name][i] = page
        self.bind_prefix(seq_id, chain)
        return chain

    def bind_prefix(self, seq_id: int, chain: List[PrefixNode]) -> None:
        """Point a sequence at a span chain and take one reference.  A
        rebind (publish after attach extends the span) releases the old
        reference — after taking the new one, so the shared ancestors can
        never transit refcount zero mid-rebind."""
        if not chain or self.prefix_index is None:
            return
        st = self.seqs[seq_id]
        prev = st.prefix_node
        st.prefix_node = chain[-1]
        st.prefix_len = len(chain) * self.page_size
        self.prefix_index.acquire(st.prefix_node)
        if prev is not None:
            self.prefix_index.release(prev)

    def clone_shared(self, src_seq_id: int, dst_seq_id: int) -> SeqState:
        """Fork: create ``dst`` sharing ``src``'s span pages; everything
        past the span (the partial prompt-tail page, whole-state leaves) is
        deep-copied so the fork diverges without touching the lead."""
        src = self.seqs[src_seq_id]
        chain = src.prefix_node.chain() if src.prefix_node is not None else []
        k = len(chain)
        st = SeqState(dst_seq_id, length=src.length)
        for name, ps in src.pages.items():
            st.pages[name] = list(ps[:k]) + [p.copy() for p in ps[k:]]
        st.whole = {n: w.copy() for n, w in src.whole.items()}
        self.seqs[dst_seq_id] = st
        self._ref_state(st)
        self.bind_prefix(dst_seq_id, chain)
        self.enforce_budget()
        return st

    def attach_shared(self, seq_id: int, chain: List[PrefixNode]) -> SeqState:
        """Cross-submit prefix hit: seed a new sequence from a matched span;
        the caller appends the recomputed tail via ``append_tokens``."""
        st = SeqState(seq_id, length=len(chain) * self.page_size)
        names = set()
        for nd in chain:
            names.update(nd.pages)
        for name in sorted(names):
            if all(name in nd.pages for nd in chain):
                st.pages[name] = [nd.pages[name] for nd in chain]
        self.seqs[seq_id] = st
        self._ref_state(st)
        self.bind_prefix(seq_id, chain)
        return st

    def adopt(self, seq_id: int, st: SeqState) -> int:
        """MIGRATE dst side: take ownership of a SeqState checkpointed on a
        peer store.  The shared span is grafted into this store's index —
        pages a sibling already moved here cost zero bytes — and the span
        reference is re-taken locally.  Returns bytes actually moved."""
        moved = st.private_nbytes()
        if st.prefix_node is not None and self.prefix_index is not None:
            chain, new_bytes = self.prefix_index.graft(st.prefix_node)
            moved += new_bytes
            k = len(chain)
            for name in st.pages:
                for i, nd in enumerate(chain[:len(st.pages[name])]):
                    if name in nd.pages:
                        st.pages[name][i] = nd.pages[name]
            st.prefix_node = chain[-1] if chain else None
            st.prefix_len = k * self.page_size
            self.seqs[seq_id] = st
            self._ref_state(st)
            self.prefix_index.acquire(st.prefix_node)
        else:
            if st.prefix_node is not None:
                # dst has no index: span becomes private; nothing to ref
                st.prefix_node = None
                st.prefix_len = 0
                moved = st.nbytes()
            self.seqs[seq_id] = st
            self._ref_state(st)
        self.enforce_budget()
        return moved

    # -- checkpoint (YIELD) -------------------------------------------------
    def checkpoint(self, seq_id: int, cache_slices: Dict[str, np.ndarray],
                   length: int):
        """Store a sequence's cache arrays.  Paged leaves have layout
        (L, S, ...) with S = positions; only the first `length` positions are
        persisted, page by page.  Pages inside a shared span are kept as-is
        (decode never rewrites past KV, and rewriting them would break the
        share), so YIELD/COMBINE cycles preserve sharing."""
        st = self.seqs.setdefault(seq_id, SeqState(seq_id))
        st.length = length
        P = self.page_size
        keep_pages = st.prefix_len // P
        for name, arr in cache_slices.items():
            if name in PAGED_LEAVES:
                existing = st.pages.get(name, [])
                keep = min(keep_pages, len(existing))
                pages = list(existing[:keep])
                for p in existing[keep:]:
                    self._unref_page(p)     # replaced by fresh pages below
                for start in range(keep * P, length, P):
                    end = min(start + P, length)
                    page = np.zeros((arr.shape[0], P) + arr.shape[2:],
                                    arr.dtype)
                    page[:, : end - start] = arr[:, start:end]
                    pages.append(page)
                    self._ref_page(page)
                st.pages[name] = pages
            else:
                self._set_whole(st, name, np.array(arr))
        self.enforce_budget()

    # -- incremental append (async KV propagation, §5.3 Sync phase) --------
    def append_tokens(self, seq_id: int, new_slices: Dict[str, np.ndarray],
                      start: int):
        """Propagate freshly decoded KV entries (device -> host).

        Writes are batched page-by-page (one slice assignment per touched
        page) rather than token-by-token, so a whole decode-page block
        lands in at most ``ceil(n_new/P) + 1`` copies per leaf.  A write
        landing on a frozen shared page copy-on-writes it first."""
        st = self.seqs[seq_id]
        P = self.page_size
        n_new = next(iter(new_slices.values())).shape[1]
        for name, arr in new_slices.items():
            if name not in PAGED_LEAVES:
                self._set_whole(st, name, np.array(arr))
                continue
            pages = st.pages.setdefault(name, [])
            i = 0
            while i < n_new:
                pidx, off = divmod(start + i, P)
                while len(pages) <= pidx:
                    page = np.zeros((arr.shape[0], P) + arr.shape[2:],
                                    arr.dtype)
                    pages.append(page)
                    self._ref_page(page)
                if not pages[pidx].flags.writeable:
                    copy = pages[pidx].copy()   # first divergent write
                    self._ref_page(copy)
                    self._unref_page(pages[pidx])
                    pages[pidx] = copy
                    self.cow_copies += 1
                take = min(P - off, n_new - i)
                pages[pidx][:, off: off + take] = arr[:, i: i + take]
                i += take
        st.length = max(st.length, start + n_new)
        self.enforce_budget()

    # -- restore (COMBINE) --------------------------------------------------
    def restore(self, seq_id: int, max_len: int) -> Dict[str, np.ndarray]:
        """Materialize dense (L, max_len, ...) arrays from pages."""
        st = self.seqs[seq_id]
        P = self.page_size
        out = {}
        for name, pages in st.pages.items():
            if not pages:
                continue
            proto = pages[0]
            full = np.zeros((proto.shape[0], max_len) + proto.shape[2:],
                            proto.dtype)
            for pidx, page in enumerate(pages):
                start = pidx * P
                end = min(start + P, max_len)
                if start >= max_len:
                    break
                full[:, start:end] = page[:, : end - start]
            out[name] = full
        out.update({k: v.copy() for k, v in st.whole.items()})
        return out

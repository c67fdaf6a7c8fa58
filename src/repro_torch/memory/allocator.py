"""Device KV page allocator: two-page lazy allocation + eviction policy.

Paper §5.2/§5.3: each active sequence reserves only TWO pages ahead;
extension happens at page boundaries; when the pool is exhausted the
scheduler evicts the sequences with the most progress (their KV is already
checkpointed to host and they are closest to completion), until every
remaining active sequence can hold two pages.

The allocator also carries the **memory-pressure watermark pair** the
governor polls every REFILL round: ``above_high()`` means occupancy
crossed ``high_watermark`` and the scheduler should preempt
least-progress sequences to host; ``below_low()`` means occupancy fell
under ``low_watermark`` and preempted sequences may re-admit.  The gap
between the two is hysteresis — without it a run oscillates
preempt/re-admit every round at the boundary.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set


@dataclasses.dataclass
class AllocStats:
    allocs: int = 0
    frees: int = 0
    evictions: int = 0
    peak_used: int = 0


class PageAllocator:
    def __init__(self, total_pages: int, page_size: int, *,
                 high_watermark: float = 0.85, low_watermark: float = 0.60,
                 governed: bool = True):
        assert total_pages > 0
        assert 0.0 < low_watermark <= high_watermark <= 1.0
        self.total = total_pages
        self.page_size = page_size
        self.high_watermark = high_watermark
        self.low_watermark = low_watermark
        # governed=False marks a pool whose size is a modelling artifact
        # rather than a configured byte budget (e.g. the sim's default
        # max_active*4 soft pool): the scheduler's memory-pressure
        # governor must not steer admission or preempt against it
        self.governed = governed
        self.free: List[int] = list(range(total_pages))
        self.owned: Dict[int, List[int]] = {}       # seq_id -> page ids
        self.stats = AllocStats()

    # -- queries -------------------------------------------------------------
    @property
    def used(self) -> int:
        return self.total - len(self.free)

    @property
    def occupancy(self) -> float:
        return self.used / self.total

    def above_high(self) -> bool:
        return self.occupancy > self.high_watermark

    def below_low(self) -> bool:
        return self.occupancy < self.low_watermark

    def pages_of(self, seq_id: int) -> List[int]:
        return self.owned.get(seq_id, [])

    def can_admit(self, reserve: int = 2) -> bool:
        return len(self.free) >= reserve

    # -- alloc/free ----------------------------------------------------------
    def alloc(self, seq_id: int, n: int = 1) -> Optional[List[int]]:
        if len(self.free) < n:
            return None
        got = [self.free.pop() for _ in range(n)]
        self.owned.setdefault(seq_id, []).extend(got)
        self.stats.allocs += n
        self.stats.peak_used = max(self.stats.peak_used, self.used)
        return got

    def free_seq(self, seq_id: int) -> int:
        pages = self.owned.pop(seq_id, [])
        self.free.extend(pages)
        self.stats.frees += len(pages)
        return len(pages)

    # -- policy ---------------------------------------------------------------
    def ensure_two_pages(self, active: Dict[int, int]) -> List[int]:
        """Evict most-progress-first until every active seq can reserve 2
        pages.  `active`: seq_id -> decoded length.  Returns evicted ids."""
        evicted: List[int] = []
        need = lambda: 2 * (len(active) - len(evicted)) - sum(
            len(self.owned.get(s, [])) for s in active if s not in evicted)
        # tie-break equal progress by seq_id: victim order must not depend
        # on dict insertion order or chaos replays diverge from fault-free
        order = sorted(active, key=lambda s: (-active[s], s))
        i = 0
        while len(self.free) < max(need(), 0) and i < len(order):
            victim = order[i]
            i += 1
            self.free_seq(victim)
            evicted.append(victim)
            self.stats.evictions += 1
        return evicted

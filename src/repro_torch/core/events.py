"""Event queue + typed result records for the event-driven runtime (§3/§5).

Two event families live here:

* **Scheduler events** (``EventKind`` / ``Event`` / ``EventQueue``) — the
  *inputs* the ``CoroutineScheduler`` dispatches through its policy table.
  The queue is priority-ordered so that correctness events (SYNC) precede
  utilization events (REFILL) which precede opportunistic ones (MIGRATE);
  GPUs always have work as long as any queue is non-empty.
* **Runtime records** (``TokenBlockEvent`` / ``SeqFinishedEvent`` /
  ``PrimitiveEvent``) — the *outputs* yielded by
  ``CoroutineScheduler.stream()`` as pages complete, the stream-first
  result surface ``run()`` and ``BatchMaster`` are built on.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
from typing import Any, List, Optional, Tuple


class EventKind(enum.IntEnum):          # ordering = processing priority
    SYNC = 0              # issue async KV appends (page boundary, §5.3 i)
    SYNC_DRAIN = 1        # land in-flight KV blobs in the host store —
    #                       priority-ordered BEFORE every consumer of
    #                       host-store state (evict / migrate / failure),
    #                       so a staged-but-undrained blob can never be
    #                       outrun by a drop or a cross-node move
    SEQ_DONE = 2          # eviction of completed sequences (§5.3 ii)
    SEQ_PREEMPT = 3       # memory-pressure governor: device pages crossed
    #                       the allocator's high watermark — checkpoint the
    #                       least-progress sequences to the host store and
    #                       free their device pages.  Ranks BEFORE
    #                       PAGE_BOUNDARY so preemption lands before the
    #                       boundary handler tries to extend every active
    #                       sequence by a page (the extension would fail on
    #                       an exhausted pool that preemption can relieve)
    PAGE_BOUNDARY = 4     # extension / yield decisions (§5.3 iii)
    MODULE_READY = 5      # intra-forward successor enqueued by YIELD
    REFILL = 6            # ON_REFILL_NODE (§5.1 Alg. 2)
    LONG_TAIL = 7         # ON_LONG_TAIL -> PARTITION
    NODE_SLOW = 8         # straggler mitigation: a live node's EWMA
    #                       throughput fell below the fleet median for K
    #                       consecutive rounds (ProgressTracker) — shed a
    #                       fraction of its work to fast survivors.  The
    #                       node is alive (its heartbeats still arrive),
    #                       so this is distinct from NODE_FAILURE and
    #                       ranks just above MIGRATE: shedding is load
    #                       balancing with evidence, not recovery
    MIGRATE = 9           # opportunistic load balancing
    NODE_FAILURE = 10     # health monitor (§5.6)
    NODE_DRAIN = 11       # elastic scale-down: graceful drain-and-handoff —
    #                       checkpoint + MIGRATE every live sequence to a
    #                       survivor (zero recompute), then retire the node.
    #                       Lowest priority: a drain never outruns recovery.


@dataclasses.dataclass(order=True)
class Event:
    sort_key: tuple = dataclasses.field(init=False, repr=False)
    kind: EventKind = EventKind.MODULE_READY
    node: int = 0
    payload: Any = None
    seq: int = dataclasses.field(default_factory=itertools.count().__next__)

    def __post_init__(self):
        self.sort_key = (int(self.kind), self.seq)


class EventQueue:
    def __init__(self):
        self._heap = []
        self._count = itertools.count()

    def push(self, kind: EventKind, node: int = 0, payload: Any = None):
        ev = Event(kind=kind, node=node, payload=payload,
                   seq=next(self._count))
        heapq.heappush(self._heap, ev)

    def pop(self) -> Optional[Event]:
        if not self._heap:
            return None
        return heapq.heappop(self._heap)

    def __len__(self):
        return len(self._heap)

    def __bool__(self):
        return bool(self._heap)


# ---------------------------------------------------------------------------
# runtime records — the stream-first result surface
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RuntimeRecord:
    """Base of the typed records yielded by ``CoroutineScheduler.stream()``.

    ``custom_id`` is filled in by ``BatchMaster`` when the record belongs
    to a batch-API request (the scheduler itself only knows seq_ids)."""
    seq_id: int
    node: int


@dataclasses.dataclass
class TokenBlockEvent(RuntimeRecord):
    """Tokens appended to one sequence by one decode page (or prefill).

    ``offset`` is the index of ``tokens[0]`` within the sequence's full
    generated stream — consumers reassemble exactly ``run()``'s output by
    concatenating blocks in order, and an ``offset`` of 0 re-appearing
    mid-stream signals a failure-recovery recompute (the earlier tokens
    were re-generated and supersede what was streamed before)."""
    tokens: List[int] = dataclasses.field(default_factory=list)
    offset: int = 0
    logprobs: Optional[List[float]] = None
    top_logprobs: Optional[List[List[Tuple[int, float]]]] = None
    custom_id: Optional[str] = None


@dataclasses.dataclass
class SeqFinishedEvent(RuntimeRecord):
    """A sequence completed and released its device + host pages."""
    finish_reason: str = "length"       # "stop" | "length" | "deadline"
    n_generated: int = 0
    sct_s: Optional[float] = None       # sequence completion time (§2.1)
    custom_id: Optional[str] = None


@dataclasses.dataclass
class PrimitiveEvent(RuntimeRecord):
    """A coroutine primitive fired (yield/combine/partition/migrate — plus
    'recompute' for the failure-recovery path that replays from the
    prompt)."""
    primitive: str = ""
    detail: Any = None
    custom_id: Optional[str] = None


@dataclasses.dataclass
class HealthEvent(RuntimeRecord):
    """The health subsystem acted on a node: the monitor declared it dead
    (``reason='heartbeat'``), a transfer dead-lettered out of its retry
    budget (``reason='dead_letter'``), an external caller demanded a
    failover (``reason='external'``), or the progress tracker flagged a
    live straggler (``reason='slow'`` — NODE_SLOW, not NODE_FAILURE).
    ``seq_id`` is -1 — this record is about a node, not a sequence."""
    reason: str = "heartbeat"
    detail: Any = None
    custom_id: Optional[str] = None

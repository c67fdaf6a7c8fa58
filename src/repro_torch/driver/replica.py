"""One elastic data-parallel replica: a ``BatchMaster`` over its own
node group, driven through the incremental batch surface.

Replica virtual time: every SimEngine keeps its own vclock, and clocks
of different replicas are never comparable (a replica spawned mid-job
starts near zero).  The handle therefore tracks a *join offset* — the
driver-timeline instant the replica joined — and reports
``now() = join_offset + (engine clock - clock at join)``.  The driver's
makespan is the max over replicas, which is exactly the wall-clock a
real deployment would see.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.events import RuntimeRecord
from repro_torch.runtime.api import BatchMaster, BatchRequest


@dataclasses.dataclass
class ReplicaHandle:
    rid: int
    master: BatchMaster
    bid: str
    join_offset: float = 0.0
    clock0: float = 0.0
    draining: bool = False      # admissions stopped; in-flight may finish
    closed: bool = False
    final_now: float = 0.0
    admitted: int = 0
    completed: int = 0

    @classmethod
    def spawn(cls, rid: int, engines: Sequence, *, sched_cfg=None,
              oversubscribe: float = 4.0, policy=None, fault_plan=None,
              join_offset: float = 0.0) -> "ReplicaHandle":
        master = BatchMaster(engines, sched_cfg,
                             oversubscribe=oversubscribe,
                             policy=policy, fault_plan=fault_plan)
        bid = master.open()
        clock0 = max((e.clock() for e in engines), default=0.0)
        return cls(rid=rid, master=master, bid=bid,
                   join_offset=join_offset, clock0=clock0)

    # ------------------------------------------------------------- dispatch
    def headroom(self) -> int:
        if self.closed or self.draining:
            return 0
        return max(self.master.capacity(self.bid) - self.in_flight(), 0)

    def in_flight(self) -> int:
        return 0 if self.closed else self.master.in_flight(self.bid)

    def admit(self, requests: Sequence[BatchRequest]) -> List[int]:
        ids = self.master.append(self.bid, requests)
        self.admitted += len(ids)
        return ids

    def pump(self) -> List[RuntimeRecord]:
        return self.master.pump(self.bid)

    def pop_row(self, seq_id: int) -> Optional[Dict[str, Any]]:
        row = self.master.pop_row(self.bid, seq_id)
        if row is not None:
            self.completed += 1
        return row

    # ---------------------------------------------------------------- state
    def now(self) -> float:
        if self.closed:
            return self.final_now
        clk = max((e.clock()
                   for e in self.master.live_engines(self.bid)),
                  default=self.clock0)
        return self.join_offset + (clk - self.clock0)

    def host_over_budget(self) -> bool:
        """True while any live engine's host store remains over its byte
        budget even after its prefix-LRU eviction cascade — the driver's
        signal to throttle this replica's admissions (instead of letting
        host spill grow unbounded) until decode drains the store."""
        if self.closed:
            return False
        for e in self.master.live_engines(self.bid):
            store = getattr(e, "host_store", None)
            over = getattr(store, "over_budget", None)
            if callable(over) and over():
                return True
        return False

    def healthy(self) -> bool:
        """False once the replica's scheduler has dead-lettered a node or
        lost every engine — the driver's auto-drain trigger."""
        if self.closed:
            return False
        sched = self.master.scheduler(self.bid)
        return bool(sched.engines) and sched.dead_letter_failovers == 0

    def report(self) -> Dict[str, Any]:
        return self.master.report(self.bid)

    # ------------------------------------------------------------ lifecycle
    def cancel(self) -> List[BatchRequest]:
        """Tear down now; returns every request without a captured row."""
        self.final_now = self.now()
        left = self.master.cancel(self.bid)
        self.closed = True
        return left

    def close(self) -> None:
        """Finalize a fully-consumed replica (graceful drain completion)."""
        self.final_now = self.now()
        self.master.close(self.bid)
        self.closed = True
